"""Utilities: synthetic fixtures, weight conversion, kernel build."""
