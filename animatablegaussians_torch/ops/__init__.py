"""Compute ops: quaternions, KNN, FIR resampling, splatting."""
