"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the repository root. Tests marked ``gpu`` need a CUDA device and skip
without one; they decide inside the test, never at import."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA device; skips without one")
