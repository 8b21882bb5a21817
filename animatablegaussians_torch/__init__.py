"""animatablegaussians_torch — the PyTorch / CUDA port of
``animatablegaussians_tpu`` for NVIDIA Hopper (H100).

Subpackages and module names mirror the JAX package, so each module's
counterpart is found under the same path there. The JAX package is the
reference: every module here is held against it by ``tests/test_torch_*.py``.
This package imports ``torch`` and never ``jax``.

Hand-written Hopper kernels live in ``csrc/`` and are built with ``nvcc`` at
first use into the repository's git-ignored ``build/`` directory
(``utils/cuda_build.py``); each kernel's wrapper keeps a plain PyTorch
version beside it, which it runs for tensors on the CPU.
"""

__version__ = "0.1.0"
