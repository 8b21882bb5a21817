"""Tile-based 3D Gaussian splatting, forward only, for PyTorch on CUDA.

Port of ``animatablegaussians_tpu/ops/rasterize``:

  1. ``preprocess`` - projection, EWA cov2D, conic, radius (PyTorch ops).
  2. ``binning``    - exact per-frame pair count, pair expansion (CUDA
                      kernel ``csrc/expand.cu``), stable (tile, depth) sort,
                      per-tile ranges.
  3. ``blend``      - per-tile front-to-back compositing (CUDA kernel
                      ``csrc/blend.cu``).
"""

from .api import render
from .binning import bin_gaussians
from .preprocess import preprocess
