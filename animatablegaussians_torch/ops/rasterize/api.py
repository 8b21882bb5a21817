"""Public rasterization API, differentiable.

Port of ``animatablegaussians_tpu/ops/rasterize/api.py:66-78,206-344,370-391``
with the same output contract: colour, depth, alpha mask, radii, visibility,
screen-space means and the pair count.

Composition: preprocess -> packed per-Gaussian rows -> binning (pair
expansion kernel + sort) -> tile blend kernel -> background blend. The
gradient flows back through the blend's backward kernel
(``blend.BlendTiles``), the row packing and preprocess to ``means3d``,
``scales``, ``rotations``, ``opacities`` and ``colors``; binning is integer
bookkeeping and runs without autograd, as the JAX package's binning gets no
gradient.
"""

from __future__ import annotations

import torch

from .binning import bin_gaussians
from .blend import TILE, BlendTiles
from .preprocess import preprocess


def _pack_rows(pre, opacities, colors) -> torch.Tensor:
    """(N, ...) fields -> (N, 10) rows [x y ca cb cc op r g b depth];
    invalid Gaussians get opacity 0."""
    n = opacities.shape[0]
    op = torch.where(pre.valid, opacities.reshape(n),
                     torch.zeros((), dtype=opacities.dtype,
                                 device=opacities.device))
    return torch.stack([
        pre.means2d[:, 0], pre.means2d[:, 1],
        pre.conics[:, 0], pre.conics[:, 1], pre.conics[:, 2],
        op, colors[:, 0], colors[:, 1], colors[:, 2], pre.depths,
    ], dim=1).contiguous()


def _full_projection(extr, intr, img_w: int, img_h: int,
                     znear: float = 0.1, zfar: float = 100.0):
    """(viewmatrix, projmatrix = P @ view) from extrinsics and intrinsics
    (ref math: utils/graphics_utils.py:51-79)."""
    K = intr
    near_fx = znear / K[0, 0]
    near_fy = znear / K[1, 1]
    left = -(img_w - K[0, 2]) * near_fx
    right = K[0, 2] * near_fx
    bottom = (K[1, 2] - img_h) * near_fy
    top = K[1, 2] * near_fy
    P = torch.zeros((4, 4), dtype=torch.float32, device=extr.device)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    extr = extr.to(torch.float32)
    return extr, P @ extr


def render(means3d, scales, rotations, opacities, colors, bg_color, extr,
           intr, img_w: int, img_h: int, scale_modifier: float = 1.0,
           valid_mask=None, plain: bool = False) -> dict:
    """means3d (N, 3) world space; scales (N, 3) activated; rotations
    (N, 4) unit wxyz; opacities (N,) or (N, 1); colors (N, 3); bg_color
    (3,); extr (4, 4) world->view; intr (3, 3). ``valid_mask`` (N,) bool
    marks points that are never binned (block-packing pads).

    ``plain=True`` runs the kernels' plain PyTorch versions, forward and
    backward, on whatever device the tensors are on: the reference the
    kernels are checked against on the GPU. On the CPU both settings run
    the plain versions."""
    tan_fovx = img_w / (2.0 * intr[0, 0])
    tan_fovy = img_h / (2.0 * intr[1, 1])
    viewmatrix, projmatrix = _full_projection(extr, intr, img_w, img_h)

    pre = preprocess(means3d, scales, rotations, viewmatrix, projmatrix,
                     tan_fovx, tan_fovy, img_w, img_h, scale_modifier)
    if valid_mask is not None:
        pre = pre._replace(valid=pre.valid & valid_mask,
                           radii=torch.where(valid_mask, pre.radii,
                                             torch.zeros_like(pre.radii)))
    rows = _pack_rows(pre, opacities, colors)

    grid_x = -(-img_w // TILE)
    grid_y = -(-img_h // TILE)
    with torch.no_grad():
        bins = bin_gaussians(pre.means2d, pre.depths, pre.radii, pre.valid,
                             img_w, img_h, TILE, plain=plain)
    color, depth, t_final = BlendTiles.apply(rows, bins.gid, bins.starts,
                                             grid_x, grid_y, img_w, img_h,
                                             plain)
    color = color + t_final[..., None] * bg_color.reshape(1, 1, 3)
    return dict(render=color, depth=depth, mask=1.0 - t_final,
                radii=pre.radii, visibility_filter=pre.radii > 0,
                means2d=pre.means2d, n_pairs=bins.n_pairs)
