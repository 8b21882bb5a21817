"""Geometry helpers: bounding-box normalization (which the mean-hand blend
uses) and barycentric coordinates.

Port of ``animatablegaussians_tpu/utils/geometry.py`` (ref:
utils/geo_util.py:8-114).
"""

from __future__ import annotations

from typing import Optional

import torch


def normalize_vert_bbox(verts: torch.Tensor,
                        attris: Optional[torch.Tensor] = None, dim: int = 0,
                        per_axis: bool = False) -> torch.Tensor:
    """Normalize ``attris`` (or ``verts``) into the [-1, 1] bounding box of
    ``verts`` along ``dim``: per axis, or by the box's longest side."""
    xyz_min = torch.amin(verts, dim=dim, keepdim=True)
    xyz_max = torch.amax(verts, dim=dim, keepdim=True)
    out = verts if attris is None else attris
    out = out - 0.5 * (xyz_min + xyz_max)
    if per_axis:
        scale = 0.5 * (xyz_max - xyz_min)
    else:
        scale = 0.5 * torch.amax(xyz_max - xyz_min, dim=-1, keepdim=True)
    return out / scale


def barycentric_coords(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Barycentric coordinates of points ``p`` with respect to triangles
    (a, b, c), all (..., 3) -> (..., 3) weights (w_a, w_b, w_c); a
    degenerate triangle's denominator (below ``eps`` in magnitude) is
    ``eps``."""
    v0 = b - a
    v1 = c - a
    v2 = p - a
    d00 = torch.sum(v0 * v0, dim=-1)
    d01 = torch.sum(v0 * v1, dim=-1)
    d11 = torch.sum(v1 * v1, dim=-1)
    d20 = torch.sum(v2 * v0, dim=-1)
    d21 = torch.sum(v2 * v1, dim=-1)
    denom = d00 * d11 - d01 * d01
    denom = torch.where(torch.abs(denom) < eps,
                        torch.full_like(denom, eps), denom)
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w
    return torch.stack([u, v, w], dim=-1)


def barycentric_interp(weights: torch.Tensor,
                       attrs: torch.Tensor) -> torch.Tensor:
    """(..., 3) weights x (..., 3, C) per-corner attributes -> (..., C)."""
    return torch.sum(weights[..., None] * attrs, dim=-2)
