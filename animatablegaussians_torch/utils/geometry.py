"""Geometry helpers.

Port of ``animatablegaussians_tpu/utils/geometry.py::normalize_vert_bbox``
(ref: utils/geo_util.py), which the mean-hand blend uses.
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
