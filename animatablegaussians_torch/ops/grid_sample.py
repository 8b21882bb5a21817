"""Volume sampling: trilinear and nearest gathers with border clamping, a
port of ``animatablegaussians_tpu/ops/grid_sample.py`` (ref:
network/volume.py:72-130, align_corners=True, padding='border').

Volumes are (X, Y, Z, C); query points lie in [0, 1]^3 with 0 -> voxel 0
and 1 -> voxel R-1. This is the gather itself, not ``F.grid_sample``,
whose volume is (N, C, D, H, W) and whose grid is in zyx order: the two
agree where both are defined (``tests/test_torch_template_ops.py``), and
the gather keeps the JAX package's arithmetic.
"""

from __future__ import annotations

import torch


def _res(vol: torch.Tensor) -> torch.Tensor:
    X, Y, Z = vol.shape[:3]
    return torch.tensor([X - 1, Y - 1, Z - 1], dtype=torch.float32,
                        device=vol.device)


def sample_volume_trilinear(vol: torch.Tensor,
                            pts01: torch.Tensor) -> torch.Tensor:
    """vol (X, Y, Z, C), pts01 (N, 3) in [0, 1] -> (N, C)."""
    X, Y, Z = vol.shape[:3]
    p = torch.clamp(pts01, 0.0, 1.0) * _res(vol)        # voxel coords
    p0 = torch.floor(p)
    frac = p - p0
    p0 = p0.long()
    p1 = p0 + 1

    x0, y0, z0 = (p0[:, 0].clamp(0, X - 1), p0[:, 1].clamp(0, Y - 1),
                  p0[:, 2].clamp(0, Z - 1))
    x1, y1, z1 = (p1[:, 0].clamp(0, X - 1), p1[:, 1].clamp(0, Y - 1),
                  p1[:, 2].clamp(0, Z - 1))
    fx, fy, fz = frac[:, 0:1], frac[:, 1:2], frac[:, 2:3]

    c000, c001 = vol[x0, y0, z0], vol[x0, y0, z1]
    c010, c011 = vol[x0, y1, z0], vol[x0, y1, z1]
    c100, c101 = vol[x1, y0, z0], vol[x1, y0, z1]
    c110, c111 = vol[x1, y1, z0], vol[x1, y1, z1]

    c00 = c000 * (1 - fz) + c001 * fz
    c01 = c010 * (1 - fz) + c011 * fz
    c10 = c100 * (1 - fz) + c101 * fz
    c11 = c110 * (1 - fz) + c111 * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def sample_volume_nearest(vol: torch.Tensor,
                          pts01: torch.Tensor) -> torch.Tensor:
    """vol (X, Y, Z, C), pts01 (N, 3) -> (N, C), the nearest voxel (the
    root finding's gradient lookup; ref: root_finding.cu). ``torch.round``
    rounds half to even, as ``jnp.round``."""
    X, Y, Z = vol.shape[:3]
    p = torch.round(torch.clamp(pts01, 0.0, 1.0) * _res(vol)).long()
    return vol[p[:, 0].clamp(0, X - 1), p[:, 1].clamp(0, Y - 1),
               p[:, 2].clamp(0, Z - 1)]
