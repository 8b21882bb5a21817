"""Per-Gaussian projection and covariance preprocessing.

Port of ``animatablegaussians_tpu/ops/rasterize/preprocess.py:73-160``:
EWA splatting Jacobian with FoV clamping, +0.3 px low-pass on the 2D
covariance diagonal, conic = inverse 2D covariance, radius = ceil(3 sigma)
from the larger eigenvalue, near-plane cull at z <= 0.2. The component
arithmetic keeps the JAX package's order of operations, so radii agree
exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Preprocessed(NamedTuple):
    means2d: torch.Tensor   # (N, 2) pixel coords
    depths: torch.Tensor    # (N,) view-space z
    conics: torch.Tensor    # (N, 3) upper-tri inverse 2D cov (a, b, c)
    radii: torch.Tensor     # (N,) int32 screen radius, 0 = culled
    valid: torch.Tensor     # (N,) bool


def _covariance3d_components(scales, rotations, scale_modifier):
    """The six unique entries of R diag(s^2) R^T as (N,) tensors."""
    w, x, y, z = (rotations[:, 0], rotations[:, 1], rotations[:, 2],
                  rotations[:, 3])
    two_s = 2.0 / torch.sum(rotations * rotations, dim=-1)
    r00 = 1 - two_s * (y * y + z * z)
    r01 = two_s * (x * y - z * w)
    r02 = two_s * (x * z + y * w)
    r10 = two_s * (x * y + z * w)
    r11 = 1 - two_s * (x * x + z * z)
    r12 = two_s * (y * z - x * w)
    r20 = two_s * (x * z - y * w)
    r21 = two_s * (y * z + x * w)
    r22 = 1 - two_s * (x * x + y * y)
    s0 = (scales[:, 0] * scale_modifier) ** 2
    s1 = (scales[:, 1] * scale_modifier) ** 2
    s2 = (scales[:, 2] * scale_modifier) ** 2
    s00 = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    s01 = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    s02 = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    s11 = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    s12 = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    s22 = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return s00, s01, s02, s11, s12, s22


def preprocess(means3d, scales, rotations, viewmatrix, projmatrix,
               tan_fovx, tan_fovy, img_w: int, img_h: int,
               scale_modifier: float = 1.0) -> Preprocessed:
    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    V = viewmatrix
    t0 = mx * V[0, 0] + my * V[0, 1] + mz * V[0, 2] + V[0, 3]
    t1 = mx * V[1, 0] + my * V[1, 1] + mz * V[1, 2] + V[1, 3]
    tz = mx * V[2, 0] + my * V[2, 1] + mz * V[2, 2] + V[2, 3]
    in_front = tz > 0.2

    P = projmatrix
    c0 = mx * P[0, 0] + my * P[0, 1] + mz * P[0, 2] + P[0, 3]
    c1 = mx * P[1, 0] + my * P[1, 1] + mz * P[1, 2] + P[1, 3]
    c3 = mx * P[3, 0] + my * P[3, 1] + mz * P[3, 2] + P[3, 3]
    p_w = 1.0 / (c3 + 1e-7)
    means2d = torch.stack([
        ((c0 * p_w + 1.0) * img_w - 1.0) * 0.5,
        ((c1 * p_w + 1.0) * img_h - 1.0) * 0.5,
    ], dim=1)

    focal_x = img_w / (2.0 * tan_fovx)
    focal_y = img_h / (2.0 * tan_fovy)
    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    tz_safe = torch.where(torch.abs(tz) < 1e-6, torch.full_like(tz, 1e-6), tz)
    txtz = torch.clamp(t0 / tz_safe, -limx, limx)
    tytz = torch.clamp(t1 / tz_safe, -limy, limy)
    tx = txtz * tz_safe
    ty = tytz * tz_safe

    s00, s01, s02, s11, s12, s22 = _covariance3d_components(
        scales, rotations, scale_modifier)

    j00 = focal_x / tz_safe
    j02 = -focal_x * tx / tz_safe ** 2
    j11 = focal_y / tz_safe
    j12 = -focal_y * ty / tz_safe ** 2
    u0 = j00 * V[0, 0] + j02 * V[2, 0]
    u1 = j00 * V[0, 1] + j02 * V[2, 1]
    u2 = j00 * V[0, 2] + j02 * V[2, 2]
    v0 = j11 * V[1, 0] + j12 * V[2, 0]
    v1 = j11 * V[1, 1] + j12 * V[2, 1]
    v2 = j11 * V[1, 2] + j12 * V[2, 2]
    su0 = s00 * u0 + s01 * u1 + s02 * u2
    su1 = s01 * u0 + s11 * u1 + s12 * u2
    su2 = s02 * u0 + s12 * u1 + s22 * u2
    a = u0 * su0 + u1 * su1 + u2 * su2 + 0.3
    b = v0 * su0 + v1 * su1 + v2 * su2
    sv0 = s00 * v0 + s01 * v1 + s02 * v2
    sv1 = s01 * v0 + s11 * v1 + s12 * v2
    sv2 = s02 * v0 + s12 * v1 + s22 * v2
    c = v0 * sv0 + v1 * sv1 + v2 * sv2 + 0.3

    det = a * c - b * b
    det_safe = torch.where(det == 0.0, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    conics = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=1)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=0.0)))

    valid = in_front & (det > 0.0)
    radii = torch.where(valid, radius_f, torch.zeros_like(radius_f)).to(
        torch.int32)
    valid = valid & (radii > 0)
    return Preprocessed(means2d=means2d, depths=tz, conics=conics,
                        radii=radii, valid=valid)
