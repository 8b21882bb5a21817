"""Quaternion utilities (w, x, y, z convention), batched over leading axes.

Port of ``animatablegaussians_tpu/ops/quat.py`` (the quaternion helpers,
``quat_mul``, ``rotate_vec``, ``axis_angle_to_mat`` and
``axis_angle_to_quat``): the same formulas in the same order, so the two
agree to float32 rounding.
"""

from __future__ import annotations

import torch


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Zero-safe L2 normalize: a zero quaternion maps to 0, not NaN."""
    sq = torch.sum(q * q, dim=-1, keepdim=True)
    pos = sq > eps * eps
    norm = torch.sqrt(torch.where(pos, sq, torch.ones_like(sq)))
    return torch.where(pos, q / norm, torch.zeros_like(q))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) wxyz -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = 2.0 / torch.sum(q * q, dim=-1)
    m = torch.stack([
        1 - two_s * (y * y + z * z), two_s * (x * y - z * w),
        two_s * (x * z + y * w),
        two_s * (x * y + z * w), 1 - two_s * (x * x + z * z),
        two_s * (y * z - x * w),
        two_s * (x * z - y * w), two_s * (y * z + x * w),
        1 - two_s * (x * x + y * y),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) wxyz.

    Branch-free Shepperd method: all four candidate quaternions are formed
    and the one keyed by the largest diagonal combination is selected; the
    sign is fixed to w >= 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    qw2 = torch.clamp(1.0 + m00 + m11 + m22, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)

    cw = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cx = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1)
    cy = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1)
    cz = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1)
    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    cands = torch.stack([cw, cx, cy, cz], dim=-2)        # (..., 4, 4)
    cands = cands / (2.0 * torch.sqrt(torch.clamp(mags, min=1e-12)))[..., None]

    best = torch.argmax(mags, dim=-1)                     # (...,)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 4))).squeeze(-2)
    q = torch.where(q[..., 0:1] < 0, -q, q)
    return normalize(q)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions (..., 4)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def axis_angle_to_mat(aa: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues)."""
    angle = torch.linalg.norm(aa, dim=-1, keepdim=True)
    axis = aa / torch.clamp(angle, min=eps)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    s = torch.sin(angle[..., 0])
    c = torch.cos(angle[..., 0])
    C = 1.0 - c
    m = torch.stack([
        x * x * C + c, x * y * C - z * s, x * z * C + y * s,
        y * x * C + z * s, y * y * C + c, y * z * C - x * s,
        z * x * C - y * s, z * y * C + x * s, z * z * C + c,
    ], dim=-1)
    return m.reshape(aa.shape[:-1] + (3, 3))


def rotate_vec(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2.0 * (q[..., 0:1] * uv + uuv)


def axis_angle_to_quat(aa: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle (..., 3) -> unit quaternion (..., 4) wxyz; below ``eps``
    the small-angle series of sin(x/2)/x, so a zero rotation gives the
    identity."""
    angle = torch.linalg.norm(aa, dim=-1, keepdim=True)
    half = 0.5 * angle
    k = torch.where(angle < eps, 0.5 - angle * angle / 48.0,
                    torch.sin(half) / torch.clamp(angle, min=eps))
    return torch.cat([torch.cos(half), aa * k], dim=-1)
