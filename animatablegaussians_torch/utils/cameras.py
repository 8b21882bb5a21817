"""Camera math: FoV conversion, OpenGL-style projection with an off-centre
principal point, world->view transforms.

Port of ``animatablegaussians_tpu/utils/cameras.py`` (ref:
utils/graphics_utils.py:51-85, gaussians/gaussian_renderer.py:44-67): the
camera looks down +z in view space, extr is world->view (row-major,
x_view = extr @ [x_world, 1]), znear = 0.1 and zfar = 100 by default.
``focal_to_fov``, ``fov_to_focal``, ``projection_matrix`` and
``world_to_view`` are numpy; ``full_projection`` and ``camera_center`` take
and return torch tensors on the caller's device.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def focal_to_fov(focal: float, pixels: int) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def fov_to_focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def projection_matrix(znear: float, zfar: float, K: np.ndarray,
                      img_w: int, img_h: int) -> np.ndarray:
    """View space -> clip space; after the perspective divide x, y are in
    [-1, 1] NDC with the principal-point offset folded in, z maps to
    [0, 1]-ish with w = z_view (ref: utils/graphics_utils.py:51-79)."""
    near_fx = znear / K[0, 0]
    near_fy = znear / K[1, 1]
    left = -(img_w - K[0, 2]) * near_fx
    right = K[0, 2] * near_fx
    bottom = (K[1, 2] - img_h) * near_fy
    top = K[1, 2] * near_fy

    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def full_projection(extr, intr, img_w: int, img_h: int, znear: float = 0.1,
                    zfar: float = 100.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(view 4x4, full projection 4x4 = P @ extr), float32 on ``extr``'s
    device (the CPU for a numpy ``extr``); row-major, applied to column
    vectors."""
    K = np.asarray(intr.cpu() if torch.is_tensor(intr) else intr,
                   dtype=np.float32)
    P = projection_matrix(znear, zfar, K, img_w, img_h)
    extr = torch.as_tensor(extr, dtype=torch.float32)
    return extr, torch.as_tensor(P, device=extr.device) @ extr


def camera_center(extr: torch.Tensor) -> torch.Tensor:
    """World-space camera position from a world->view matrix."""
    return -extr[:3, :3].T @ extr[:3, 3]


def world_to_view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(R, t) with the world->cam rotation stored transposed, as in colmap
    -> 4x4 world->view (ref: utils/graphics_utils.py:31-36)."""
    Rt = np.zeros((4, 4), dtype=np.float32)
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    return Rt
