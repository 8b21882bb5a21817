"""Visualization cameras and colour maps, a numpy copy of
``animatablegaussians_tpu/utils/visualize.py`` (ref:
utils/visualize_util.py:48-199): the free, front, back and moving
extrinsics of the test-time view settings (ref: main_avatar.py:593-672),
the canonical orthographic cameras of the pose-map baker, and the HSV heat
map. Host-side numpy."""

from __future__ import annotations

import math

import numpy as np


def _rodrigues(rvec: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3, dtype=np.float32)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]],
                 np.float32)
    return (np.eye(3) + math.sin(theta) * K
            + (1 - math.cos(theta)) * (K @ K)).astype(np.float32)


def _t(mat3=None, t3=None) -> np.ndarray:
    m = np.identity(4, np.float32)
    if mat3 is not None:
        m[:3, :3] = mat3
    if t3 is not None:
        m[:3, 3] = t3
    return m


def calc_front_mv(object_center, tar_pos=np.array([0, 0, 2.0])):
    """(ref: visualize_util.py:88-107)."""
    return (_t(t3=tar_pos)
            @ _t(_rodrigues(np.array([math.pi, 0, 0])))
            @ _t(t3=-np.asarray(object_center)))


def calc_back_mv(object_center, tar_pos=np.array([0, 0, 2.0])):
    """(ref: visualize_util.py:109-131)."""
    return (_t(t3=tar_pos)
            @ _t(_rodrigues(np.array([0.0, math.pi, 0])))
            @ _t(_rodrigues(np.array([math.pi, 0, 0])))
            @ _t(t3=-np.asarray(object_center)))


def calc_free_mv(object_center, tar_pos=np.array([0, 0, 2.0]),
                 rot_Y: float = 0.0, rot_X: float = 0.0,
                 global_orient=None):
    """Orbit camera for the 'free' view setting
    (ref: visualize_util.py:133-164; consumed at main_avatar.py:593-613)."""
    inv_go = _rodrigues(np.array([math.pi, 0.0, 0.0]))
    if global_orient is not None:
        inv_go = inv_go @ np.linalg.inv(global_orient)
    return (_t(t3=tar_pos)
            @ _t(_rodrigues(np.array([rot_X, 0, 0])))
            @ _t(_rodrigues(np.array([0, rot_Y, 0])))
            @ _t(inv_go)
            @ _t(t3=-np.asarray(object_center)))


def calc_cano_front_mv(mesh_center):
    """Orthographic-ish canonical front camera (z=-10, flipped y/z;
    ref: visualize_util.py:165-172)."""
    m = np.identity(4, np.float32)
    m[:3, 3] = -np.asarray(mesh_center) + np.array([0, 0, -10], np.float32)
    m[1:3] *= -1
    return m


def calc_cano_back_mv(mesh_center):
    """(ref: visualize_util.py:174-183)."""
    m = np.identity(4, np.float32)
    rot_y = _rodrigues(np.array([0, np.pi, 0], np.float32))
    m[:3, :3] = rot_y
    m[:3, 3] = -rot_y @ np.asarray(mesh_center) + np.array([0, 0, -10],
                                                           np.float32)
    m[1:3] *= -1
    return m


def to_hsv(c: np.ndarray) -> np.ndarray:
    """Scalar in [0,1] -> HSV-style heat colors (N, 3) uint8
    (ref: visualize_util.py:48-85)."""
    c = np.asarray(c).reshape(-1)
    h = (1 - c) * 240.0 / 60.0
    hi = h.astype(np.int64)
    x = 1 - np.abs(hi % 2 + h - hi - 1.0)
    rgb = np.zeros((c.shape[0], 3), np.int64)
    m1 = (h >= 0) & (h < 1)
    rgb[m1, 0] = 255
    rgb[m1, 1] = (x[m1] * 255).astype(np.int64)
    m2 = (h >= 1) & (h < 2)
    rgb[m2, 0] = (x[m2] * 255).astype(np.int64)
    rgb[m2, 1] = 255
    m3 = (h >= 2) & (h < 3)
    rgb[m3, 1] = 255
    rgb[m3, 2] = (x[m3] * 255).astype(np.int64)
    m4 = h >= 3
    rgb[m4, 1] = (x[m4] * 255).astype(np.int64)
    rgb[m4, 2] = 255
    return np.clip(rgb, 0, 255).astype(np.uint8)
