"""Synthetic avatar fixtures: a fake canonical position map, LBS weights and
per-frame items, for when no real capture data is present.

A numpy-only copy of ``animatablegaussians_tpu/utils/synthetic.py``
(make_cano_map, pose_map_from_cano, make_items, batch_items), kept here so that the port
and its GPU smoke run never import the JAX package;
``tests/test_torch_ops.py`` holds the two copies equal.
"""

from __future__ import annotations

import math

import numpy as np


def make_cano_map(map_h: int = 128, n_joints: int = 55, seed: int = 0,
                  fill: float = 0.35):
    """Returns (cano_pos_map (H, 2H, 3), cano_nml_map (H, 2H, 3),
    lbs (N, J)) for the masked texels of a synthetic ellipsoid body."""
    rng = np.random.default_rng(seed)
    H, W = map_h, 2 * map_h
    v1, u1 = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, map_h),
                         indexing="ij")
    pos = np.zeros((H, W, 3), np.float32)
    nml = np.zeros((H, W, 3), np.float32)
    for side in range(2):  # 0 = front, 1 = back
        sl = slice(side * map_h, (side + 1) * map_h)
        u, v = u1, v1
        r2 = (u / fill) ** 2 + (v / 0.9) ** 2
        inside = r2 < 1.0
        z = np.sqrt(np.clip(1.0 - r2, 0.0, None)) * 0.15
        z = np.where(side == 0, z + 0.05, -z - 0.05)
        p = np.stack([u * 0.4, -v * 0.9, z], axis=-1).astype(np.float32)
        n = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-6)
        pos[:, sl][inside] = p[inside]
        nml[:, sl][inside] = n[inside].astype(np.float32)

    mask = np.linalg.norm(pos, axis=-1) > 0
    n_pts = int(mask.sum())
    ys = pos[mask][:, 1]
    centers = np.linspace(ys.min() - 1e-3, ys.max() + 1e-3, n_joints)
    d = -((ys[:, None] - centers[None, :]) ** 2) / 0.02
    w = np.exp(d) + 1e-4 * rng.random((n_pts, n_joints))
    w = (w / w.sum(1, keepdims=True)).astype(np.float32)
    return pos, nml, w


def pose_map_from_cano(cano_pos_map: np.ndarray) -> np.ndarray:
    """(H, 2H, 3) canonical map -> (H/2, H/2, 6) pose-map input: x0.5
    nearest downsample, front|back stacked channelwise."""
    m = cano_pos_map[::2, ::2]
    half = m.shape[1] // 2
    return np.concatenate([m[:, :half], m[:, half:]], axis=-1)


def make_items(n_joints: int = 55, img_w: int = 128, img_h: int = 128,
               seed: int = 0, angle: float = 0.1, cano_pos_map=None):
    """Per-frame item dict: identity-ish joint mats + a simple camera."""
    rng = np.random.default_rng(seed)
    mats = np.tile(np.eye(4, dtype=np.float32), (n_joints, 1, 1))
    for j in range(n_joints):
        a = angle * rng.standard_normal()
        c, s = math.cos(a), math.sin(a)
        mats[j, :2, :2] = [[c, -s], [s, c]]

    extr = np.eye(4, dtype=np.float32)
    extr[2, 3] = 2.0  # camera looks at origin from z=-2 (points at +z)
    f = 0.9 * max(img_w, img_h)
    intr = np.array([[f, 0, img_w / 2], [0, f, img_h / 2], [0, 0, 1]],
                    np.float32)
    color = rng.random((img_h, img_w, 3)).astype(np.float32)
    mask = np.zeros((img_h, img_w), np.float32)
    mask[img_h // 8: -img_h // 8, img_w // 8: -img_w // 8] = 1.0
    boundary = np.zeros((img_h, img_w), np.float32)

    items = dict(
        cano2live_jnt_mats=mats.astype(np.float32),
        cano2live_jnt_mats_woRoot=mats.astype(np.float32),
        extr=extr, intr=intr,
        color_img=color, mask_img=mask, boundary_mask_img=boundary,
    )
    if cano_pos_map is not None:
        items["smpl_pos_map"] = pose_map_from_cano(cano_pos_map)
    return items


def batch_items(items_list):
    """Stack a list of item dicts along a new leading batch axis."""
    keys = items_list[0].keys()
    return {k: np.stack([it[k] for it in items_list]) for k in keys}
