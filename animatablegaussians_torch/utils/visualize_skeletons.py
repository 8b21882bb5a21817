"""Skeleton ball+cylinder meshes from joints, a numpy copy of
``animatablegaussians_tpu/utils/visualize_skeletons.py`` (ref:
utils/visualize_skeletons.py:18-58). The reference loads ball/cylinder OBJ
assets; here both primitives are generated procedurally (icosphere +
unit-height cylinder) so no asset files are needed."""

from __future__ import annotations

import numpy as np


def _icosphere(subdiv: int = 1):
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdiv):
        mids = {}
        verts = list(v)
        new_f = []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = verts[a] + verts[b]
                m = m / np.linalg.norm(m)
                mids[key] = len(verts)
                verts.append(m.astype(np.float32))
            return mids[key]

        for (a, b, c) in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_f += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        v = np.asarray(verts, np.float32)
        f = np.asarray(new_f, np.int64)
    return v, f


def _cylinder(n_seg: int = 16):
    """Unit-height (y in [-0.5, 0.5]) radius-1 open cylinder."""
    ang = 2 * np.pi * np.arange(n_seg) / n_seg
    ring = np.stack([np.cos(ang), np.zeros(n_seg), np.sin(ang)], 1)
    top = ring + [0, 0.5, 0]
    bot = ring + [0, -0.5, 0]
    v = np.concatenate([top, bot]).astype(np.float32)
    f = []
    for i in range(n_seg):
        j = (i + 1) % n_seg
        f += [(i, n_seg + i, j), (j, n_seg + i, n_seg + j)]
    return v, np.asarray(f, np.int64)


_BALL_V, _BALL_F = _icosphere(1)
_CYL_V, _CYL_F = _cylinder()


def construct_skeletons(joints: np.ndarray, parent_ids: np.ndarray):
    """joints (J, 3), parents (J,) -> (verts, faces) skeleton mesh
    (ref: utils/visualize_skeletons.py:18-58; ball r=0.04, bone d=0.02)."""
    vertices, faces = [], []
    n = 0
    for j in range(joints.shape[0]):
        vertices.append(0.04 * _BALL_V + joints[j])
        faces.append(_BALL_F + n)
        n += _BALL_V.shape[0]

        p = int(parent_ids[j])
        if p < 0 or p == j:
            continue
        d = joints[p] - joints[j]
        bone_len = float(np.linalg.norm(d))
        if bone_len < 1e-8:
            continue
        d1 = d / bone_len
        cv_ = _CYL_V.copy()
        cv_[:, 1] *= bone_len
        cv_[:, [0, 2]] *= 0.02
        # rotate +y onto the bone direction
        d0 = np.array([0, 1, 0], np.float32)
        axis = np.cross(d0, d1)
        s = np.linalg.norm(axis)
        c = float(np.dot(d0, d1))
        if s < 1e-8:
            R = np.eye(3, dtype=np.float32) * (1.0 if c > 0 else -1.0)
            if c < 0:
                R[0, 0] = 1.0  # 180deg about x
                R[1, 1] = R[2, 2] = -1.0
        else:
            k = axis / s
            K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                          [-k[1], k[0], 0]], np.float32)
            R = np.eye(3) + s * K + (1 - c) * (K @ K)
        center = joints[j] + 0.5 * d
        cv_ = cv_ @ R.T + center
        vertices.append(cv_.astype(np.float32))
        faces.append(_CYL_F + n)
        n += _CYL_V.shape[0]
    return np.concatenate(vertices), np.concatenate(faces)
