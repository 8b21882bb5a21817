"""Isosurface extraction: vectorised numpy marching cubes and Sobel
normals, a numpy copy of ``animatablegaussians_tpu/utils/recon.py`` (ref:
utils/recon_util.py:9-75; marching cubes written out, since neither
skimage nor mcubes is a dependency). Host-side: the mesh export is an
offline step.
"""

from __future__ import annotations

import numpy as np

from animatablegaussians_torch.utils.mcubes_tables import (EDGE_TABLE,
                                                        tri_table)

# per-cube corner offsets (x, y, z), standard MC corner numbering
_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int32)
# the 12 edges as (corner_a, corner_b)
_EDGES = np.array([
    [0, 1], [1, 2], [2, 3], [3, 0],
    [4, 5], [5, 6], [6, 7], [7, 4],
    [0, 4], [1, 5], [2, 6], [3, 7]], np.int32)

_TRI_TABLE = tri_table()


def marching_cubes(volume: np.ndarray, level: float = 0.0,
                   spacing=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0)):
    """volume (X, Y, Z) -> (vertices (V, 3), faces (F, 3)).

    Vertices are deduplicated per grid edge (watertight connectivity).
    """
    vol = np.asarray(volume, np.float32)
    X, Y, Z = vol.shape
    # corner values for every cell, shape (X-1, Y-1, Z-1, 8)
    cv = np.stack([
        vol[c[0]:c[0] + X - 1, c[1]:c[1] + Y - 1, c[2]:c[2] + Z - 1]
        for c in _CORNERS], axis=-1)
    inside = cv < level
    cube_idx = np.zeros(inside.shape[:3], np.int32)
    for i in range(8):
        cube_idx |= inside[..., i].astype(np.int32) << i

    occupied = np.argwhere((cube_idx > 0) & (cube_idx < 255))
    if occupied.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    ci = cube_idx[occupied[:, 0], occupied[:, 1], occupied[:, 2]]
    vals = cv[occupied[:, 0], occupied[:, 1], occupied[:, 2]]   # (M, 8)

    # unique global edge ids: edge = (cell base voxel of corner_a, axis)
    base = occupied[:, None, :] + _CORNERS[_EDGES[:, 0]][None]  # (M, 12, 3)
    other = occupied[:, None, :] + _CORNERS[_EDGES[:, 1]][None]
    axis = np.argmax(np.abs(other - base), axis=-1)             # (M, 12)
    # canonical edge anchor = min corner
    anchor = np.minimum(base, other)
    edge_id = ((anchor[..., 0] * Y + anchor[..., 1]) * Z
               + anchor[..., 2]) * 3 + axis                    # (M, 12)

    edge_mask = (EDGE_TABLE[ci][:, None] >> np.arange(12)[None]) & 1
    used = edge_mask.astype(bool)

    # interpolated positions on used edges
    va = vals[:, _EDGES[:, 0]]
    vb = vals[:, _EDGES[:, 1]]
    denom = np.where(np.abs(vb - va) < 1e-12, 1.0, vb - va)
    t = np.clip((level - va) / denom, 0.0, 1.0)
    pa = base.astype(np.float32)
    pb = other.astype(np.float32)
    pts = pa + t[..., None] * (pb - pa)                         # (M, 12, 3)

    flat_ids = edge_id[used]
    flat_pts = pts[used]
    uniq, inverse = np.unique(flat_ids, return_inverse=True)
    vertices = np.zeros((uniq.shape[0], 3), np.float32)
    vertices[inverse] = flat_pts

    # local (cell, edge) -> global vertex index
    vert_index = np.full(edge_id.shape, -1, np.int64)
    vert_index[used] = inverse

    tri = _TRI_TABLE[ci]                                       # (M, 16)
    n_tri = (tri >= 0).sum(1) // 3
    faces = []
    for k in range(5):
        sel = n_tri > k
        if not sel.any():
            break
        e = tri[sel][:, 3 * k: 3 * k + 3]                      # (m, 3)
        f = np.take_along_axis(vert_index[sel], e, axis=1)
        faces.append(f)
    faces = (np.concatenate(faces, 0).astype(np.int32)
             if faces else np.zeros((0, 3), np.int32))

    sp = np.asarray(spacing, np.float32)
    og = np.asarray(origin, np.float32)
    return vertices * sp[None] + og[None], faces


def extract_mesh_from_sdf(sdf_volume: np.ndarray, bounds: np.ndarray,
                          level: float = 0.0):
    """SDF grid + (2, 3) bounds -> world-space mesh
    (ref: utils/recon_util.py:51-75; reference negates because its SDF is
    inside-positive — callers pass the matching sign convention)."""
    res = np.asarray(sdf_volume.shape, np.float32)
    spacing = (bounds[1] - bounds[0]) / np.maximum(res - 1, 1)
    return marching_cubes(sdf_volume, level=level, spacing=spacing,
                          origin=bounds[0])


def compute_sobel_normals(volume: np.ndarray) -> np.ndarray:
    """Central-difference gradient normals of an SDF grid (approximation of
    the reference's Sobel normal pass, ref: utils/recon_util.py:9-49)."""
    gx, gy, gz = np.gradient(np.asarray(volume, np.float32))
    g = np.stack([gx, gy, gz], axis=-1)
    return g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-8)
