"""MANO hand helpers, a numpy copy of ``animatablegaussians_tpu/data/
commons.py`` (ref: dataset/commons.py:8-31): crop the SMPL-X hand
vertices to watertight MANO meshes via the vertex index maps shipped with
the reference data (``smpl_files/mano/*``), and compute vertex normals.

The index maps are data files the user provides (same layout as the
reference: smplx_{l,r}hand_to_mano_rhand.npz + mano_face_close.txt)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from animatablegaussians_torch import config as agt_config


class ManoData:
    def __init__(self, mano_dir: Optional[str] = None):
        mano_dir = mano_dir or os.path.join(agt_config.PROJ_DIR,
                                            "smpl_files", "mano")
        l = np.load(os.path.join(mano_dir, "smplx_lhand_to_mano_rhand.npz"),
                    allow_pickle=True)
        r = np.load(os.path.join(mano_dir, "smplx_rhand_to_mano_rhand.npz"),
                    allow_pickle=True)
        self.smpl_lhand_vert_id = np.copy(l["smpl_vert_id_to_mano"])
        self.smpl_rhand_vert_id = np.copy(r["smpl_vert_id_to_mano"])
        self.smpl_hands_vert_id = np.concatenate(
            [self.smpl_lhand_vert_id, self.smpl_rhand_vert_id])
        self.mano_face_closed = np.loadtxt(
            os.path.join(mano_dir, "mano_face_close.txt")).astype(np.int64)
        self.mano_face_closed_turned = self.mano_face_closed[:, ::-1]
        self.mano_face_closed_2hand = np.concatenate([
            self.mano_face_closed_turned,
            self.mano_face_closed + self.smpl_lhand_vert_id.shape[0]])


def try_load_mano(mano_dir: Optional[str] = None) -> Optional["ManoData"]:
    """ManoData if the index-map files exist, else None (datasets then omit
    the mano item keys; hand-specific features require the files, as in the
    reference which hard-requires them at dataset init,
    ref: dataset/commons.py:8-19)."""
    d = mano_dir or os.path.join(agt_config.PROJ_DIR, "smpl_files", "mano")
    if not os.path.exists(os.path.join(d,
                                       "smplx_lhand_to_mano_rhand.npz")):
        return None
    return ManoData(d)


def _vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    return (vn / np.maximum(np.linalg.norm(vn, axis=1, keepdims=True),
                            1e-12)).astype(np.float32)


def generate_two_manos(mano: ManoData, smplx_verts: np.ndarray):
    """SMPL-X vertices -> (left_v, left_n, right_v, right_n)
    (ref: dataset/commons.py:22-31; left hand uses flipped faces)."""
    smplx_verts = np.asarray(smplx_verts)
    lv = smplx_verts[mano.smpl_lhand_vert_id]
    ln = _vertex_normals(lv, mano.mano_face_closed_turned)
    rv = smplx_verts[mano.smpl_rhand_vert_id]
    rn = _vertex_normals(rv, mano.mano_face_closed)
    return lv.astype(np.float32), ln, rv.astype(np.float32), rn
