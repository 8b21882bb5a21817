"""SMPL-X body model in PyTorch.

Port of ``animatablegaussians_tpu/models/smplx/body_model.py`` (``SMPLXData``,
``SMPLX.from_npz`` and the forward; ref: smplx/body_models.py:959-1292). It
reads the standard ``SMPLX_*.npz`` archives and returns what the avatar
pipeline consumes: vertices, the LBS joints (with the extra landmark joints
on the real SMPL-X topology, and the face landmarks when the archive carries
their embedding) and the translation-adjusted per-joint matrices ``A``. The
model tensors live on the device given to ``from_npz``; the batch comes from
the inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from .lbs import (blend_shapes, find_dynamic_lmk_idx_and_bcoords, lbs,
                  vertices2landmarks)
from .vertex_ids import VERTEX_IDS, extra_joints_indices

NUM_JOINTS = 55           # 1 global + 21 body + jaw + 2 eyes + 30 hand joints
NUM_BODY_JOINTS = 21


@dataclasses.dataclass(frozen=True)
class SMPLXData:
    """SMPL-X model tensors, all on one device."""
    v_template: torch.Tensor      # (V, 3)
    shapedirs: torch.Tensor       # (V, 3, n_betas)
    expr_dirs: torch.Tensor       # (V, 3, n_expr)
    posedirs: torch.Tensor        # ((J-1)*9, V*3)
    J_regressor: torch.Tensor     # (J, V)
    lbs_weights: torch.Tensor     # (V, J)
    left_hand_components: torch.Tensor   # (n_pca, 45)
    right_hand_components: torch.Tensor  # (n_pca, 45)
    left_hand_mean: torch.Tensor  # (45,)
    right_hand_mean: torch.Tensor  # (45,)
    parents: np.ndarray           # (J,), parents[0] = 0
    faces: np.ndarray             # (F, 3)
    # face landmark embedding (real SMPL-X archives only): 51 static
    # landmarks as (face id, barycentric) pairs and the 79-row dynamic
    # contour table
    lmk_faces_idx: Optional[torch.Tensor] = None          # (L,)
    lmk_bary_coords: Optional[torch.Tensor] = None        # (L, 3)
    dynamic_lmk_faces_idx: Optional[torch.Tensor] = None  # (79, 17)
    dynamic_lmk_bary_coords: Optional[torch.Tensor] = None  # (79, 17, 3)


def _kin_chain(joint_id: int, parents) -> list:
    """Joint ids from ``joint_id`` up to the root, inclusive."""
    chain, cur = [], int(joint_id)
    while True:
        chain.append(cur)
        if cur == 0:
            break
        cur = int(parents[cur])
    return chain


class SMPLX(nn.Module):
    """SMPL-X forward; the constructor arguments are the reference's
    (ref: smplx/body_models.py:975-1007)."""

    NECK_IDX = 12  # ref: smplx/body_models.py:900

    def __init__(self, data: SMPLXData, num_pca_comps: int = 6,
                 use_pca: bool = True, flat_hand_mean: bool = False,
                 vertex_ids=None, use_hands: bool = True,
                 use_feet_keypoints: bool = True,
                 use_face_contour: bool = False):
        """``vertex_ids``: a dict or ``VERTEX_IDS`` key ("smplx") that
        appends the extra landmark joints after the LBS joints (and the face
        landmarks when the data carries them); None keeps the bare LBS
        joints."""
        super().__init__()
        self.data = data
        self.use_pca = use_pca
        self.num_pca_comps = num_pca_comps
        self.flat_hand_mean = flat_hand_mean
        self.num_joints = int(data.J_regressor.shape[0])
        self.num_verts = int(data.v_template.shape[0])
        self.faces = data.faces
        self.use_face_contour = use_face_contour
        self.extra_joints_idxs = None
        if vertex_ids is not None:
            if isinstance(vertex_ids, str):
                vertex_ids = VERTEX_IDS[vertex_ids]
            self.extra_joints_idxs = torch.as_tensor(extra_joints_indices(
                vertex_ids, use_hands=use_hands,
                use_feet_keypoints=use_feet_keypoints),
                device=data.v_template.device)
        self.neck_kin_chain = _kin_chain(self.NECK_IDX, data.parents)

    @staticmethod
    def from_npz(path: str, num_betas: int = 10, num_expression: int = 10,
                 device="cuda", **kw) -> "SMPLX":
        """An ``SMPLX_*.npz`` archive -> the model on ``device``; ``kw`` go
        to the constructor."""
        raw = np.load(path, allow_pickle=True)
        dev = torch.device(device)

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        shapedirs = np.asarray(raw["shapedirs"], np.float32)
        # SMPL-X ships 400 dirs: 300 shape, then 100 expression
        n_shape = min(num_betas, shapedirs.shape[-1])
        expr = (shapedirs[..., 300:300 + num_expression]
                if shapedirs.shape[-1] > 300 else
                np.zeros(shapedirs.shape[:2] + (num_expression,), np.float32))
        posedirs = np.asarray(raw["posedirs"], np.float32)
        if posedirs.ndim == 3:       # (V, 3, P) -> (P, V*3), the lbs layout
            posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T
        parents = np.asarray(raw["kintree_table"])[0].astype(np.int64)
        parents[0] = 0               # root sentinel (uint32 -1) -> 0
        lmk = {}
        if "lmk_faces_idx" in raw:
            lmk.update(lmk_faces_idx=t(raw["lmk_faces_idx"], torch.int64),
                       lmk_bary_coords=t(raw["lmk_bary_coords"]))
        if "dynamic_lmk_faces_idx" in raw:
            lmk.update(dynamic_lmk_faces_idx=t(raw["dynamic_lmk_faces_idx"],
                                               torch.int64),
                       dynamic_lmk_bary_coords=t(
                           raw["dynamic_lmk_bary_coords"]))
        data = SMPLXData(
            v_template=t(raw["v_template"]),
            shapedirs=t(shapedirs[..., :n_shape]), expr_dirs=t(expr),
            posedirs=t(posedirs), J_regressor=t(raw["J_regressor"]),
            lbs_weights=t(raw["weights"]),
            left_hand_components=t(raw["hands_componentsl"]),
            right_hand_components=t(raw["hands_componentsr"]),
            left_hand_mean=t(raw["hands_meanl"]),
            right_hand_mean=t(raw["hands_meanr"]),
            parents=parents, faces=np.asarray(raw["f"], dtype=np.int64),
            **lmk)
        if ("vertex_ids" not in kw and data.v_template.shape[0]
                > max(VERTEX_IDS["smplx"].values())):
            # the extra landmark joints exist only on the real topology
            kw["vertex_ids"] = "smplx"
        return SMPLX(data, **kw)

    def pose_mean(self) -> torch.Tensor:
        """165-dim additive pose mean: zeros but the hand means, unless
        ``flat_hand_mean``."""
        d = self.data
        zeros = torch.zeros(3 + NUM_BODY_JOINTS * 3 + 9,
                            device=d.v_template.device)
        if self.flat_hand_mean:
            hands = torch.zeros(90, device=d.v_template.device)
        else:
            hands = torch.cat([d.left_hand_mean, d.right_hand_mean])
        return torch.cat([zeros, hands])

    def _extend_joints(self, joints, verts, full_pose):
        """LBS joints ++ extra vertex joints ++ face landmarks (static, and
        the dynamic contour when enabled; ref: smplx/body_models.py:
        1241-1267)."""
        d = self.data
        if self.extra_joints_idxs is not None:
            joints = torch.cat([joints, verts[:, self.extra_joints_idxs]],
                               dim=1)
        if d.lmk_faces_idx is not None:
            B = verts.shape[0]
            lmk_f = d.lmk_faces_idx[None].expand(
                (B,) + d.lmk_faces_idx.shape)
            lmk_b = d.lmk_bary_coords[None].expand(
                (B,) + d.lmk_bary_coords.shape)
            if self.use_face_contour:
                dyn_f, dyn_b = find_dynamic_lmk_idx_and_bcoords(
                    full_pose, d.dynamic_lmk_faces_idx,
                    d.dynamic_lmk_bary_coords, self.neck_kin_chain)
                lmk_f = torch.cat([lmk_f, dyn_f], dim=1)
                lmk_b = torch.cat([lmk_b, dyn_b], dim=1)
            joints = torch.cat([joints, vertices2landmarks(
                verts, d.faces, lmk_f, lmk_b)], dim=1)
        return joints

    def forward(self, betas, global_orient=None, body_pose=None,
                left_hand_pose=None, right_hand_pose=None, transl=None,
                expression=None, jaw_pose=None, leye_pose=None,
                reye_pose=None) -> dict:
        """(B, ...) pose tensors on the model's device (None = zeros) ->
        vertices (B, V, 3), joints (B, J', 3), A (B, J, 4, 4), v_shaped and
        full_pose."""
        d = self.data
        B = betas.shape[0]

        def dflt(x, dim):
            return (torch.zeros((B, dim), device=d.v_template.device)
                    if x is None else x)

        global_orient = dflt(global_orient, 3)
        body_pose = dflt(body_pose, NUM_BODY_JOINTS * 3)
        jaw_pose = dflt(jaw_pose, 3)
        leye_pose = dflt(leye_pose, 3)
        reye_pose = dflt(reye_pose, 3)
        expression = dflt(expression, d.expr_dirs.shape[-1])
        hand_dim = self.num_pca_comps if self.use_pca else 45
        left_hand_pose = dflt(left_hand_pose, hand_dim)
        right_hand_pose = dflt(right_hand_pose, hand_dim)
        if self.use_pca:
            left_hand_pose = left_hand_pose @ \
                d.left_hand_components[:self.num_pca_comps]
            right_hand_pose = right_hand_pose @ \
                d.right_hand_components[:self.num_pca_comps]
        full_pose = torch.cat([
            global_orient.reshape(B, 3),
            body_pose.reshape(B, NUM_BODY_JOINTS * 3),
            jaw_pose, leye_pose, reye_pose,
            left_hand_pose.reshape(B, 45), right_hand_pose.reshape(B, 45),
        ], dim=1) + self.pose_mean()[None]
        shape_components = torch.cat([betas, expression], dim=-1)
        shapedirs = torch.cat([d.shapedirs, d.expr_dirs], dim=-1)
        verts, joints, A = lbs(shape_components, full_pose, d.v_template,
                               shapedirs, d.posedirs, d.J_regressor,
                               d.parents, d.lbs_weights)
        joints = self._extend_joints(joints, verts, full_pose)
        if transl is not None:
            verts = verts + transl[:, None]
            joints = joints + transl[:, None]
            A = A.clone()
            A[:, :, :3, 3] = A[:, :, :3, 3] + transl[:, None]
        v_shaped = d.v_template[None] + blend_shapes(betas, d.shapedirs)
        return dict(vertices=verts, joints=joints, A=A, v_shaped=v_shaped,
                    full_pose=full_pose)
