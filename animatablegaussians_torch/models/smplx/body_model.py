"""The SMPL body-model family in PyTorch: SMPL-X, SMPL, SMPL+H, MANO and
FLAME.

Port of ``animatablegaussians_tpu/models/smplx/body_model.py`` (ref:
smplx/body_models.py). ``SMPLX.from_npz`` reads the standard
``SMPLX_*.npz`` archives and the forward returns what the avatar pipeline
consumes: vertices, the LBS joints (with the extra landmark joints on the
real SMPL-X topology, and the face landmarks when the archive carries their
embedding) and the translation-adjusted per-joint matrices ``A``. The other
families share the ``lbs`` core and the ``SMPLXData`` layout: SMPL and
SMPL+H carry a zero-width expression basis (V, 3, 0); MANO drops its PCA
pose space when it has no components; FLAME joins betas and expression
into one basis and reads its face contour from the neck chain [0]. Each
model's tensors live on the device given to ``from_npz`` (the card by
default) or on its ``SMPLXData``'s; the batch comes from the inputs.

``SMPL.from_npz`` and ``SMPLH.from_npz`` read the reference's archives as
the JAX package's do. ``MANO.from_npz`` and ``FLAME.from_npz`` have no
JAX counterpart (the JAX classes take an ``SMPLXData``): they read archives
with the same keys, MANO's PCA basis as ``hands_components`` /
``hands_mean`` and FLAME's landmark embedding under the SMPL-X names.
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
HAND_JOINTS = 15


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


def _extend_joints(joints, verts, full_pose, data: SMPLXData,
                   extra_joints_idxs, neck_kin_chain,
                   use_face_contour: bool):
    """LBS joints ++ extra vertex joints ++ face landmarks (static, and the
    dynamic contour when enabled; ref: smplx/body_models.py:1241-1267)."""
    if extra_joints_idxs is not None:
        joints = torch.cat([joints, verts[:, extra_joints_idxs]], dim=1)
    if data.lmk_faces_idx is not None:
        B = verts.shape[0]
        lmk_f = data.lmk_faces_idx[None].expand(
            (B,) + data.lmk_faces_idx.shape)
        lmk_b = data.lmk_bary_coords[None].expand(
            (B,) + data.lmk_bary_coords.shape)
        if use_face_contour:
            dyn_f, dyn_b = find_dynamic_lmk_idx_and_bcoords(
                full_pose, data.dynamic_lmk_faces_idx,
                data.dynamic_lmk_bary_coords, neck_kin_chain)
            lmk_f = torch.cat([lmk_f, dyn_f], dim=1)
            lmk_b = torch.cat([lmk_b, dyn_b], dim=1)
        joints = torch.cat([joints, vertices2landmarks(
            verts, data.faces, lmk_f, lmk_b)], dim=1)
    return joints


def _translate(verts, joints, A, transl):
    """Shift the outputs by ``transl`` (B, 3); None leaves them."""
    if transl is None:
        return verts, joints, A
    A = A.clone()
    A[:, :, :3, 3] = A[:, :, :3, 3] + transl[:, None]
    return verts + transl[:, None], joints + transl[:, None], A


def _extra_joints(vertex_ids, use_hands: bool, use_feet_keypoints: bool,
                  device):
    """The extra landmark joints' vertex ids on ``device``, or None."""
    if vertex_ids is None:
        return None
    if isinstance(vertex_ids, str):
        vertex_ids = VERTEX_IDS[vertex_ids]
    return torch.as_tensor(extra_joints_indices(
        vertex_ids, use_hands=use_hands,
        use_feet_keypoints=use_feet_keypoints), device=device)


def _read_npz(path: str, device, num_betas: int):
    """An archive's arrays -> (raw npz, tensor maker, the SMPLXData fields
    every family shares: template, the first ``num_betas`` shape
    directions, pose directions in the lbs layout, regressor, weights,
    parents with the root sentinel at 0, faces)."""
    raw = np.load(path, allow_pickle=True)
    dev = torch.device(device)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    shapedirs = np.asarray(raw["shapedirs"], np.float32)
    posedirs = np.asarray(raw["posedirs"], np.float32)
    if posedirs.ndim == 3:           # (V, 3, P) -> (P, V*3), the lbs layout
        posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T
    parents = np.asarray(raw["kintree_table"])[0].astype(np.int64)
    parents[0] = 0                   # root sentinel (uint32 -1) -> 0
    common = dict(
        v_template=t(raw["v_template"]),
        shapedirs=t(shapedirs[..., :min(num_betas, shapedirs.shape[-1])]),
        posedirs=t(posedirs), J_regressor=t(raw["J_regressor"]),
        lbs_weights=t(raw["weights"]), parents=parents,
        faces=np.asarray(raw["f"], dtype=np.int64))
    return raw, t, common


def _landmarks(raw, t) -> dict:
    """The face-landmark embedding's SMPLXData fields, where the archive
    has them."""
    lmk = {}
    if "lmk_faces_idx" in raw:
        lmk.update(lmk_faces_idx=t(raw["lmk_faces_idx"], torch.int64),
                   lmk_bary_coords=t(raw["lmk_bary_coords"]))
    if "dynamic_lmk_faces_idx" in raw:
        lmk.update(dynamic_lmk_faces_idx=t(raw["dynamic_lmk_faces_idx"],
                                           torch.int64),
                   dynamic_lmk_bary_coords=t(
                       raw["dynamic_lmk_bary_coords"]))
    return lmk


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
        self.extra_joints_idxs = _extra_joints(
            vertex_ids, use_hands, use_feet_keypoints, data.v_template.device)
        self.neck_kin_chain = _kin_chain(self.NECK_IDX, data.parents)

    @staticmethod
    def from_npz(path: str, gender: str = "neutral", num_betas: int = 10,
                 num_expression: int = 10, device="cuda", **kw) -> "SMPLX":
        """An ``SMPLX_*.npz`` archive -> the model on ``device``; ``kw`` go
        to the constructor. ``gender`` is accepted and ignored, as in the
        JAX package: the archive is the gender."""
        raw, t, common = _read_npz(path, device, num_betas)
        shapedirs = np.asarray(raw["shapedirs"], np.float32)
        # SMPL-X ships 400 dirs: 300 shape, then 100 expression
        expr = (shapedirs[..., 300:300 + num_expression]
                if shapedirs.shape[-1] > 300 else
                np.zeros(shapedirs.shape[:2] + (num_expression,), np.float32))
        data = SMPLXData(
            **common, expr_dirs=t(expr),
            left_hand_components=t(raw["hands_componentsl"]),
            right_hand_components=t(raw["hands_componentsr"]),
            left_hand_mean=t(raw["hands_meanl"]),
            right_hand_mean=t(raw["hands_meanr"]),
            **_landmarks(raw, t))
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
        joints = _extend_joints(joints, verts, full_pose, d,
                                self.extra_joints_idxs, self.neck_kin_chain,
                                self.use_face_contour)
        verts, joints, A = _translate(verts, joints, A, transl)
        v_shaped = d.v_template[None] + blend_shapes(betas, d.shapedirs)
        return dict(vertices=verts, joints=joints, A=A, v_shaped=v_shaped,
                    full_pose=full_pose)


def _zero_hands(V: int, device) -> dict:
    """The hand fields of a model without a hand pose space, and its
    zero-width expression basis."""
    z45 = torch.zeros(45, device=device)
    return dict(expr_dirs=torch.zeros((V, 3, 0), device=device),
                left_hand_components=torch.zeros((1, 45), device=device),
                right_hand_components=torch.zeros((1, 45), device=device),
                left_hand_mean=z45, right_hand_mean=z45)


def _zeros(B: int, device):
    """``dflt(x, dim)``: x, or (B, dim) zeros where x is None."""
    def dflt(x, dim):
        return torch.zeros((B, dim), device=device) if x is None else x
    return dflt


class SMPL(nn.Module):
    """Body-only SMPL (24 joints) on the same ``lbs`` core (ref:
    smplx/body_models.py SMPL class)."""

    NUM_JOINTS = 24

    def __init__(self, data: SMPLXData):
        super().__init__()
        self.data = data
        self.num_joints = int(data.J_regressor.shape[0])
        self.num_verts = int(data.v_template.shape[0])
        self.faces = data.faces

    @staticmethod
    def from_npz(path: str, num_betas: int = 10, device="cuda",
                 **kw) -> "SMPL":
        """An ``SMPL_*.npz`` archive -> the model on ``device``. ``kw`` are
        accepted and ignored, as in the JAX package."""
        _, _, common = _read_npz(path, device, num_betas)
        v = common["v_template"]
        return SMPL(SMPLXData(**common, **_zero_hands(v.shape[0], v.device)))

    def forward(self, betas, global_orient=None, body_pose=None,
                transl=None) -> dict:
        """(B, ...) tensors on the model's device (None = zeros) ->
        vertices, joints, A and full_pose."""
        d = self.data
        B = betas.shape[0]
        dflt = _zeros(B, d.v_template.device)
        n_body = (self.num_joints - 1) * 3
        full_pose = torch.cat([dflt(global_orient, 3).reshape(B, 3),
                               dflt(body_pose, n_body).reshape(B, n_body)],
                              dim=1)
        verts, joints, A = lbs(betas, full_pose, d.v_template, d.shapedirs,
                               d.posedirs, d.J_regressor, d.parents,
                               d.lbs_weights)
        verts, joints, A = _translate(verts, joints, A, transl)
        return dict(vertices=verts, joints=joints, A=A, full_pose=full_pose)


class MANO(nn.Module):
    """One hand (16 joints with the wrist) on the same ``lbs`` core, with
    the PCA pose space when it has ``hand_components`` (ref:
    smplx/body_models.py MANO class)."""

    def __init__(self, data: SMPLXData, hand_components=None,
                 hand_mean=None, num_pca_comps: int = 6,
                 use_pca: bool = True, flat_hand_mean: bool = False):
        super().__init__()
        dev = data.v_template.device
        self.data = data
        self.hand_components = (None if hand_components is None else
                                torch.as_tensor(hand_components,
                                                dtype=torch.float32,
                                                device=dev))
        self.hand_mean = (torch.zeros(45, device=dev)
                          if flat_hand_mean or hand_mean is None else
                          torch.as_tensor(hand_mean, dtype=torch.float32,
                                          device=dev))
        self.num_pca_comps = num_pca_comps
        self.use_pca = use_pca and hand_components is not None
        self.num_joints = int(data.J_regressor.shape[0])
        self.faces = data.faces

    @staticmethod
    def from_npz(path: str, num_betas: int = 10, device="cuda",
                 **kw) -> "MANO":
        """A ``MANO_*.npz`` archive -> the model on ``device``; its PCA
        basis from ``hands_components`` / ``hands_mean`` where present.
        ``kw`` go to the constructor."""
        raw, t, common = _read_npz(path, device, num_betas)
        v = common["v_template"]
        if "hands_components" in raw:
            kw.setdefault("hand_components", t(raw["hands_components"]))
            kw.setdefault("hand_mean", t(raw["hands_mean"]))
        return MANO(SMPLXData(**common, **_zero_hands(v.shape[0], v.device)),
                    **kw)

    def forward(self, betas, global_orient=None, hand_pose=None,
                transl=None) -> dict:
        d = self.data
        B = betas.shape[0]
        dflt = _zeros(B, d.v_template.device)
        hand_pose = dflt(hand_pose,
                         self.num_pca_comps if self.use_pca else 45)
        if self.use_pca:
            hand_pose = hand_pose @ \
                self.hand_components[:self.num_pca_comps]
        hand_pose = hand_pose + self.hand_mean[None]
        full_pose = torch.cat([dflt(global_orient, 3).reshape(B, 3),
                               hand_pose.reshape(B, 45)], dim=1)
        verts, joints, A = lbs(betas, full_pose, d.v_template, d.shapedirs,
                               d.posedirs, d.J_regressor, d.parents,
                               d.lbs_weights)
        verts, joints, A = _translate(verts, joints, A, transl)
        return dict(vertices=verts, joints=joints, A=A, full_pose=full_pose)


class SMPLH(nn.Module):
    """SMPL+H: the SMPL body with MANO hands, 52 LBS joints (1 global + 21
    body + 30 hand), the PCA hand pose space and the extra landmark joints
    on the real topology (ref: smplx/body_models.py:502-755)."""

    NUM_BODY_JOINTS = 21
    NUM_JOINTS = NUM_BODY_JOINTS + 2 * HAND_JOINTS + 1

    def __init__(self, data: SMPLXData, num_pca_comps: int = 6,
                 use_pca: bool = True, flat_hand_mean: bool = False,
                 vertex_ids=None, use_hands: bool = True,
                 use_feet_keypoints: bool = True):
        super().__init__()
        self.data = data
        self.use_pca = use_pca
        self.num_pca_comps = num_pca_comps
        self.flat_hand_mean = flat_hand_mean
        self.num_joints = int(data.J_regressor.shape[0])
        self.num_verts = int(data.v_template.shape[0])
        self.faces = data.faces
        self.extra_joints_idxs = _extra_joints(
            vertex_ids, use_hands, use_feet_keypoints, data.v_template.device)

    @staticmethod
    def from_npz(path: str, num_betas: int = 10, device="cuda",
                 **kw) -> "SMPLH":
        """An ``SMPLH_*.npz`` archive -> the model on ``device``; ``kw`` go
        to the constructor."""
        raw, t, common = _read_npz(path, device, num_betas)
        V = common["v_template"].shape[0]
        data = SMPLXData(
            **common, expr_dirs=t(np.zeros((V, 3, 0), np.float32)),
            left_hand_components=t(raw["hands_componentsl"]),
            right_hand_components=t(raw["hands_componentsr"]),
            left_hand_mean=t(raw["hands_meanl"]),
            right_hand_mean=t(raw["hands_meanr"]))
        if "vertex_ids" not in kw and V > max(VERTEX_IDS["smplh"].values()):
            kw["vertex_ids"] = "smplh"
        return SMPLH(data, **kw)

    def pose_mean(self) -> torch.Tensor:
        """156-dim additive pose mean: zeros but the hand means, unless
        ``flat_hand_mean`` (ref: smplx/body_models.py:666-676)."""
        d = self.data
        zeros = torch.zeros(3 + self.NUM_BODY_JOINTS * 3,
                            device=d.v_template.device)
        if self.flat_hand_mean:
            hands = torch.zeros(90, device=d.v_template.device)
        else:
            hands = torch.cat([d.left_hand_mean, d.right_hand_mean])
        return torch.cat([zeros, hands])

    def forward(self, betas, global_orient=None, body_pose=None,
                left_hand_pose=None, right_hand_pose=None,
                transl=None) -> dict:
        d = self.data
        B = betas.shape[0]
        dflt = _zeros(B, d.v_template.device)
        hand_dim = self.num_pca_comps if self.use_pca else 45
        left_hand_pose = dflt(left_hand_pose, hand_dim)
        right_hand_pose = dflt(right_hand_pose, hand_dim)
        if self.use_pca:
            left_hand_pose = left_hand_pose @ \
                d.left_hand_components[:self.num_pca_comps]
            right_hand_pose = right_hand_pose @ \
                d.right_hand_components[:self.num_pca_comps]
        full_pose = torch.cat([
            dflt(global_orient, 3).reshape(B, 3),
            dflt(body_pose, self.NUM_BODY_JOINTS * 3).reshape(
                B, self.NUM_BODY_JOINTS * 3),
            left_hand_pose.reshape(B, 45), right_hand_pose.reshape(B, 45),
        ], dim=1) + self.pose_mean()[None]
        verts, joints, A = lbs(betas, full_pose, d.v_template, d.shapedirs,
                               d.posedirs, d.J_regressor, d.parents,
                               d.lbs_weights)
        if self.extra_joints_idxs is not None:
            joints = torch.cat([joints, verts[:, self.extra_joints_idxs]],
                               dim=1)
        verts, joints, A = _translate(verts, joints, A, transl)
        return dict(vertices=verts, joints=joints, A=A, full_pose=full_pose)


class FLAME(nn.Module):
    """Head-only FLAME: 5 LBS joints (global, neck, jaw, two eyes), shape
    and expression in one basis, the face landmarks with the dynamic
    contour; no extra vertex joints (the reference empties the selector,
    ref: smplx/body_models.py:1771-2133)."""

    NUM_JOINTS = 5
    NECK_IDX = 0  # ref: smplx/body_models.py:1775

    def __init__(self, data: SMPLXData, use_face_contour: bool = False):
        super().__init__()
        self.data = data
        self.num_joints = int(data.J_regressor.shape[0])
        self.num_verts = int(data.v_template.shape[0])
        self.faces = data.faces
        self.use_face_contour = use_face_contour
        self.neck_kin_chain = _kin_chain(self.NECK_IDX, data.parents)

    @staticmethod
    def from_npz(path: str, num_betas: int = 10, num_expression: int = 10,
                 device="cuda", **kw) -> "FLAME":
        """A ``FLAME_*.npz`` archive (400 directions: 300 shape, then 100
        expression; the landmark embedding under the SMPL-X keys) -> the
        model on ``device``; ``kw`` go to the constructor."""
        raw, t, common = _read_npz(path, device, num_betas)
        v = common["v_template"]
        fields = _zero_hands(v.shape[0], v.device)
        fields["expr_dirs"] = t(np.asarray(
            raw["shapedirs"], np.float32)[..., 300:300 + num_expression])
        return FLAME(SMPLXData(**common, **fields, **_landmarks(raw, t)),
                     **kw)

    def forward(self, betas, global_orient=None, neck_pose=None,
                jaw_pose=None, leye_pose=None, reye_pose=None,
                expression=None, transl=None) -> dict:
        d = self.data
        B = betas.shape[0]
        dflt = _zeros(B, d.v_template.device)
        full_pose = torch.cat(
            [dflt(p, 3).reshape(B, 3) for p in
             (global_orient, neck_pose, jaw_pose, leye_pose, reye_pose)],
            dim=1)
        expression = dflt(expression, d.expr_dirs.shape[-1])
        shape_components = torch.cat([betas, expression], dim=-1)
        shapedirs = torch.cat([d.shapedirs, d.expr_dirs], dim=-1)
        verts, joints, A = lbs(shape_components, full_pose, d.v_template,
                               shapedirs, d.posedirs, d.J_regressor,
                               d.parents, d.lbs_weights)
        joints = _extend_joints(joints, verts, full_pose, d, None,
                                self.neck_kin_chain, self.use_face_contour)
        verts, joints, A = _translate(verts, joints, A, transl)
        return dict(vertices=verts, joints=joints, A=A, full_pose=full_pose)
