"""Linear blend skinning core in PyTorch.

Port of ``animatablegaussians_tpu/models/smplx/lbs.py`` (ref:
smplx/lbs.py:152-252, 349-405): shape blendshapes -> joint regression ->
pose blendshapes -> kinematic-chain rigid transforms -> vertex skinning.
Returns the per-joint translation-adjusted affine matrices ``A`` that the
avatar pipeline consumes as ``cano2live = A_live @ inv(A_cano)``. The same
formulas in the same order as the JAX functions, in float32; the kinematic
chain is a Python loop over the (static, small) tree.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from animatablegaussians_torch.ops.quat import axis_angle_to_mat


def blend_shapes(betas: torch.Tensor, shape_dirs: torch.Tensor):
    """(B, L) x (V, 3, L) -> (B, V, 3) shape displacement."""
    return torch.einsum("bl,vcl->bvc", betas, shape_dirs)


def vertices2joints(J_regressor: torch.Tensor, vertices: torch.Tensor):
    """(J, V) x (B, V, 3) -> (B, J, 3)."""
    return torch.einsum("jv,bvc->bjc", J_regressor, vertices)


def batch_rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3)."""
    return axis_angle_to_mat(aa)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                          parents: np.ndarray
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics along the tree: (B, J, 3, 3) rotations and (B, J,
    3) rest-pose joints -> (posed joints (B, J, 3), A (B, J, 4, 4)), where
    A_j maps a rest-pose point attached to joint j into posed space.
    ``parents[0]`` is ignored."""
    B, J = rot_mats.shape[:2]
    parents = np.asarray(parents)
    rel_joints = joints - torch.cat(
        [torch.zeros_like(joints[:, :1]), joints[:, parents[1:]]], dim=1)
    local = torch.zeros((B, J, 4, 4), dtype=rot_mats.dtype,
                        device=rot_mats.device)
    local[:, :, :3, :3] = rot_mats
    local[:, :, :3, 3] = rel_joints
    local[:, :, 3, 3] = 1.0
    chain = [local[:, 0]]
    for i in range(1, J):
        chain.append(chain[parents[i]] @ local[:, i])
    transforms = torch.stack(chain, dim=1)                  # (B, J, 4, 4)
    posed_joints = transforms[:, :, :3, 3]
    # subtract the rotated rest joint so A acts on rest-space coordinates
    t_correction = torch.einsum("bjxy,bjy->bjx", transforms[:, :, :3, :3],
                                joints)
    A = transforms.clone()
    A[:, :, :3, 3] = A[:, :, :3, 3] - t_correction
    return posed_joints, A


def lbs(betas, pose, v_template, shapedirs, posedirs, J_regressor, parents,
        lbs_weights, pose2rot: bool = True):
    """Full LBS: betas (B, L), pose (B, J*3) axis-angle (or (B, J, 3, 3)
    without ``pose2rot``), v_template (V, 3), shapedirs (V, 3, L), posedirs
    ((J-1)*9, V*3), J_regressor (J, V), parents (J,), lbs_weights (V, J) ->
    (verts (B, V, 3), joints (B, J, 3), A (B, J, 4, 4))."""
    B = max(betas.shape[0], pose.shape[0])
    v_shaped = v_template[None] + blend_shapes(betas, shapedirs)
    J = vertices2joints(J_regressor, v_shaped)
    if pose2rot:
        rot_mats = axis_angle_to_mat(pose.reshape(B, -1, 3))
    else:
        rot_mats = pose.reshape(B, -1, 3, 3)
    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
    v_posed = v_shaped + (pose_feature @ posedirs).reshape(B, -1, 3)
    posed_joints, A = batch_rigid_transform(rot_mats, J, parents)
    T = torch.einsum("vj,bjpq->bvpq", lbs_weights, A)
    verts = (torch.einsum("bvxy,bvy->bvx", T[:, :, :3, :3], v_posed)
             + T[:, :, :3, 3])
    return verts, posed_joints, A


def vertices2landmarks(vertices, faces, lmk_faces_idx, lmk_bary_coords):
    """Barycentric face-point landmarks (ref: smplx/lbs.py:108-149):
    vertices (B, V, 3), faces (F, 3), lmk_faces_idx (B, L), lmk_bary_coords
    (B, L, 3) -> (B, L, 3)."""
    faces = torch.as_tensor(np.asarray(faces), dtype=torch.int64,
                            device=vertices.device)
    lmk_faces = faces[lmk_faces_idx.to(torch.int64)]          # (B, L, 3)
    b = torch.arange(vertices.shape[0], device=vertices.device)
    lmk_verts = vertices[b[:, None, None], lmk_faces]         # (B, L, 3, 3)
    return torch.einsum("blfc,blf->blc", lmk_verts, lmk_bary_coords)


def rot_mat_to_euler(rot_mats):
    """Y euler angle of (..., 3, 3) rotations (ref: smplx/utils.py:122-128)."""
    sy = torch.sqrt(rot_mats[..., 0, 0] ** 2 + rot_mats[..., 1, 0] ** 2)
    return torch.atan2(-rot_mats[..., 2, 0], sy)


def find_dynamic_lmk_idx_and_bcoords(pose, dynamic_lmk_faces_idx,
                                     dynamic_lmk_bary_coords,
                                     neck_kin_chain):
    """Face-contour landmark LUT rows from the neck's global y rotation
    (ref: smplx/lbs.py:30-105): pose (B, J*3) -> ((B, L_dyn) faces,
    (B, L_dyn, 3) barycentrics)."""
    B = pose.shape[0]
    aa = pose.reshape(B, -1, 3)[:, np.asarray(neck_kin_chain)]
    rot_mats = axis_angle_to_mat(aa)                          # (B, C, 3, 3)
    rel = torch.eye(3, dtype=rot_mats.dtype,
                    device=rot_mats.device).expand(B, 3, 3)
    for i in range(len(neck_kin_chain)):
        rel = rot_mats[:, i] @ rel
    y_rot_angle = torch.round(torch.clamp(
        -rot_mat_to_euler(rel) * 180.0 / np.pi, max=39)).to(torch.int64)
    neg_mask = (y_rot_angle < 0).to(torch.int64)
    mask = (y_rot_angle < -39).to(torch.int64)
    neg_vals = mask * 78 + (1 - mask) * (39 - y_rot_angle)
    y_rot_angle = neg_mask * neg_vals + (1 - neg_mask) * y_rot_angle
    return (dynamic_lmk_faces_idx[y_rot_angle],
            dynamic_lmk_bary_coords[y_rot_angle])
