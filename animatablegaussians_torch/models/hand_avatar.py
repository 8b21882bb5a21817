"""Per-hand colour field, a port of
``animatablegaussians_tpu/models/hand_avatar.py`` (ref:
network/hand_avatar.py:9-36): the embedded canonical xyz, the sdf and the
hand pose as quaternions -> a 5 x 64 MLP -> RGB."""

from __future__ import annotations

import torch
from torch import nn

from animatablegaussians_torch.models.mlp import MLPLinear
from animatablegaussians_torch.ops.embedder import get_embedder
from animatablegaussians_torch.ops.quat import axis_angle_to_quat


class HandAvatar(nn.Module):
    def __init__(self, multires: int = 4, view_multires: int = -1,
                 pose_dim: int = 15 * 4, device="cuda", seed: int = 0):
        super().__init__()
        self.pos_embedder, self.pos_dim = get_embedder(multires, 3)
        if view_multires == -1:
            self.view_embedder, self.view_dim = None, 0
        else:
            self.view_embedder, self.view_dim = get_embedder(view_multires,
                                                             3)
        self.pose_dim = pose_dim
        self.tex_mlp = MLPLinear(
            in_channels=self.pos_dim + 1 + self.view_dim + pose_dim,
            inter_channels=[64, 64, 64, 64, 64], out_channels=3,
            last_op="sigmoid", device=device, seed=seed)

    def forward(self, cano_xyz: torch.Tensor, sdf: torch.Tensor, view_dir,
                hand_pose: torch.Tensor) -> torch.Tensor:
        """cano_xyz (N, 3), sdf (N, 1), hand_pose (45,) axis-angle ->
        (N, 3)."""
        n = cano_xyz.shape[0]
        feat = torch.cat([self.pos_embedder(cano_xyz), sdf], dim=-1)
        quat = axis_angle_to_quat(hand_pose.reshape(-1, 3)).reshape(-1)
        if self.view_embedder is not None:
            feat = torch.cat([feat, self.view_embedder(view_dir)], dim=-1)
        feat = torch.cat([feat, quat[None].expand(n, quat.shape[0])],
                         dim=-1)
        return self.tex_mlp(feat)
