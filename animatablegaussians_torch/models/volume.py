"""Canonical LBS weight volume: trilinear weight and SDF queries and the
Sobel gradient volume of the root finding. A port of
``animatablegaussians_tpu/models/volume.py`` (ref: network/volume.py:9-130)
over the same ``cano_weight_volume.npz`` (diff / ori weight volumes
(X, Y, Z, J), an optional sdf volume, the bounds). Volumes stay
channels-last (X, Y, Z, C) on ``device`` and are read with
``ops/grid_sample.py``'s gathers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from animatablegaussians_torch.ops.grid_sample import (
    sample_volume_nearest, sample_volume_trilinear)


def compute_gradient_volume(weight_volume: torch.Tensor,
                            voxel_size: torch.Tensor) -> torch.Tensor:
    """3D Sobel gradient of a (X, Y, Z, C) volume -> (X, Y, Z, C, 3)
    (ref: network/volume.py:9-40; the same 16-normalised kernels): one
    ``F.conv3d`` of the (C, 1, X, Y, Z) volume, in FP32 (cuDNN's TF32 off
    for the call)."""
    dev = weight_volume.device
    base = torch.tensor([[-1, -2, -1], [-2, -4, -2], [-1, -2, -1]],
                        dtype=torch.float32, device=dev)
    sx = torch.stack([base, torch.zeros_like(base), -base], dim=0)
    sz = sx.permute(1, 2, 0)
    sy = sx.permute(2, 0, 1)
    kernels = torch.stack([sx / (16 * 2 * voxel_size[0]),
                           sy / (16 * 2 * voxel_size[1]),
                           sz / (16 * 2 * voxel_size[2])], dim=0)
    x = weight_volume.permute(3, 0, 1, 2)[:, None]      # (C, 1, X, Y, Z)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        g = F.conv3d(x, kernels[:, None], padding=1)    # (C, 3, X, Y, Z)
    return g.permute(2, 3, 4, 0, 1).contiguous()        # (X, Y, Z, C, 3)


class CanoBlendWeightVolume:
    def __init__(self, data_path: Optional[str] = None,
                 data: Optional[dict] = None, device="cuda"):
        if data is None:
            with np.load(data_path) as f:
                data = {k: f[k] for k in f.files}
        dev = torch.device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        self.diff_weight_volume = t(data["diff_weight_volume"])
        self.ori_weight_volume = t(data.get("ori_weight_volume",
                                            data["diff_weight_volume"]))
        sdf = data.get("sdf_volume")
        if sdf is not None:
            sdf = np.asarray(sdf)
            self.sdf_volume = t(sdf[..., None] if sdf.ndim == 3 else sdf)
        else:
            self.sdf_volume = None
        self.volume_bounds = t(data["volume_bounds"])
        self.center = t(data.get("center", np.zeros(3)))
        self.smpl_bounds = t(data.get("smpl_bounds", data["volume_bounds"]))

        (self.res_x, self.res_y, self.res_z,
         self.joint_num) = self.diff_weight_volume.shape
        extent = self.volume_bounds[1] - self.volume_bounds[0]
        self.voxel_size = extent / torch.tensor(
            [self.res_x - 1, self.res_y - 1, self.res_z - 1],
            dtype=torch.float32, device=dev)
        self._grad_volume = None

    def _scale(self, pts: torch.Tensor) -> torch.Tensor:
        return ((pts - self.volume_bounds[0])
                / (self.volume_bounds[1] - self.volume_bounds[0]))

    def forward_weight(self, pts: torch.Tensor, requires_scale: bool = True,
                       volume_type: str = "diff") -> torch.Tensor:
        """(N, 3) points -> (N, J) LBS weights (ref: network/volume.py:72-93).
        """
        if requires_scale:
            pts = self._scale(pts)
        vol = (self.diff_weight_volume if volume_type == "diff"
               else self.ori_weight_volume)
        return sample_volume_trilinear(vol, pts)

    def forward_sdf(self, pts: torch.Tensor,
                    requires_scale: bool = True) -> torch.Tensor:
        """(N, 3) -> (N, 1) (ref: network/volume.py:116-130)."""
        assert self.sdf_volume is not None
        if requires_scale:
            pts = self._scale(pts)
        return sample_volume_trilinear(self.sdf_volume, pts)

    @property
    def grad_volume(self) -> torch.Tensor:
        """(X, Y, Z, J, 3) Sobel gradient of the diff volume, made once."""
        if self._grad_volume is None:
            self._grad_volume = compute_gradient_volume(
                self.diff_weight_volume, self.voxel_size)
        return self._grad_volume

    def forward_weight_grad(self, pts: torch.Tensor,
                            requires_scale: bool = True) -> torch.Tensor:
        """(N, 3) -> (N, J, 3), the nearest voxel (ref:
        network/volume.py:95-114)."""
        if requires_scale:
            pts = self._scale(pts)
        J = self.joint_num
        flat = self.grad_volume.reshape(self.res_x, self.res_y, self.res_z,
                                        J * 3)
        return sample_volume_nearest(flat, pts).reshape(-1, J, 3)
