"""3D Gaussian parameters.

Port of ``animatablegaussians_tpu/models/gaussian_model.py:37-95``: raw
parameters live in log/logit space; activations are exp (scale), sigmoid
(opacity) and L2-normalize (rotation). ``create_from_pcd`` sets scales from
the mean squared distance to the 3 nearest neighbours (KNN with k=4,
including the point itself) and opacity at 0.1.
"""

from __future__ import annotations

import torch
from torch import nn

from animatablegaussians_torch.ops.knn import knn
from animatablegaussians_torch.ops.quat import normalize as quat_normalize

SH_C0 = 0.28209479177387814


def rgb_to_sh(rgb):
    return (rgb - 0.5) / SH_C0


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


class GaussianParams(nn.Module):
    """Raw (pre-activation) Gaussian parameters; the field names are the
    JAX dataclass's, so ``state_dict`` keys are ``xyz``, ``scaling``, ...."""

    FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity")

    def __init__(self, xyz, features_dc, features_rest, scaling, rotation,
                 opacity):
        super().__init__()
        self.xyz = nn.Parameter(xyz)                      # (N, 3)
        self.features_dc = nn.Parameter(features_dc)      # (N, 1, 3)
        self.features_rest = nn.Parameter(features_rest)  # (N, R, 3)
        self.scaling = nn.Parameter(scaling)              # (N, 3) log-scale
        self.rotation = nn.Parameter(rotation)            # (N, 4) raw wxyz
        self.opacity = nn.Parameter(opacity)              # (N, 1) logit

    @property
    def get_scaling(self):
        return torch.exp(self.scaling)

    @property
    def get_rotation(self):
        return quat_normalize(self.rotation)

    @property
    def get_opacity(self):
        return torch.sigmoid(self.opacity)


@torch.no_grad()
def create_from_pcd(points: torch.Tensor, colors: torch.Tensor,
                    sh_degree: int = 0) -> GaussianParams:
    """Initialize from a point cloud (ref: gaussian_model.py:156-183)."""
    n = points.shape[0]
    d2, _ = knn(points, points, k=4)
    dist2 = torch.clamp(torch.mean(d2[:, 1:], dim=-1), min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    rots = torch.zeros((n, 4), dtype=torch.float32, device=points.device)
    rots[:, 0] = 1.0
    opacities = inverse_sigmoid(
        0.1 * torch.ones((n, 1), dtype=torch.float32, device=points.device))
    n_rest = (sh_degree + 1) ** 2 - 1
    return GaussianParams(
        xyz=points.to(torch.float32).clone(),
        features_dc=rgb_to_sh(colors.to(torch.float32))[:, None, :],
        features_rest=torch.zeros((n, n_rest, 3), dtype=torch.float32,
                                  device=points.device),
        scaling=scales.to(torch.float32),
        rotation=rots,
        opacity=opacities)
