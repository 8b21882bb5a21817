"""3D Gaussian parameters.

Port of ``animatablegaussians_tpu/models/gaussian_model.py:37-95``: raw
parameters live in log/logit space; activations are exp (scale), sigmoid
(opacity) and L2-normalize (rotation). ``create_from_pcd`` sets scales from
the mean squared distance to the 3 nearest neighbours (KNN with k=4,
including the point itself) and opacity at 0.1. PLY save and load
(``animatablegaussians_tpu/models/gaussian_model.py:103-146``) follow the
standard 3DGS attribute layout (ref: gaussians/obj_io.py:24-99) in numpy.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from animatablegaussians_torch.ops.knn import knn
from animatablegaussians_torch.ops.quat import normalize as quat_normalize
from animatablegaussians_torch.ops.sh import rgb_to_sh, sh_to_rgb
from animatablegaussians_torch.utils import ply as ply_io


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

    @property
    def get_xyz(self):
        return self.xyz

    @property
    def get_features(self):
        """(N, (deg+1)^2, 3) SH coefficients: DC, then the rest."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    @property
    def num_points(self) -> int:
        return self.xyz.shape[0]


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


# ---------------------------------------------------------------------------
# PLY I/O: activated values re-encoded to the raw 3DGS layout, as in the
# reference (ref: gaussians/obj_io.py:24-99)
# ---------------------------------------------------------------------------

def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def save_gaussians_as_ply(path: str, gaussian_vals: dict) -> None:
    """``gaussian_vals``: activated positions, opacity, scales, rotations
    and colours (RGB), tensors or arrays, re-encoded into a raw-space 3DGS
    PLY (zero normals, SH DC only)."""
    pos = _np(gaussian_vals["positions"])
    n = pos.shape[0]
    opac = np.clip(_np(gaussian_vals["opacity"]).reshape(n, 1), 1e-6,
                   1.0 - 1e-6)
    scales = _np(gaussian_vals["scales"]).reshape(n, 3)
    rots = _np(gaussian_vals["rotations"]).reshape(n, 4)
    colors = _np(gaussian_vals["colors"]).reshape(n, 3)

    props = {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2]}
    for k in ("nx", "ny", "nz"):
        props[k] = np.zeros(n, np.float32)
    f_dc = rgb_to_sh(colors)
    for i in range(3):
        props[f"f_dc_{i}"] = f_dc[:, i]
    props["opacity"] = np.log(opac / (1 - opac))[:, 0]
    log_scales = np.log(np.maximum(scales, 1e-10))
    for i in range(3):
        props[f"scale_{i}"] = log_scales[:, i]
    for i in range(4):
        props[f"rot_{i}"] = rots[:, i]
    ply_io.write_ply(path, {k: v.astype(np.float32)
                            for k, v in props.items()})


def load_gaussians_from_ply(path: str) -> dict:
    """A 3DGS PLY back to an activated dict of numpy arrays
    (ref: obj_io.py:49-99)."""
    verts, _ = ply_io.read_ply(path)
    pos = np.stack([verts["x"], verts["y"], verts["z"]], axis=1)
    f_dc = np.stack([verts[f"f_dc_{i}"] for i in range(3)], axis=1)
    opac = 1.0 / (1.0 + np.exp(-verts["opacity"]))
    scales = np.exp(np.stack([verts[f"scale_{i}"] for i in range(3)], axis=1))
    rots = np.stack([verts[f"rot_{i}"] for i in range(4)], axis=1)
    rots = rots / np.linalg.norm(rots, axis=1, keepdims=True)
    return dict(positions=pos, colors=sh_to_rgb(f_dc), opacity=opac[:, None],
                scales=scales, rotations=rots, max_sh_degree=0)
