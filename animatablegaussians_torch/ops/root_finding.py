"""Newton-iteration inverse LBS ("root finding"), a port of
``animatablegaussians_tpu/ops/root_finding.py`` (ref:
utils/root_finding/root_finding.cu:43-154, a CUDA extension in the
reference; plain PyTorch here, as plain ``jnp`` there).

For each live point xt, solve fwd(xc) = xt for the canonical point xc:

    xc <- xc - clip((J1 + lambda J2)^-1 (fwd(xc) - xt), +-0.01)

with fwd(xc) = sum_j w_j(xc) (R_j xc + t_j), J1 = sum_j w_j R_j and
J2 = sum_j (R_j xc + t_j) outer grad w_j(xc): the weights sampled
trilinearly from the weight volume, their gradients from the nearest voxel
of the Sobel gradient volume. Ten iterations of batched (N, J) einsums and
a batched 3x3 ``torch.linalg.solve_ex``, under ``torch.no_grad()``: the
inputs depend on no parameter. ``solve_ex`` leaves the LU's status on the
device (``torch.linalg.solve`` reads it on the host after each solve, a
wait for the device in every iteration); a singular system gives
non-finite values, as the reference's CUDA solve does. One ``root_finding`` span a call (arg
``points``); the counter ``root_finding.points`` adds the call's points.
"""

from __future__ import annotations

import torch

from animatablegaussians_torch.ops.grid_sample import (
    sample_volume_nearest, sample_volume_trilinear)
from animatablegaussians_torch.utils.profiling import count, span


@torch.no_grad()
def root_finding(weight_volume: torch.Tensor,   # (X, Y, Z, J)
                 grad_volume: torch.Tensor,     # (X, Y, Z, J*3)
                 xt: torch.Tensor,              # (N, 3) live points
                 xc_init: torch.Tensor,         # (N, 3) canonical guess
                 jnt_mats: torch.Tensor,        # (J, 4, 4) cano -> live
                 bounds: torch.Tensor,          # (2, 3) volume bounds
                 lam: float = 0.1,
                 iter_num: int = 10) -> torch.Tensor:
    J = weight_volume.shape[-1]
    count("root_finding.points", xt.shape[0])
    with span("root_finding") as sp:
        sp.set(points=xt.shape[0])
        R = jnt_mats[:, :3, :3]
        t = jnt_mats[:, :3, 3]
        lo, hi = bounds[0], bounds[1]
        extent = hi - lo
        xc = xc_init
        for _ in range(iter_num):
            p = (xc - lo) / extent
            w = sample_volume_trilinear(weight_volume, p)        # (N, J)
            g = sample_volume_nearest(grad_volume, p).reshape(-1, J, 3)

            fwd_sep = torch.einsum("jxy,ny->njx", R, xc) + t[None]
            fwd = torch.einsum("nj,njx->nx", w, fwd_sep)         # (N, 3)
            J1 = torch.einsum("nj,jxy->nxy", w, R)               # (N, 3, 3)
            J2 = torch.einsum("njx,njy->nxy", fwd_sep, g)

            update, _ = torch.linalg.solve_ex(J1 + lam * J2,
                                              (fwd - xt)[..., None])
            xc = xc - torch.clamp(update[..., 0], -0.01, 0.01)
        return xc
