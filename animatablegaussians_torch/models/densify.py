"""3DGS densification: clone, split, prune and the opacity reset, and the
Adam state surgery that follows each of them.

Port of ``animatablegaussians_tpu/models/densify.py`` (ref:
gaussians/gaussian_model.py:294-443). Each function takes a
``GaussianParams`` and returns a new one with the JAX package's row order:
the rows it keeps, in their order, then the rows it appends. The two that
drop rows, ``densify_and_split`` and ``prune``, with ``return_kept=True``
also return the (N_old,) bool mask of the kept rows, the reference's
``valid_points_mask``; the appended rows are the last
``N_new - kept.sum()``. ``densify_and_clone`` and ``reset_opacity`` keep
every row, which ``grow_adam_state(kept=None)`` means.

``grow_adam_state`` is the reference's ``_prune_optimizer`` and
``cat_tensors_to_optimizer`` (gaussian_model.py:294-341) for a
``torch.optim.Adam``: a kept row keeps its own moments in its new
position, an appended row starts at zero, a dropped row's moments go, and
``step`` is kept. The JAX package's ``grow_adam_state`` pads zeros at the
end of each leaf instead, which is right only for a clone: after a split
it gives the kept rows other rows' moments, and after a prune it raises.

The selections sync the host once each (``torch.nonzero``); everything
else runs on the device of the parameters.
"""

from __future__ import annotations

import torch

from animatablegaussians_torch.models.gaussian_model import (GaussianParams,
                                                             inverse_sigmoid)
from animatablegaussians_torch.ops.quat import normalize, quat_to_mat

FIELDS = GaussianParams.FIELDS


def _rows(g: GaussianParams, idx: torch.Tensor | None = None) -> dict:
    """Each field's rows ``idx`` (all of them for None), without autograd."""
    return {f: getattr(g, f).detach() if idx is None
            else getattr(g, f).detach()[idx] for f in FIELDS}


def _cat(a: dict, b: dict) -> GaussianParams:
    return GaussianParams(**{f: torch.cat([a[f], b[f]], 0) for f in FIELDS})


@torch.no_grad()
def densify_and_clone(g: GaussianParams, grad_norms: torch.Tensor,
                      grad_threshold: float, scene_extent: float,
                      percent_dense: float = 0.01) -> GaussianParams:
    """Append a copy of each small Gaussian whose view-space gradient norm
    reaches ``grad_threshold`` (ref: gaussian_model.py:383-395)."""
    small = torch.max(g.get_scaling, dim=1).values \
        <= percent_dense * scene_extent
    sel = torch.nonzero((grad_norms >= grad_threshold) & small)[:, 0]
    return _cat(_rows(g), _rows(g, sel))


@torch.no_grad()
def densify_and_split(g: GaussianParams, grad_norms: torch.Tensor,
                      grad_threshold: float, scene_extent: float,
                      n_split: int = 2, percent_dense: float = 0.01,
                      generator: torch.Generator | None = None,
                      noise: torch.Tensor | None = None,
                      return_kept: bool = False):
    """Replace each large Gaussian whose gradient norm reaches
    ``grad_threshold`` by ``n_split`` samples drawn from it, their scales
    shrunk by 1 / (0.8 n_split) (ref: gaussian_model.py:365-381).

    The (m n_split, 3) standard normals are ``noise`` when given (as JAX's
    ``jax.random.normal(rng, (m * n_split, 3))``), else drawn from
    ``generator``, which lies on the Gaussians' device; the default is a
    generator there seeded 0, as JAX's default is ``PRNGKey(0)``."""
    big = torch.max(g.get_scaling, dim=1).values \
        > percent_dense * scene_extent
    chosen = (grad_norms >= grad_threshold) & big
    sel = torch.nonzero(chosen)[:, 0]
    picked = _rows(g, sel)
    m = sel.shape[0]
    stds = torch.exp(picked["scaling"]).repeat_interleave(n_split, dim=0)
    if noise is None:
        if generator is None:
            generator = torch.Generator(device=stds.device).manual_seed(0)
        noise = torch.randn(stds.shape, generator=generator,
                            device=stds.device)
    if tuple(noise.shape) != (m * n_split, 3):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, the split "
                         f"needs ({m * n_split}, 3)")
    samples = stds * noise.to(stds.device)
    rots = quat_to_mat(normalize(picked["rotation"]).repeat_interleave(
        n_split, dim=0))
    rep = {f: v.repeat_interleave(n_split, dim=0) for f, v in picked.items()}
    rep["xyz"] = torch.einsum("nij,nj->ni", rots, samples) + rep["xyz"]
    rep["scaling"] = torch.log(stds / (0.8 * n_split))
    kept = ~chosen
    keep = torch.nonzero(kept)[:, 0]
    new = _cat(_rows(g, keep), rep)
    return (new, kept) if return_kept else new


@torch.no_grad()
def prune(g: GaussianParams, min_opacity: float = 0.005,
          scene_extent: float | None = None,
          max_screen_size: float | None = None,
          radii: torch.Tensor | None = None, return_kept: bool = False):
    """Drop the Gaussians under ``min_opacity`` and, given
    ``max_screen_size`` and ``radii``, those wider on screen, and with
    ``scene_extent`` too, those wider than 0.1 of it in the world
    (ref: gaussian_model.py:397-407)."""
    drop = g.get_opacity[:, 0] < min_opacity
    if max_screen_size is not None and radii is not None:
        drop = drop | (radii > max_screen_size)
        if scene_extent is not None:
            drop = drop | (torch.max(g.get_scaling, dim=1).values
                           > 0.1 * scene_extent)
    kept = ~drop
    new = GaussianParams(**_rows(g, torch.nonzero(kept)[:, 0]))
    return (new, kept) if return_kept else new


@torch.no_grad()
def reset_opacity(g: GaussianParams,
                  ceiling: float = 0.01) -> GaussianParams:
    """Clamp the opacities down to at most ``ceiling``
    (ref: gaussian_model.py:216-220). The reference also zeroes the
    opacity's Adam moments there (``replace_tensor_to_optimizer``):
    ``grow_adam_state(..., reset=("opacity",))``."""
    rows = {f: v.clone() for f, v in _rows(g).items()}
    rows["opacity"] = inverse_sigmoid(
        torch.clamp(g.get_opacity, max=ceiling))
    return GaussianParams(**rows)


@torch.no_grad()
def grow_adam_state(optimizer: torch.optim.Optimizer, old: GaussianParams,
                    new: GaussianParams, kept: torch.Tensor | None = None,
                    reset=()) -> None:
    """Rebind ``optimizer`` from ``old``'s parameters to ``new``'s, and move
    each parameter's moments with its rows: ``new``'s first ``kept.sum()``
    rows are ``old``'s kept rows in order and take their moments, the rest
    are appended and start at zero; ``step`` is kept. ``kept`` None means
    every old row is kept (append-only growth, as a clone). The fields in
    ``reset`` start at zero moments whatever their rows (the reference's
    ``replace_tensor_to_optimizer``, as its opacity reset does)."""
    n_old, n_new = old.num_points, new.num_points
    if kept is None:
        kept = torch.ones(n_old, dtype=torch.bool, device=old.xyz.device)
    if tuple(kept.shape) != (n_old,):
        raise ValueError(f"kept has shape {tuple(kept.shape)} for {n_old} "
                         "old rows")
    keep = torch.nonzero(kept)[:, 0]
    n_kept = keep.shape[0]
    if n_kept > n_new:
        raise ValueError(f"{n_kept} kept rows do not fit in {n_new} new "
                         "rows; pass the mask of the rows that were kept")
    swap = {id(getattr(old, f)): getattr(new, f) for f in FIELDS}
    for group in optimizer.param_groups:
        group["params"] = [swap.get(id(p), p) for p in group["params"]]
    for f in FIELDS:
        p_old, p_new = getattr(old, f), getattr(new, f)
        state = optimizer.state.pop(p_old, None)
        if state is None:
            continue
        for k in ("exp_avg", "exp_avg_sq"):
            moved = torch.zeros_like(p_new)
            if f not in reset:
                moved[:n_kept] = state[k][keep.to(state[k].device)]
            state[k] = moved
        optimizer.state[p_new] = state
