"""The port's GaussianParams accessors, densification (models/densify.py)
and its Adam surgery against the JAX package on the CPU. The surgery
after a split or a prune is held to a numpy statement of the reference's
``_prune_optimizer`` / ``cat_tensors_to_optimizer``, since the JAX
package's ``grow_adam_state`` only pads at the end. Last, the generic 3DGS
layer's drive (``gs3d_drive``: an SH render, an Adam step, a densification
round with its surgery, steps at the new N), on the CPU at a small size
and, marked ``gpu`` (skipped without a CUDA device), on the card at the
full-width fixture's 531,520 posed Gaussians and 1500x2048 against
``plain=True`` and against the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from animatablegaussians_tpu.models import densify as jden
from animatablegaussians_tpu.models import gaussian_model as jgm
from animatablegaussians_torch.models import densify as tden
from animatablegaussians_torch.models import gaussian_model as tgm
from animatablegaussians_torch.utils import convert
from on_card import (ATOL_BLEND, card, full_width, kernels,  # noqa: F401
                     launches, reset_launches, splat_inputs)

FIELDS = tgm.GaussianParams.FIELDS


def _close(got, want, rtol=1e-6, atol=1e-6, err_msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _jax_params(n=40, seed=0, sh_degree=3, scale_range=(-7.0, -3.5)):
    """A JAX GaussianParams with numpy-seeded raw fields: log-scales over
    ``scale_range``, raw (unnormalised) quaternions, opacities around the
    prune's limit."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    n_rest = (sh_degree + 1) ** 2 - 1
    return jgm.GaussianParams(
        xyz=jnp.asarray(f(n, 3)),
        features_dc=jnp.asarray(f(n, 1, 3)),
        features_rest=jnp.asarray(0.1 * f(n, n_rest, 3)),
        scaling=jnp.asarray(rng.uniform(*scale_range, (n, 3)).astype(
            np.float32)),
        rotation=jnp.asarray(f(n, 4)),
        opacity=jnp.asarray(rng.uniform(-7.0, 0.0, (n, 1)).astype(
            np.float32)))


def _np_fields(g) -> dict:
    return {k: np.asarray(v) for k, v in dataclasses.asdict(g).items()}


def _assert_params(got, want, err_msg=""):
    """Port GaussianParams against a JAX one: row counts equal, each field
    within 1e-6 (float32 exp, log and the rotation in two frameworks)."""
    assert got.num_points == want.num_points, err_msg
    for f in FIELDS:
        _close(getattr(got, f), getattr(want, f), err_msg=f"{err_msg} {f}")


def test_gaussian_params_accessors_match_jax():
    jg = _jax_params(seed=1)
    g = convert.gaussian_params_from_jax(jax.tree.map(np.asarray, jg))
    assert g.num_points == jg.num_points == 40
    assert g.get_xyz is g.xyz
    np.testing.assert_array_equal(g.get_features.detach().numpy(),
                                  np.asarray(jg.get_features))
    assert g.get_features.shape == (40, 16, 3)
    for name in ("get_scaling", "get_rotation", "get_opacity"):
        _close(getattr(g, name), getattr(jg, name), err_msg=name)


# ---------------------------------------------------------------------------
# densification
# ---------------------------------------------------------------------------

# extent 1 with percent_dense 0.01: log-scales over (-7, -3.5) put the max
# scale on both sides of 0.01; a threshold at the norms' median selects
# half the rows
EXTENT, N_SPLIT = 1.0, 2


# every densify and surgery test draws the same rows, so that the JAX
# functions' eager operations meet the same shapes and compile once
N, SEED = 40, 2


def _norms():
    return np.random.default_rng(SEED + 100).uniform(0, 1, N).astype(
        np.float32)


def _radii():
    return np.random.default_rng(SEED + 200).integers(0, 40, N).astype(
        np.int32)


def _run_densify(case, jg, g, norms, radii):
    """(JAX result, port result, port kept mask) of one densify case; the
    clone and the opacity reset keep every row and return no mask."""
    every = torch.ones(g.num_points, dtype=torch.bool)
    jn, tn = jnp.asarray(norms), torch.as_tensor(norms)
    thr = float(np.median(norms))
    if case == "clone":
        want = jden.densify_and_clone(jg, jn, thr, EXTENT)
        got, kept = tden.densify_and_clone(g, tn, thr, EXTENT), every
    elif case == "split":
        key = jax.random.PRNGKey(7)
        want = jden.densify_and_split(jg, jn, thr, EXTENT, n_split=N_SPLIT,
                                      rng=key)
        m = (want.num_points - jg.num_points) // (N_SPLIT - 1)
        noise = np.array(jax.random.normal(key, (m * N_SPLIT, 3)))
        got, kept = tden.densify_and_split(g, tn, thr, EXTENT,
                                           n_split=N_SPLIT,
                                           noise=torch.as_tensor(noise),
                                           return_kept=True)
    elif case.startswith("prune"):
        kw = {}
        if case != "prune":
            kw = dict(max_screen_size=20.0)
            if case == "prune_screen_extent":
                kw["scene_extent"] = 0.2
        want = jden.prune(jg, 0.005, radii=jnp.asarray(radii), **kw)
        got, kept = tden.prune(g, 0.005, radii=torch.as_tensor(radii),
                               return_kept=True, **kw)
    else:
        want = jden.reset_opacity(jg)
        got, kept = tden.reset_opacity(g), every
    return want, got, kept


@pytest.mark.parametrize("case", ["clone", "split", "prune", "prune_screen",
                                  "prune_screen_extent", "reset_opacity"])
def test_densify_matches_jax(case):
    """clone, split (fed JAX's normal draws), prune (opacity; with radii
    and max_screen_size; with scene_extent too) and reset_opacity against
    the JAX functions; the kept mask and the rows appended after the kept
    ones."""
    jg = _jax_params(n=N, seed=SEED)
    g = convert.gaussian_params_from_jax(jax.tree.map(np.asarray, jg))
    norms, radii = _norms(), _radii()
    want, got, kept = _run_densify(case, jg, g, norms, radii)
    _assert_params(got, want, case)
    n_kept = int(kept.sum())
    assert kept.shape == (N,) and got.num_points >= n_kept
    for f in FIELDS:   # the kept rows come first, in their order
        old = getattr(g, f).detach()[kept]
        if case != "reset_opacity" or f != "opacity":
            assert torch.equal(getattr(got, f).detach()[:n_kept], old)
    if case == "clone":
        assert bool(kept.all()) and got.num_points > N
    elif case == "split":
        assert 0 < n_kept < N
        assert got.num_points == n_kept + N_SPLIT * (N - n_kept)
    elif case.startswith("prune"):
        assert 0 < n_kept < N and got.num_points == n_kept
    else:
        assert bool(kept.all())
        assert float(got.get_opacity.max().detach()) <= 0.01 + 1e-7


# ---------------------------------------------------------------------------
# the Adam surgery
# ---------------------------------------------------------------------------

LR = 1e-2


def _adam_pair():
    """(JAX params, optax adam, its state, port params, torch Adam with
    the same state) after one update with seeded gradients, so that
    every moment is nonzero."""
    jg = _jax_params(n=N, seed=SEED)
    opt = optax.adam(LR)
    state = opt.init(jg)
    rng = np.random.default_rng(SEED)
    grads = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
        x.shape).astype(np.float32)), jg)
    upd, state = jax.jit(opt.update)(grads, state, jg)
    jg = optax.apply_updates(jg, upd)
    g = convert.gaussian_params_from_jax(jax.tree.map(np.asarray, jg))
    topt = torch.optim.Adam(g.parameters(), lr=LR)
    adam = state[0]
    convert.adam_state_from_optax(topt, g, int(adam.count),
                                  jax.tree.map(np.asarray, adam.mu),
                                  jax.tree.map(np.asarray, adam.nu))
    return jg, opt, state, g, topt


@pytest.mark.parametrize("mask", [False, True])
def test_surgery_after_clone_matches_optax(mask):
    """After a clone, the port's surgery (with the kept mask, or without:
    append-only growth) equals optax's mu / nu after JAX's grow_adam_state
    bit for bit, and one further Adam step matches optax's."""
    jg, opt, state, g, topt = _adam_pair()
    norms = _norms()
    thr = float(np.median(norms))
    jg2 = jden.densify_and_clone(jg, jnp.asarray(norms), thr, EXTENT)
    state2 = jden.grow_adam_state(state, jg, jg2)
    g2 = tden.densify_and_clone(g, torch.as_tensor(norms), thr, EXTENT)
    kept = torch.ones(N, dtype=torch.bool) if mask else None
    tden.grow_adam_state(topt, g, g2, kept)
    assert g2.num_points == jg2.num_points > N
    for f in FIELDS:
        st = topt.state[getattr(g2, f)]
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      np.asarray(getattr(state2[0].mu, f)))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      np.asarray(getattr(state2[0].nu, f)))
        assert float(st["step"]) == 1.0
    rng = np.random.default_rng(11)
    grads = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
        x.shape).astype(np.float32)), jg2)
    upd, state3 = jax.jit(opt.update)(grads, state2, jg2)
    jg3 = optax.apply_updates(jg2, upd)
    for f in FIELDS:
        getattr(g2, f).grad = torch.as_tensor(np.array(getattr(grads, f)))
    topt.step()
    _assert_params(g2, jg3, "after the step")
    for f in FIELDS:   # the same moments; the two round lerp apart
        st = topt.state[getattr(g2, f)]
        _close(st["exp_avg"], getattr(state3[0].mu, f), err_msg=f)
        _close(st["exp_avg_sq"], getattr(state3[0].nu, f), err_msg=f)


def _reference_moments(old: np.ndarray, kept: np.ndarray, n_new: int,
                       reset: bool = False) -> np.ndarray:
    """The reference's surgery (gaussians/gaussian_model.py:294-341) in
    numpy: _prune_optimizer keeps the moments of the rows kept, in order;
    cat_tensors_to_optimizer appends zeros for the new rows; the opacity
    reset's replace_tensor_to_optimizer zeroes them all."""
    kept_rows = old[kept]
    tail = np.zeros((n_new - kept_rows.shape[0],) + old.shape[1:],
                    old.dtype)
    out = np.concatenate([kept_rows, tail])
    return np.zeros_like(out) if reset else out


@pytest.mark.parametrize("case", ["split", "prune", "reset_opacity"])
def test_surgery_matches_reference(case):
    """After a split, a prune and an opacity reset, the port's moments are
    the reference's: each kept row's own, zeros for the appended rows (and
    for the reset field), step kept. The kept mask is recomputed here in
    numpy from the selection rules. JAX's grow_adam_state differs: after
    the split its kept rows read other rows' moments, and after the prune
    it raises."""
    jg, opt, state, g, topt = _adam_pair()
    norms, radii = _norms(), _radii()
    thr = float(np.median(norms))
    p = _np_fields(jg)
    max_scale = np.exp(p["scaling"]).max(axis=1)
    before = {f: {k: v.clone() for k, v in topt.state[getattr(g, f)].items()}
              for f in FIELDS}
    reset = ()
    if case == "split":
        want_kept = ~((norms >= thr) & (max_scale > 0.01 * EXTENT))
        g2, kept = tden.densify_and_split(g, torch.as_tensor(norms), thr,
                                          EXTENT, return_kept=True)
        jg2 = jden.densify_and_split(jg, jnp.asarray(norms), thr, EXTENT)
        jstate = jden.grow_adam_state(state, jg, jg2)
        n_kept = int(want_kept.sum())
        assert not np.array_equal(np.asarray(jstate[0].mu.xyz)[:n_kept],
                                  before["xyz"]["exp_avg"].numpy()[want_kept])
    elif case == "prune":
        opac = 1.0 / (1.0 + np.exp(-p["opacity"][:, 0]))
        want_kept = ~((opac < 0.005) | (radii > 20))
        g2, kept = tden.prune(g, 0.005, max_screen_size=20,
                              radii=torch.as_tensor(radii),
                              return_kept=True)
        jg2 = jden.prune(jg, 0.005, max_screen_size=20,
                         radii=jnp.asarray(radii))
        with pytest.raises(TypeError):
            jden.grow_adam_state(state, jg, jg2)
    else:
        want_kept = np.ones(N, bool)
        g2, kept = tden.reset_opacity(g), None    # every row kept
        reset = ("opacity",)
    if kept is not None:
        np.testing.assert_array_equal(kept.numpy(), want_kept)
    assert 0 < int(want_kept.sum()) <= N
    tden.grow_adam_state(topt, g, g2, kept, reset=reset)
    held = [p for grp in topt.param_groups for p in grp["params"]]
    assert [id(p) for p in held] == [id(getattr(g2, f)) for f in FIELDS]
    assert not any(getattr(g, f) in topt.state for f in FIELDS)
    for f in FIELDS:
        st = topt.state[getattr(g2, f)]
        for k in ("exp_avg", "exp_avg_sq"):
            want = _reference_moments(before[f][k].numpy(), want_kept,
                                      g2.num_points, reset=f in reset)
            np.testing.assert_array_equal(st[k].numpy(), want,
                                          err_msg=f"{f} {k}")
        assert float(st["step"]) == float(before[f]["step"])
    # the optimizer steps at the new row count
    for f in FIELDS:
        getattr(g2, f).grad = torch.ones_like(getattr(g2, f))
    topt.step()
    assert all(torch.isfinite(getattr(g2, f)).all() for f in FIELDS)


def test_split_draws_on_the_gaussians_device_by_default():
    """Without ``noise`` or ``generator`` the split draws its normals from
    a generator on the Gaussians' device seeded 0; a caller's generator is
    used as given."""
    g = convert.gaussian_params_from_jax(jax.tree.map(
        np.asarray, _jax_params(n=N, seed=SEED)))
    norms = torch.as_tensor(_norms())
    thr = float(norms.median())
    got, kept = tden.densify_and_split(g, norms, thr, EXTENT,
                                       return_kept=True)
    m = N - int(kept.sum())
    assert m > 0
    for seed in (0, 5):
        noise = torch.randn((m * N_SPLIT, 3),
                            generator=torch.Generator().manual_seed(seed))
        want = tden.densify_and_split(g, norms, thr, EXTENT, noise=noise)
        if seed:
            got = tden.densify_and_split(
                g, norms, thr, EXTENT,
                generator=torch.Generator().manual_seed(seed))
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), (seed, f)


def test_surgery_refuses_a_mask_that_does_not_fit():
    _, _, _, g, topt = _adam_pair()
    g2 = tden.prune(g, 0.5)
    with pytest.raises(ValueError):
        tden.grow_adam_state(topt, g, g2)           # no mask, fewer rows
    with pytest.raises(ValueError):
        tden.grow_adam_state(topt, g, g2, torch.ones(7, dtype=torch.bool))


# ---------------------------------------------------------------------------
# the generic 3DGS layer's drive, on the CPU and on the card
# ---------------------------------------------------------------------------

# SH degree 3, the 3DGS default (16 coefficients a channel): the DC term
# from the seeded colours, the rest N(0, GS_REST_STD) from a seeded
# generator. The fixture's create_from_pcd scales are the same on the three
# axes, where a rotation moves nothing and its gradient is rounding noise
# (kernel and plain read 0.80 apart in relative L2 on the H100);
# N(0, GS_SCALE_JITTER) added to each log-scale makes the Gaussians
# anisotropic, as a fitted scene's are
GS_SH_DEGREE, GS_REST_STD, GS_SCALE_JITTER, GS_SEED = 3, 0.1, 0.2, 21
# Adam with the 3DGS reference's learning rates and eps (ref:
# arguments/__init__.py OptimizationParams, gaussian_model.py
# training_setup): position 0.00016 times the scene extent (set per run),
# the DC term 0.0025, the rest 0.0025 / 20, opacity 0.05, scaling 0.005,
# rotation 0.001
GS_LR = dict(features_dc=2.5e-3, features_rest=2.5e-3 / 20, opacity=0.05,
             scaling=5e-3, rotation=1e-3)
GS_XYZ_LR, GS_EPS = 1.6e-4, 1e-15
# the densification round: the gradient threshold is this quantile of the
# visible Gaussians' view-space gradient norms, lowered to the median norm
# of the visible large ones (max scale > GS_PERCENT_DENSE x the extent), and
# of the small ones, where that is lower, so that both the split and the
# clone select rows (the fixture has few large Gaussians: by a k-d tree's
# distances, 8 of its 517,832 at 1024^2); the prune's limits (the
# reference's defaults: min opacity 0.005, 20 pixels on screen)
GS_GRAD_QUANTILE, GS_PERCENT_DENSE = 0.9, 0.01
GS_MIN_OPACITY, GS_MAX_SCREEN, GS_SPLIT_SEED = 0.005, 20, 22
# samples a split Gaussian becomes (the reference's N = 2)
GS_N_SPLIT = 2
# the card against the CPU on the same inputs, each value relative to the
# largest magnitude of its field (floor 1): the round's fields pass
# through exp and log (scaling) and sigmoid and its inverse (opacity),
# whose last bits the two devices' libm round apart; the SH colours (the
# norms of the directions, summed in another order)
GS_RTOL_ROUND, GS_ATOL_SH = 1e-6, 1e-6
# the gradients, kernel path against plain path, relative L2 per field. No
# CNN is on this path (on_card.RTOL_GRAD's events do not occur): only the
# backward kernel's atomics and the plain version's scan order set the two
# apart. On the H100 the fields read 1.2e-7 to 1.4e-6, at 531,520 and
# 790,332 Gaussians; this limit keeps two orders of magnitude above that
# and still fails a fault of 0.01% in any field's gradient
GS_RTOL_GRAD = 1e-4
# kernel launches of the drive on the card: the SH render and the colors=
# render (a), the kernel step (b), and the steps after the prune and after
# the reset (d)
GS_LAUNCHES = dict(expand_pairs=5, blend_tiles=5, blend_backward=3,
                   upfirdn2d_fir=0)


def gs3d_inputs(net, items) -> dict:
    """The drive's scene, on the CPU: the fixture's posed Gaussians and
    seeded colours (``on_card.splat_inputs``), the raw canonical scaling
    and opacity they carry, the pad mask and the camera."""
    with torch.no_grad():
        means3d, _, rots, _, colors = splat_inputs(net, items)
        g = net.cano_gaussian
        base = dict(xyz=means3d, rotation=rots, colors=colors,
                    scaling=g.scaling, opacity=g.opacity, valid=net.valid,
                    extr=items["extr"], intr=items["intr"])
        return {k: v.detach().cpu() for k, v in base.items()}


def gs3d_scene(base: dict, dev):
    """A 3DGS ``GaussianParams`` on ``dev`` from ``gs3d_inputs``: SH degree
    ``GS_SH_DEGREE``, the DC term ``rgb_to_sh`` of the colours, the rest
    seeded normals; the log-scales jittered by ``GS_SCALE_JITTER``."""
    from animatablegaussians_torch.ops.sh import rgb_to_sh
    n = base["xyz"].shape[0]
    gen = torch.Generator(device=dev).manual_seed(GS_SEED)
    rest = GS_REST_STD * torch.randn((n, (GS_SH_DEGREE + 1) ** 2 - 1, 3),
                                     generator=gen, device=dev)
    jitter = GS_SCALE_JITTER * torch.randn((n, 3), generator=gen,
                                           device=dev)
    to = lambda k: base[k].to(dev).clone()  # noqa: E731
    return tgm.GaussianParams(
        xyz=to("xyz"), features_dc=rgb_to_sh(to("colors"))[:, None, :],
        features_rest=rest, scaling=to("scaling") + jitter,
        rotation=to("rotation"), opacity=to("opacity"))


def gs3d_render(scene, valid, cam, img_w: int, img_h: int, plain=False,
                colors=None) -> dict:
    """``render`` of the scene: its SH colours, or ``colors``."""
    from animatablegaussians_torch.ops.rasterize.api import render
    bg = torch.ones(3, device=scene.xyz.device)
    return render(scene.get_xyz, scene.get_scaling, scene.get_rotation,
                  scene.get_opacity, colors, bg, cam["extr"], cam["intr"],
                  img_w, img_h, valid_mask=valid, plain=plain,
                  shs=None if colors is not None else scene.get_features,
                  max_sh_degree=GS_SH_DEGREE)


def gs3d_step(scene, valid, cam, img_w: int, img_h: int, cots,
              plain=False):
    """(output, gradients of each field, view-space gradient norms) of
    one backward of the image, depth and mask against the cotangents
    ``cots``; the gradients stay in the fields' ``.grad``."""
    scene.zero_grad(set_to_none=True)
    out = gs3d_render(scene, valid, cam, img_w, img_h, plain=plain)
    out["means2d"].retain_grad()
    loss = sum((out[k] * c).sum()
               for k, c in zip(("render", "depth", "mask"), cots))
    loss.backward()
    grads = {f: getattr(scene, f).grad.clone() for f in scene.FIELDS}
    return out, grads, out["means2d"].grad.norm(dim=-1)


def gs3d_compare(out_k, out_p, grads_k=None, grads_p=None) -> dict:
    """Kernel path against plain path: the images at ``ATOL_BLEND``, each
    field's gradient (relative L2) at ``GS_RTOL_GRAD``; raises beyond."""
    errs = {n: float((out_k[k] - out_p[k]).detach().abs().max())
            for n, k in (("color", "render"), ("depth", "depth"),
                         ("alpha", "mask"))}
    bad = {n: e for n, e in errs.items() if not e <= ATOL_BLEND[n]}
    if bad or out_k["n_pairs"] != out_p["n_pairs"]:
        raise AssertionError(f"gs3d: kernel path disagrees with plain: "
                             f"{errs}, n_pairs {out_k['n_pairs']} vs "
                             f"{out_p['n_pairs']}")
    for f, g in (grads_p or {}).items():
        errs[f] = float((grads_k[f] - g).norm() / g.norm())
    bad = {f: e for f, e in errs.items()
           if f not in ATOL_BLEND and not e <= GS_RTOL_GRAD}
    if bad:
        raise AssertionError(f"gs3d: gradients apart beyond "
                             f"{GS_RTOL_GRAD:g}: {errs}")
    return errs


def gs3d_optimizer(scene, extent: float):
    return torch.optim.Adam(
        [{"params": [getattr(scene, f)],
          "lr": GS_XYZ_LR * extent if f == "xyz" else GS_LR[f]}
         for f in scene.FIELDS], eps=GS_EPS)


def follow(x, kept, n_new: int, fill):
    """Per-row values ``x`` of the old rows on the new rows: the kept rows'
    in order, then ``fill`` on the appended rows."""
    x = x[kept]
    tail = torch.full((n_new - x.shape[0],) + tuple(x.shape[1:]), fill,
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, tail])


def check_surgery(opt, old, new, kept, before: dict, reset=()) -> None:
    """After ``grow_adam_state``: ``opt`` holds ``new``'s parameters and
    none of ``old``'s; a kept row's moments are bit for bit its old ones,
    an appended row's are zero (every row's for a field in ``reset``), and
    each ``step`` is the one before."""
    held = {id(p) for grp in opt.param_groups for p in grp["params"]}
    for f in new.FIELDS:
        p_new = getattr(new, f)
        if id(p_new) not in held or id(getattr(old, f)) in held:
            raise AssertionError(f"surgery: {f} not rebound")
        st, was = opt.state[p_new], before[f]
        n_kept = int(kept.sum())
        for k in ("exp_avg", "exp_avg_sq"):
            m = st[k]
            if m.shape != p_new.shape:
                raise AssertionError(f"surgery: {f} {k} {tuple(m.shape)}")
            if f in reset:
                ok = not m.any()
            else:
                ok = (torch.equal(m[:n_kept], was[k][kept])
                      and not m[n_kept:].any())
            if not ok:
                raise AssertionError(f"surgery: {f} {k} moments misplaced")
        if not torch.equal(st["step"], was["step"]):
            raise AssertionError(f"surgery: {f} step {st['step']} "
                                 f"against {was['step']}")


def split_noise(scene, norms, thr: float, extent: float, gen) -> torch.Tensor:
    """The split's (m n_split, 3) standard normals for the rows that
    ``densify_and_split`` selects (gradient norm at ``thr`` or above and
    max scale above ``GS_PERCENT_DENSE`` x ``extent``), drawn from the CPU
    generator ``gen`` and copied to the scene's device, so that the card
    and the CPU split alike."""
    big = torch.max(scene.get_scaling, dim=1).values \
        > GS_PERCENT_DENSE * extent
    m = int(((norms >= thr) & big).sum())
    return torch.randn((m * GS_N_SPLIT, 3), generator=gen).to(
        scene.xyz.device)


def densify_round(scene, norms, radii, valid, thr: float, extent: float,
                  opt=None, max_screen: int = GS_MAX_SCREEN):
    """The drive's densification round: clone, split (its normals from
    ``split_noise`` with a CPU generator seeded ``GS_SPLIT_SEED``), prune
    with ``radii``, ``extent`` and ``max_screen`` pixels, reset_opacity.
    The per-row inputs follow the rows: an appended row has gradient norm
    0 (as the reference pads it), radius 0 (its ``max_radii2D``) and is
    valid (it copies a valid row). With ``opt``, each step's
    ``grow_adam_state`` is checked (``check_surgery``). -> (scene, valid,
    a record per step: N before and after, rows kept and appended, the
    scene and its valid rows after the step)."""
    gen = torch.Generator().manual_seed(GS_SPLIT_SEED)
    rows = dict(norms=norms, radii=radii, valid=valid)
    steps = []
    # each step -> (new scene, kept mask; None where every row is kept)
    plan = (
        ("clone", lambda s, _: (tden.densify_and_clone(
            s, rows["norms"], thr, extent, GS_PERCENT_DENSE), None), ()),
        ("split", lambda s, noise: tden.densify_and_split(
            s, rows["norms"], thr, extent, n_split=GS_N_SPLIT,
            percent_dense=GS_PERCENT_DENSE, noise=noise, return_kept=True),
         ()),
        ("prune", lambda s, _: tden.prune(
            s, GS_MIN_OPACITY, extent, max_screen, rows["radii"],
            return_kept=True), ()),
        ("reset_opacity", lambda s, _: (tden.reset_opacity(s), None),
         ("opacity",)))
    for name, fn, reset in plan:
        noise = (split_noise(scene, rows["norms"], thr, extent, gen)
                 if name == "split" else None)
        new, kept = fn(scene, noise)
        if opt is not None:
            before = {f: dict(opt.state[getattr(scene, f)])
                      for f in scene.FIELDS}
            tden.grow_adam_state(opt, scene, new, kept, reset=reset)
        if kept is None:
            kept = torch.ones(scene.num_points, dtype=torch.bool,
                              device=scene.xyz.device)
        if opt is not None:
            check_surgery(opt, scene, new, kept, before, reset)
        n_new = new.num_points
        rows = dict(norms=follow(rows["norms"], kept, n_new, 0.0),
                    radii=follow(rows["radii"], kept, n_new, 0),
                    valid=follow(rows["valid"], kept, n_new, True))
        n_kept = int(kept.sum())
        steps.append(dict(step=name, n_before=scene.num_points,
                          n_after=n_new, kept=n_kept,
                          appended=n_new - n_kept, scene=new,
                          valid=rows["valid"]))
        scene = new
    return scene, rows["valid"], steps


def gs3d_threshold(scene, norms, radii, extent: float) -> float:
    """``GS_GRAD_QUANTILE`` of the visible Gaussians' gradient norms,
    lowered to the median of the visible large ones' and of the small
    ones' where lower (zero norms left out); raises if either set is
    empty."""
    big = torch.max(scene.get_scaling, dim=1).values \
        > GS_PERCENT_DENSE * extent
    live = (radii > 0) & (norms > 0)
    thr = float(torch.quantile(norms[live], GS_GRAD_QUANTILE))
    for name, sel in (("large", live & big), ("small", live & ~big)):
        if not bool(sel.any()):
            raise AssertionError(f"gs3d: no visible {name} Gaussian with a "
                                 "gradient: the round cannot both clone "
                                 "and split")
        thr = min(thr, float(torch.median(norms[sel])))
    return thr


def gs3d_drive(base: dict, dev, img_w: int, img_h: int,
               max_screen: int = GS_MAX_SCREEN) -> dict:
    """(a) the SH render through the kernels against plain=True and the
    colors= route, SH colours and (e) mark_visible on ``dev`` against the
    CPU; (b) one Adam step's gradients through the kernels against
    plain=True; (c) a densification round on ``dev`` and on the CPU from
    the same parameters, norms, radii and split draws, with (d) the
    surgery after each step, then a step through the kernels against
    plain=True at the new N after the prune and after the reset, and one
    more Adam step. Each check raises on failure; the CPU copies are the
    reference."""
    from animatablegaussians_torch.ops.rasterize.api import (
        mark_visible, precompute_sh_colors)
    scene = gs3d_scene(base, dev)
    valid = base["valid"].to(dev)
    cam = {k: base[k].to(dev) for k in ("extr", "intr")}
    colors = base["colors"].to(dev)
    r = dict(n_points=scene.num_points)

    with torch.no_grad():
        out_k = gs3d_render(scene, valid, cam, img_w, img_h)
        out_p = gs3d_render(scene, valid, cam, img_w, img_h, plain=True)
        out_c = gs3d_render(scene, valid, cam, img_w, img_h, colors=colors)
        r["render_err"] = gs3d_compare(out_k, out_p)
        r["n_pairs"], r["n_pairs_colors"] = out_k["n_pairs"], out_c["n_pairs"]
        if r["n_pairs"] != r["n_pairs_colors"]:
            raise AssertionError(f"gs3d: n_pairs {r['n_pairs']} with SH "
                                 f"against {r['n_pairs_colors']} with colors")
        for k in ("render", "depth", "mask"):
            if not torch.isfinite(out_k[k]).all():
                raise AssertionError(f"gs3d: {k} has non-finite values")
        if not float((out_k["mask"] > 0.5).float().mean()) > 0:
            raise AssertionError("gs3d: empty mask")
        feats = scene.get_features
        sh_dev = precompute_sh_colors(feats, GS_SH_DEGREE, scene.xyz,
                                      cam["extr"])
        sh_cpu = precompute_sh_colors(feats.cpu(), GS_SH_DEGREE,
                                      scene.xyz.cpu(), cam["extr"].cpu())
        r["sh_err"] = float((sh_dev.cpu() - sh_cpu).abs().max())
        if not r["sh_err"] <= GS_ATOL_SH:
            raise AssertionError(f"gs3d: SH colours {r['sh_err']:.3e} apart")
        vis = mark_visible(scene.xyz, cam["extr"])
        vis_cpu = mark_visible(scene.xyz.cpu(), cam["extr"].cpu())
        r["visible"], r["visible_cpu"] = int(vis.sum()), int(vis_cpu.sum())
        if not torch.equal(vis.cpu(), vis_cpu):
            raise AssertionError(f"gs3d: mark_visible {r['visible']} on "
                                 f"{dev} against {r['visible_cpu']}")
    del out_k, out_p, out_c, sh_dev, sh_cpu, feats

    gen = torch.Generator(device=dev).manual_seed(GS_SEED + 1)
    cots = (torch.randn((img_h, img_w, 3), generator=gen, device=dev),
            torch.randn((img_h, img_w), generator=gen, device=dev),
            torch.randn((img_h, img_w), generator=gen, device=dev))
    out_p, grads_p, _ = gs3d_step(scene, valid, cam, img_w, img_h, cots,
                                  plain=True)
    out_k, grads_k, norms = gs3d_step(scene, valid, cam, img_w, img_h, cots)
    r["step_err"] = gs3d_compare(out_k, out_p, grads_k, grads_p)
    radii = out_k["radii"].detach()
    with torch.no_grad():
        pts = scene.xyz[valid]
        extent = 0.5 * float(torch.linalg.norm(pts.max(0).values
                                               - pts.min(0).values))
    opt = gs3d_optimizer(scene, extent)
    opt.step()
    del out_p, grads_p, out_k, grads_k, pts

    thr = gs3d_threshold(scene, norms, radii, extent)
    r.update(extent=extent, threshold=thr, scene=scene, valid=valid,
             norms=norms, radii=radii)
    cpu_scene = type(scene)(**{f: getattr(scene, f).detach().cpu().clone()
                               for f in scene.FIELDS})
    new, new_valid, r["steps"] = densify_round(
        scene, norms, radii, valid, thr, extent, opt, max_screen)
    ref, ref_valid, ref_steps = densify_round(
        cpu_scene, norms.cpu(), radii.cpu(), valid.cpu(), thr, extent,
        max_screen=max_screen)
    counts = lambda steps: [(s["n_after"], s["kept"])  # noqa: E731
                            for s in steps]
    if counts(r["steps"]) != counts(ref_steps):
        raise AssertionError(f"gs3d: the round's counts on {dev} "
                             f"{counts(r['steps'])} against the CPU's "
                             f"{counts(ref_steps)}")
    for name in ("clone", "split"):
        if not next(s for s in r["steps"] if s["step"] == name)["appended"]:
            raise AssertionError(f"gs3d: {name} selected no row")
    if not torch.equal(new_valid.cpu(), ref_valid):
        raise AssertionError("gs3d: the valid rows differ from the CPU's")
    pruned = next(s for s in r["steps"] if s["step"] == "prune")
    pruned = {k: pruned[k] for k in ("scene", "valid")}
    for s in r["steps"] + ref_steps:
        del s["scene"], s["valid"]
    r["round_err"] = {}
    for f in new.FIELDS:
        a, b = getattr(new, f).detach().cpu(), getattr(ref, f).detach()
        r["round_err"][f] = float((a - b).abs().max()) if b.numel() else 0.0
        scale = max(1.0, float(b.abs().max())) if b.numel() else 1.0
        if not r["round_err"][f] <= GS_RTOL_ROUND * scale:
            raise AssertionError(f"gs3d: the round's {f} on {dev} is "
                                 f"{r['round_err'][f]:.3e} from the CPU's")
    del cpu_scene, ref, ref_valid, ref_steps

    out_p, grads_p, _ = gs3d_step(pruned["scene"], pruned["valid"], cam,
                                  img_w, img_h, cots, plain=True)
    out_k, grads_k, _ = gs3d_step(pruned["scene"], pruned["valid"], cam,
                                  img_w, img_h, cots)
    r["pruned_step_err"] = gs3d_compare(out_k, out_p, grads_k, grads_p)
    r["pruned_n_pairs"] = out_k["n_pairs"]
    r["pruned_coverage"] = float((out_k["mask"] > 0.5).float().mean())
    if not r["pruned_coverage"] > 0:
        raise AssertionError("gs3d: empty mask after the prune")
    del pruned, out_p, grads_p, out_k, grads_k
    out_p, grads_p, _ = gs3d_step(new, new_valid, cam, img_w, img_h, cots,
                                  plain=True)
    out_k, grads_k, _ = gs3d_step(new, new_valid, cam, img_w, img_h, cots)
    r["new_step_err"] = gs3d_compare(out_k, out_p, grads_k, grads_p)
    opt.step()
    for f in new.FIELDS:
        p = getattr(new, f)
        if opt.state[p]["exp_avg"].shape != p.shape \
                or not torch.isfinite(p).all():
            raise AssertionError(f"gs3d: {f} after the second step")
    r.update(new=new, new_valid=new_valid, opt=opt)
    return r


@pytest.fixture(scope="module")
def small_base():
    """The drive's inputs from the render fixture at map_h 256 and 64x64,
    every 8th Gaussian: at this width both large and small Gaussians see a
    gradient, as at full width (at map_h 128 every one is large). The
    KNN of create_from_pcd is a k-d tree's, as in
    test_torch_rasterize.test_full_fixture_pair_count_matches_jax."""
    from animatablegaussians_torch.tools import render_fixture as rf
    from test_torch_rasterize import _kdtree_knn
    mp = pytest.MonkeyPatch()
    mp.setattr(tgm, "knn", lambda q, r, k=4: tuple(
        torch.as_tensor(a) for a in _kdtree_knn(q, r, k)))
    try:
        net, items = rf.build("cpu", map_h=256, img_w=64, img_h=64,
                              channel_max=32)
    finally:
        mp.undo()
    base = gs3d_inputs(net, items)
    return {k: v if k in ("extr", "intr") else v[::8]
            for k, v in base.items()}


@pytest.fixture(params=["cpu", pytest.param("card", marks=pytest.mark.gpu)])
def drive_case(request):
    """(inputs, device, width, height, the prune's screen limit, the
    kernels' launches the drive must make): on the CPU, ``small_base`` at
    64x64, where no Gaussian spans the reference's 20 pixels, so the
    prune's screen limit is lowered to 2 to make it drop rows; on the
    card, the full-width fixture's Gaussians at 1500x2048."""
    if request.param == "cpu":
        return (request.getfixturevalue("small_base"), torch.device("cpu"),
                64, 64, 2, dict.fromkeys(GS_LAUNCHES, 0))
    from animatablegaussians_torch.tools import render_fixture as rf
    net, items, _ = request.getfixturevalue("full_width")
    return (gs3d_inputs(net, items), request.getfixturevalue("card"),
            rf.IMG_W, rf.IMG_H, GS_MAX_SCREEN, GS_LAUNCHES)


def test_gs3d_phase_rehearsal(drive_case, monkeypatch):
    """``gs3d_drive``, (a)-(e): every check passes, the kernels launch as
    many times as its renders and steps, the round's bookkeeping holds
    (each step keeps, appends and drops what its counts say, the per-row
    inputs follow the rows), and a planted fault in the surgery (one
    field's moments off by a row) fails the surgery check."""
    base, dev, w, h, max_screen, want = drive_case
    reset_launches(*kernels())
    r = gs3d_drive(base, dev, w, h, max_screen)
    assert launches(*kernels()) == want
    n = base["xyz"].shape[0]
    assert r["n_points"] == n and r["n_pairs"] == r["n_pairs_colors"] > 0
    steps = {s["step"]: s for s in r["steps"]}
    assert list(steps) == ["clone", "split", "prune", "reset_opacity"]
    prev = n
    for s in r["steps"]:
        assert s["n_before"] == prev
        assert s["n_after"] == s["kept"] + s["appended"]
        prev = s["n_after"]
    assert steps["clone"]["kept"] == n and steps["clone"]["appended"] > 0
    assert steps["split"]["appended"] == 2 * (steps["split"]["n_before"]
                                              - steps["split"]["kept"]) > 0
    assert steps["prune"]["appended"] == 0
    assert 0 < steps["prune"]["kept"] < steps["prune"]["n_before"]
    assert steps["reset_opacity"]["kept"] == steps["reset_opacity"]["n_after"]
    new = r["new"]
    assert new.num_points == prev == r["new_valid"].shape[0]
    held = [p for g in r["opt"].param_groups for p in g["params"]]
    assert [id(p) for p in held] == [id(getattr(new, f)) for f in FIELDS]
    assert r["visible"] == r["visible_cpu"]
    if dev.type == "cpu":
        assert r["sh_err"] == 0.0 and r["visible"] == n
    # (d)'s step after the prune runs on an opaque scene, at the new N
    assert r["pruned_coverage"] > 0 and r["pruned_n_pairs"] > 0
    assert all("scene" not in s for s in r["steps"])

    # the planted fault: the surgery's check must see it
    scene = r["scene"]
    opt = gs3d_optimizer(scene, r["extent"])
    opt.step()                      # the step's gradients are still held
    real = tden.grow_adam_state

    def misaligned(opt_, old, new_, kept=None, reset=()):
        real(opt_, old, new_, kept, reset)
        st = opt_.state[new_.xyz]
        st["exp_avg"] = st["exp_avg"].roll(1, 0)

    monkeypatch.setattr(tden, "grow_adam_state", misaligned)
    with pytest.raises(AssertionError, match="xyz exp_avg"):
        densify_round(scene, r["norms"], r["radii"], r["valid"],
                      r["threshold"], r["extent"], opt, max_screen)
