"""The port's GaussianParams accessors, densification (models/densify.py)
and its Adam surgery against the JAX package on the CPU. The surgery
after a split or a prune is held to a numpy statement of the reference's
``_prune_optimizer`` / ``cat_tensors_to_optimizer``, since the JAX
package's ``grow_adam_state`` only pads at the end. Last, a CPU rehearsal
of chip_smoke.py phase 21's checks and bookkeeping at a small size."""

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
# chip_smoke.py phase 21, rehearsed on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_base():
    """Phase 21's inputs from the render fixture at map_h 256 and 64x64,
    every 8th Gaussian: at this width both large and small Gaussians see a
    gradient, as at full width (at map_h 128 every one is large). The
    KNN of create_from_pcd is a k-d tree's, as in
    test_torch_rasterize.test_full_fixture_pair_count_matches_jax."""
    import chip_smoke
    from animatablegaussians_torch.tools import render_fixture as rf
    from tests.test_torch_rasterize import _kdtree_knn
    mp = pytest.MonkeyPatch()
    mp.setattr(tgm, "knn", lambda q, r, k=4: tuple(
        torch.as_tensor(a) for a in _kdtree_knn(q, r, k)))
    try:
        net, items = rf.build("cpu", map_h=256, img_w=64, img_h=64,
                              channel_max=32)
    finally:
        mp.undo()
    base = chip_smoke.gs3d_inputs(net, items)
    return {k: v if k in ("extr", "intr") else v[::8]
            for k, v in base.items()}


def test_gs3d_phase_rehearsal(small_base, monkeypatch):
    """chip_smoke.gs3d_drive, phase 21 (a)-(e), on the CPU with its plain
    versions: every check passes, the round's bookkeeping holds (each step
    keeps, appends and drops what its counts say, the per-row inputs
    follow the rows), and a planted fault in the surgery (one field's
    moments off by a row) fails the phase's surgery check. At 64x64 no
    Gaussian spans the reference's 20 pixels, so the prune's screen limit
    is lowered to 2 here to make it drop rows."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "GS_MAX_SCREEN", 2)
    r = chip_smoke.gs3d_drive(small_base, torch.device("cpu"), 64, 64)
    n = small_base["xyz"].shape[0]
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
    assert r["sh_err"] == 0.0 and r["visible"] == r["visible_cpu"] == n
    # (d)'s step after the prune runs on an opaque scene, at the new N
    assert r["pruned_coverage"] > 0 and r["pruned_n_pairs"] > 0
    assert all("scene" not in s for s in r["steps"])

    # the planted fault: the surgery's check must see it
    scene = r["scene"]
    opt = chip_smoke.gs3d_optimizer(scene, r["extent"])
    opt.step()                      # the step's gradients are still held
    real = tden.grow_adam_state

    def misaligned(opt_, old, new_, kept=None, reset=()):
        real(opt_, old, new_, kept, reset)
        st = opt_.state[new_.xyz]
        st["exp_avg"] = st["exp_avg"].roll(1, 0)

    monkeypatch.setattr(tden, "grow_adam_state", misaligned)
    with pytest.raises(AssertionError, match="xyz exp_avg"):
        chip_smoke.densify_round(scene, r["norms"], r["radii"], r["valid"],
                                 r["threshold"], r["extent"], opt)
