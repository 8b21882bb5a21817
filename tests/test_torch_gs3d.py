"""The port's generic 3DGS ops against the JAX package on the CPU: SH
evaluation (ops/sh.py), render's SH route, precompute_sh_colors and
mark_visible (ops/rasterize/api.py), quat_mul, rotate_vec and knn_gather.
Densification and its Adam surgery: tests/test_torch_densify.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animatablegaussians_tpu.ops import knn as jknn
from animatablegaussians_tpu.ops import quat as jquat
from animatablegaussians_tpu.ops import sh as jsh
from animatablegaussians_tpu.ops.rasterize import RasterizeConfig
from animatablegaussians_tpu.ops.rasterize import api as japi
from animatablegaussians_torch.models import gaussian_model as tgm
from animatablegaussians_torch.ops import knn as tknn
from animatablegaussians_torch.ops import quat as tquat
from animatablegaussians_torch.ops import sh as tsh
from animatablegaussians_torch.ops.rasterize import api as tapi
from tests.test_torch_rasterize import H, W, make_scene

# a camera that turns and moves, so that the camera centre -R^T t is not 0
EXTR = np.array([[0.9950042, 0.0, 0.0998334, 0.1],
                 [0.0, 1.0, 0.0, -0.05],
                 [-0.0998334, 0.0, 0.9950042, 0.2],
                 [0.0, 0.0, 0.0, 1.0]], np.float32)


def _close(got, want, rtol=1e-6, atol=1e-6, err_msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _unit(n, seed):
    d = np.random.default_rng(seed).standard_normal((n, 3)).astype(
        np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# SH
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.standard_normal((50, 3, (deg + 1) ** 2)).astype(np.float32)
    dirs = _unit(50, deg + 10)
    # the same terms in the same order in float32: a few ulps of O(1)
    _close(tsh.eval_sh(deg, torch.as_tensor(sh), torch.as_tensor(dirs)),
           jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)))
    with pytest.raises(ValueError):
        tsh.eval_sh(4, torch.as_tensor(sh), torch.as_tensor(dirs))


def test_rgb_sh_round_trip():
    rgb = np.random.default_rng(0).uniform(0, 1, (40, 3)).astype(np.float32)
    t = torch.as_tensor(rgb)
    np.testing.assert_array_equal(tsh.rgb_to_sh(t).numpy(),
                                  np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))))
    np.testing.assert_array_equal(
        tsh.sh_to_rgb(tsh.rgb_to_sh(t)).numpy(),
        np.asarray(jsh.sh_to_rgb(jsh.rgb_to_sh(jnp.asarray(rgb)))))
    _close(tsh.sh_to_rgb(tsh.rgb_to_sh(t)), rgb)
    assert tsh.C0 == jsh.C0 and tsh.C1 == jsh.C1
    assert tsh.C2 == jsh.C2 and tsh.C3 == jsh.C3


def test_create_from_pcd_unchanged_by_the_move():
    """create_from_pcd's DC term is bit for bit the formula it had before
    rgb_to_sh moved to ops/sh.py, and gaussian_model still exports both
    helpers."""
    rng = np.random.default_rng(3)
    pts = torch.as_tensor(rng.uniform(-1, 1, (64, 3)).astype(np.float32))
    colors = torch.as_tensor(rng.uniform(0, 1, (64, 3)).astype(np.float32))
    g = tgm.create_from_pcd(pts, colors, sh_degree=2)
    assert torch.equal(g.features_dc,
                       ((colors - 0.5) / 0.28209479177387814)[:, None, :])
    assert g.features_rest.shape == (64, 8, 3)
    assert tgm.rgb_to_sh is tsh.rgb_to_sh and tgm.sh_to_rgb is tsh.sh_to_rgb


def _tie_coefficient():
    """A float32 v with fl32(C0 * v) == -0.5 in both frameworks: a colour
    exactly at precompute_sh_colors' clamp."""
    base = np.float32(-0.5 / jsh.C0)
    for k in range(-8, 9):
        v = np.nextafter(base, np.float32(np.sign(k) or 1) * np.inf,
                         dtype=np.float32) if k else base
        for _ in range(abs(k) - 1):
            v = np.nextafter(v, np.float32(np.sign(k)) * np.inf,
                             dtype=np.float32)
        t = float(tsh.C0 * torch.tensor(v))
        j = float(jsh.C0 * jnp.float32(v))
        if t == j == -0.5:
            return v
    raise AssertionError("no float32 SH coefficient sits at the clamp")


def test_precompute_sh_colors_matches_jax():
    """Value and gradients (shs, means3d) against JAX, with one colour
    channel exactly at the clamp: torch.maximum splits its gradient in
    half there, as jnp.maximum does (torch.clamp would pass all of it)."""
    s = make_scene(n=40, seed=2)
    rng = np.random.default_rng(2)
    shs = (0.3 * rng.standard_normal((40, 16, 3))).astype(np.float32)
    shs[0] = 0.0
    shs[0, 0, 0] = _tie_coefficient()
    cot = rng.standard_normal((40, 3)).astype(np.float32)

    def jloss(shs_, means_):
        rgb = japi.precompute_sh_colors(shs_, 3, means_, jnp.asarray(EXTR))
        return jnp.sum(rgb * cot), rgb

    (_, want), (g_sh, g_m) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(shs),
                                              jnp.asarray(s["means"]))
    t_sh = torch.tensor(shs, requires_grad=True)
    t_m = torch.tensor(s["means"], requires_grad=True)
    got = tapi.precompute_sh_colors(t_sh, 3, t_m, torch.as_tensor(EXTR))
    (got * torch.as_tensor(cot)).sum().backward()
    assert float(got[0, 0].detach()) == float(want[0, 0]) == 0.0
    # float32 in the same order; the direction's norm may round apart
    _close(got, want, rtol=1e-5, atol=1e-6)
    _close(t_sh.grad, g_sh, rtol=1e-5, atol=1e-6)
    _close(t_m.grad, g_m, rtol=1e-4, atol=1e-5)
    # the tie: half of C0 x the cotangent
    half = 0.5 * tsh.C0 * cot[0, 0]
    np.testing.assert_allclose(float(t_sh.grad[0, 0, 0]), half, rtol=1e-6)
    np.testing.assert_allclose(float(g_sh[0, 0, 0]), half, rtol=1e-6)


# ---------------------------------------------------------------------------
# render's SH route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("deg", [1, 3])
def test_render_sh_matches_jax(deg):
    """render(shs=, max_sh_degree=) against JAX render(backend="ref"): the
    image, depth, mask and pair count, and the gradients to shs and
    means3d against jax.vjp for seeded cotangents."""
    s = make_scene(n=60, seed=deg)
    rng = np.random.default_rng(deg)
    shs = (0.4 * rng.standard_normal((60, (deg + 1) ** 2, 3))).astype(
        np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    cfg = RasterizeConfig(backend="ref", k_max=512, max_dup=16)
    fixed = [jnp.asarray(s[k]) for k in ("scales", "q", "opac")]

    def jrender(means, shs_):
        out = japi.render(means, *fixed, None, jnp.asarray(bg),
                          jnp.asarray(EXTR), jnp.asarray(s["intr"]), W, H,
                          config=cfg, shs=shs_, max_sh_degree=deg)
        return (tuple(out[k] for k in ("render", "depth", "mask")),
                out["n_pairs"])

    cots = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((H, W, 3), (H, W), (H, W))]

    @jax.jit
    def forward_and_vjp(means, shs_):   # one compile for both directions
        outs, vjp, n_pairs = jax.vjp(jrender, means, shs_, has_aux=True)
        return outs, n_pairs, vjp(tuple(jnp.asarray(c) for c in cots))

    outs, n_pairs, (g_means, g_shs) = forward_and_vjp(
        jnp.asarray(s["means"]), jnp.asarray(shs))

    t_m = torch.tensor(s["means"], requires_grad=True)
    t_sh = torch.tensor(shs, requires_grad=True)
    t = lambda k: torch.as_tensor(s[k])
    got = tapi.render(t_m, t("scales"), t("q"), t("opac"), None,
                      torch.as_tensor(bg), torch.as_tensor(EXTR), t("intr"),
                      W, H, shs=t_sh, max_sh_degree=deg)
    for k, w in zip(("render", "depth", "mask"), outs):
        _close(got[k], w, rtol=0, atol=1e-5, err_msg=k)
    assert got["n_pairs"] == int(n_pairs)
    sum((got[k] * torch.as_tensor(c)).sum()
        for k, c in zip(("render", "depth", "mask"), cots)).backward()
    for name, x, w in (("means3d", t_m, g_means), ("shs", t_sh, g_shs)):
        w = np.asarray(w)
        # as test_torch_rasterize.test_render_gradients_match_jax: float32
        # preprocess and blend in two frameworks, relative to the whole
        # gradient
        err = np.linalg.norm(x.grad.numpy() - w) / np.linalg.norm(w)
        assert err < 1e-4, (name, err)


def test_render_takes_colors_or_shs():
    s = make_scene(n=10, seed=1)
    t = lambda k: torch.as_tensor(s[k])
    args = (t("means"), t("scales"), t("q"), t("opac"))
    cam = (torch.ones(3), t("extr"), t("intr"), W, H)
    shs = torch.zeros((10, 4, 3))
    with pytest.raises(ValueError):
        tapi.render(*args, t("colors"), *cam, shs=shs, max_sh_degree=1)
    with pytest.raises(ValueError):
        tapi.render(*args, None, *cam)
    # SH of degree 0 whose DC term is rgb_to_sh(colors) renders colors
    dc = tsh.rgb_to_sh(t("colors"))[:, None, :]
    a = tapi.render(*args, t("colors"), *cam)
    b = tapi.render(*args, None, *cam, shs=dc)
    _close(b["render"], a["render"].numpy(), rtol=0, atol=1e-6)


def test_mark_visible_matches_jax():
    s = make_scene(n=80, seed=4)
    means = s["means"].copy()
    means[:20, 2] = np.linspace(-1.0, 0.5, 20)     # around the near plane
    got = tapi.mark_visible(torch.as_tensor(means), torch.as_tensor(EXTR))
    want = japi.mark_visible(jnp.asarray(means), jnp.asarray(EXTR))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < 80


# ---------------------------------------------------------------------------
# quaternions, KNN gather, the GaussianParams accessors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["quat_mul", "rotate_vec", "knn_gather"])
def test_small_ops_match_jax(op):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((30, 4)).astype(np.float32)
    if op == "quat_mul":
        b = rng.standard_normal((30, 4)).astype(np.float32)
        got = tquat.quat_mul(torch.as_tensor(q), torch.as_tensor(b))
        want = jquat.quat_mul(jnp.asarray(q), jnp.asarray(b))
        _close(got, want, rtol=1e-6, atol=1e-6)
    elif op == "rotate_vec":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        v = rng.standard_normal((30, 3)).astype(np.float32)
        got = tquat.rotate_vec(torch.as_tensor(q), torch.as_tensor(v))
        _close(got, jquat.rotate_vec(jnp.asarray(q), jnp.asarray(v)))
        # and it is the rotation matrix's action
        _close(got, np.einsum("nij,nj->ni", tquat.quat_to_mat(
            torch.as_tensor(q)).numpy(), v), rtol=1e-5, atol=1e-5)
    else:
        x = rng.standard_normal((50, 6)).astype(np.float32)
        idx = rng.integers(0, 50, (20, 4)).astype(np.int32)
        got = tknn.knn_gather(torch.as_tensor(x), torch.as_tensor(idx))
        want = jknn.knn_gather(jnp.asarray(x), jnp.asarray(idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.shape == (20, 4, 6)
