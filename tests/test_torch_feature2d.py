"""The port's 2D feature fields (``models/feature2d.py``) against the JAX
package's on the CPU, with the same numpy inputs and the JAX parameters
carried across by ``utils/convert.feature2d_state``.

Tolerances: ``grid_sample2d`` and the tri-plane sample 1e-6 absolute on
N(0, 1) maps (the same float32 arithmetic in the same order), their first
and second derivatives 1e-5 relative and 1e-5 absolute (scatter sums in
another order); the conv stacks and the U-Net 1e-4 of the output's largest
magnitude (float32 convolutions of two frameworks, the JAX side at its
highest precision: this CPU stack's default rounds through bfloat16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatablegaussians_tpu.models import feature2d as jf
from animatablegaussians_torch.models import feature2d as tf
from animatablegaussians_torch.utils.convert import feature2d_state

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

ATOL_SAMPLE = 1e-6
RTOL_GRAD = ATOL_GRAD = 1e-5
REL_CONV = 1e-4


def _np_params(init, seed):
    """The JAX module's parameter tree drawn with numpy on
    ``jax.eval_shape``'s shapes, with ``init``'s distributions: conv
    weights N(0, 2 / (k k cin)), biases 0, feature maps 0.03 N(0, 1) (an
    eager JAX init compiles once per leaf shape)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1])
        if "b" in name and "fmap" not in name:
            return np.zeros(leaf.shape, np.float32)
        if "fmap" in name:
            return (0.03 * rng.standard_normal(leaf.shape)).astype(np.float32)
        k, _, cin, _ = leaf.shape
        return (rng.standard_normal(leaf.shape)
                * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(init, jax.random.PRNGKey(0)))


def _nchw(x):
    return torch.tensor(np.ascontiguousarray(np.asarray(x).transpose(
        0, 3, 1, 2)))


def _points(rng, shape):
    """Points in [-1.1, 1.1] (some outside the image, where the corners
    clamp), and the four corners and edge midpoints exactly."""
    p = rng.uniform(-1.1, 1.1, shape + (2,)).astype(np.float32)
    flat = p.reshape(-1, 2)
    flat[:6] = [[-1, -1], [1, 1], [-1, 1], [1, -1], [0, -1], [-1, 0]]
    return p


@pytest.fixture(scope="module")
def sample_inputs():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 7, 9, 4)).astype(np.float32)
    return img, _points(rng, (2, 5, 6)), rng.standard_normal(
        (2, 5, 6, 4)).astype(np.float32)


def test_grid_sample2d_matches_jax(sample_inputs):
    img, pts, _ = sample_inputs
    got = tf.grid_sample2d(_nchw(img), torch.tensor(pts))
    want = jf.grid_sample2d(jnp.asarray(img), jnp.asarray(pts))
    assert got.shape == (2, 5, 6, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL_SAMPLE, rtol=0)


def _jax_grads(img, pts, cot):
    """JAX: the first derivatives of <out, cot> and the gradient of the
    squared point gradient (a gradient of a gradient) in image and
    points."""
    def inner(i, p):
        return jnp.sum(jf.grid_sample2d(i, p) * cot)

    def outer(i, p):
        gi, gp = jax.grad(inner, argnums=(0, 1))(i, p)
        return jnp.sum(gp ** 2) + jnp.sum(gi * gp[..., :1].mean())

    first = jax.grad(inner, argnums=(0, 1))(img, pts)
    second = jax.grad(outer, argnums=(0, 1))(img, pts)
    return first, second


def test_grid_sample2d_double_backward_matches_jax(sample_inputs):
    img, pts, cot = sample_inputs
    (jgi, jgp), (jhi, jhp) = _jax_grads(jnp.asarray(img), jnp.asarray(pts),
                                        jnp.asarray(cot))
    ti = _nchw(img).requires_grad_(True)
    tp = torch.tensor(pts, requires_grad=True)
    out = tf.grid_sample2d(ti, tp)
    gi, gp = torch.autograd.grad((out * torch.tensor(cot)).sum(), [ti, tp],
                                 create_graph=True)
    outer = (gp ** 2).sum() + (gi * gp[..., :1].mean()).sum()
    hi, hp = torch.autograd.grad(outer, [ti, tp])
    for name, g, w in (("d image", gi.permute(0, 2, 3, 1), jgi),
                       ("d points", gp, jgp),
                       ("dd image", hi.permute(0, 2, 3, 1), jhi),
                       ("dd points", hp, jhp)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RTOL_GRAD, atol=ATOL_GRAD,
                                   err_msg=name)
    # the second derivative reaches both the image and the points
    assert hi.abs().max() > 0 and hp.abs().max() > 0


def test_triplane_and_uv_match_jax():
    rng = np.random.default_rng(1)
    tri_j, uv_j = jf.TriPlaneFeature(5, 12), jf.UVFeature(6, 10)
    ptri = _np_params(tri_j.init, 0)
    puv = _np_params(uv_j.init, 1)
    tri = tf.TriPlaneFeature(5, 12, device="cpu")
    uv = tf.UVFeature(6, 10, device="cpu")
    assert tri.fmap.shape == (1, 15, 12, 12) and uv.fmap.shape == (1, 6, 10,
                                                                   10)
    tri.load_state_dict(feature2d_state(ptri))
    uv.load_state_dict(feature2d_state(puv))
    fm, fm_j = tri(2), tri_j.apply(ptri, 2)
    assert fm_j.shape == (2, 12, 12, 15)
    np.testing.assert_array_equal(fm.permute(0, 2, 3, 1).detach().numpy(),
                                  np.asarray(fm_j))
    xyz = rng.uniform(-1, 1, (2, 40, 3)).astype(np.float32)
    got = tri.sample_feat(torch.tensor(xyz), fm)
    want = tri_j.sample_feat(jnp.asarray(xyz), fm_j)
    assert got.shape == (2, 40, 15)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL_SAMPLE, rtol=0)
    p2d = rng.uniform(-1, 1, (3, 7, 2)).astype(np.float32)
    got = uv.sample_feat(torch.tensor(p2d), uv(3))
    want = uv_j.sample_feat(jnp.asarray(p2d), uv_j.apply(puv, 3))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL_SAMPLE, rtol=0)
    # the port's own draw: 0.03 N(0, 1)
    tri = tf.TriPlaneFeature(5, 12, device="cpu")
    assert 0.025 < float(tri.fmap.detach().std()) < 0.035


def _rel_close(got, want, msg):
    want = np.asarray(want)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < REL_CONV, f"{msg}: {err:.2e}"


@pytest.mark.parametrize("k,relu", [(3, True), (5, False), (7, True)])
def test_conv_stack_matches_jax(k, relu):
    rng = np.random.default_rng(k)
    j = jf.ConvStack(3, 4, hid_dim=6, kernel_size=k, layer_num=3,
                     use_relu=relu)
    p = _np_params(j.init, k)
    t = tf.ConvStack(3, 4, hid_dim=6, kernel_size=k, layer_num=3,
                     use_relu=relu, device="cpu")
    t.load_state_dict(feature2d_state(p))
    x = rng.standard_normal((2, 12, 10, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(j.apply)(p, jnp.asarray(x))
    got = t(_nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    _rel_close(got, want, f"ConvStack k={k}")


def test_unet5_matches_jax():
    """Forward and the input's gradient at nf 4 on 32^2; the converter's
    transposed convs carry the JAX weights without a flip."""
    rng = np.random.default_rng(5)
    j = jf.UNet5(3, 2, 4)
    p = _np_params(j.init, 5)
    t = tf.UNet5(3, 2, 4, device="cpu")
    t.load_state_dict(feature2d_state(p))
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    cot = rng.standard_normal((1, 32, 32, 2)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want, want_gx = jax.jit(lambda q, v, c: (
            j.apply(q, v), jax.vjp(lambda u: j.apply(q, u), v)[1](c)[0]))(
            p, jnp.asarray(x), jnp.asarray(cot))
    xt = _nchw(x).requires_grad_(True)
    out = t(xt)
    assert out.shape == (1, 2, 32, 32)
    (out * _nchw(cot)).sum().backward()
    _rel_close(out.permute(0, 2, 3, 1).detach().numpy(), want, "UNet5")
    _rel_close(xt.grad.permute(0, 2, 3, 1).numpy(), want_gx,
               "UNet5 input gradient")
    # a flipped transposed-conv weight gives another function
    sd = feature2d_state(p)
    sd["deconv1.weight"] = sd["deconv1.weight"].flip(2, 3)
    t.load_state_dict(sd)
    err = np.abs(t(_nchw(x)).permute(0, 2, 3, 1).detach().numpy()
                 - np.asarray(want)).max() / np.abs(np.asarray(want)).max()
    assert err > 100 * REL_CONV
