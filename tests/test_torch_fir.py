"""The port's separable FIR resampler (ops/fir.py) against the JAX package's
Pallas FIR kernel on the CPU, and the routing of ops/upfirdn2d.py.

``upfirdn2d_fir_plain`` is the arithmetic of the CUDA kernel
``csrc/fir.cu``; here it is held against ``fir_pallas.upfirdn2d_pallas``
in interpret mode (as ``tests/test_fir_pallas.py`` runs it) over the same
cases and shapes, and ``upfirdn2d_fir``'s autograd gradient against
``jax.grad`` through the Pallas custom VJP. The kernel itself runs only on
the card (``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatablegaussians_tpu.models import styleunet as jsu
from animatablegaussians_tpu.ops import fir_pallas as jfp
from animatablegaussians_tpu.ops import upfirdn2d as juf
from animatablegaussians_torch.models import styleunet as tsu
from animatablegaussians_torch.ops import fir as tfir
from animatablegaussians_torch.ops import upfirdn2d as tuf
from animatablegaussians_torch.utils.convert import dual_styleunet_state

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

BLUR = juf.make_kernel((1, 3, 3, 1))
# tests/test_fir_pallas.py's CASES: (kernel, up, down, pad), every call
# pattern of the nets, with Haar's signed taps to expose a flipped kernel
CASES = [
    (BLUR, 1, 1, (2, 2)),
    (BLUR, 1, 1, (2, 1)),
    (BLUR * 4.0, 1, 1, (1, 1)),
    (BLUR, 1, 2, (1, 1)),
    (BLUR * 4.0, 2, 1, (2, 1)),
    (juf.haar_wavelets()[0], 1, 2, (0, 0)),
    (juf.haar_wavelets()[3], 1, 2, (0, 0)),
    (juf.haar_wavelets()[1], 2, 1, (1, 0, 1, 0)),
]
SHAPES = [(1, 16, 16, 3), (1, 24, 40, 5), (2, 32, 16, 130)]


def _pad4(pad):
    return pad if len(pad) == 4 else (pad[0], pad[1], pad[0], pad[1])


def _taps(kern):
    kv, kh = jfp.separable_factors(kern)
    return tuple(kv.tolist()), tuple(kh.tolist())


def _nchw(x):
    return torch.as_tensor(x).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas(case, shape):
    kern, up, down, pad = CASES[case]
    x = np.random.default_rng(case).standard_normal(shape).astype(np.float32)
    kv, kh = _taps(kern)
    want = np.asarray(jfp.upfirdn2d_pallas(jnp.asarray(x), kv, kh, up, down,
                                           _pad4(pad)))
    got = _nhwc(tfir.upfirdn2d_fir_plain(_nchw(x), kv, kh, up, down,
                                         _pad4(pad)))
    assert got.shape == want.shape
    # the same products and sums in the same order; XLA's CPU interpreter
    # of the Pallas kernel may contract a product and a sum (one rounding)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("case", [0, 3, 4, 7])
def test_grad_matches_pallas(case):
    """upfirdn2d_fir's autograd gradient (the transposed operator, with
    negative grad pads at down=2) against jax.grad through the Pallas
    custom VJP, of sum(cos(y))."""
    kern, up, down, pad = CASES[case]
    x = np.random.default_rng(10 + case).standard_normal(
        (1, 16, 24, 3)).astype(np.float32)
    kv, kh = _taps(kern)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jnp.cos(
        jfp.upfirdn2d_pallas(a, kv, kh, up, down, _pad4(pad)))))(
            jnp.asarray(x)))
    xt = _nchw(x).requires_grad_(True)
    torch.cos(tfir.upfirdn2d_fir(xt, kv, kh, up, down, _pad4(pad))).sum() \
        .backward()
    np.testing.assert_allclose(_nhwc(xt.grad), want, atol=2e-5, rtol=1e-4)


def test_factors_and_lengths_match_jax():
    """separable_factors bit for bit (the taps the kernel gets), None for a
    kernel that is not rank 1 or has too many taps; out_len and the grad
    pads against the JAX arithmetic and the shapes the ops produce."""
    kernels = [BLUR, BLUR * 4.0, *juf.haar_wavelets(),
               juf.make_kernel((1, 2, 1)), np.ones((1, 3), np.float32)]
    for k in kernels:
        got, want = tfir.separable_factors(k), jfp.separable_factors(k)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    for k in (np.eye(3, dtype=np.float32), juf.make_kernel((1,) * 5)):
        assert tfir.separable_factors(k) is None
        assert jfp.separable_factors(k) is None
    for kern, up, down, pad in CASES:
        px0, px1, py0, py1 = _pad4(pad)
        kv, kh = _taps(kern)
        h, w = 24, 40
        oh = tfir.out_len(h, len(kv), up, down, py0, py1)
        ow = tfir.out_len(w, len(kh), up, down, px0, px1)
        assert (oh, ow) == (jfp._out_len(h, len(kv), up, down, py0, py1),
                            jfp._out_len(w, len(kh), up, down, px0, px1))
        x = torch.zeros((1, 2, h, w))
        assert tfir.upfirdn2d_fir(x, kv, kh, up, down,
                                  (px0, px1, py0, py1)).shape[2:] == (oh, ow)
        gx0, gx1, gy0, gy1 = tfir.grad_pads((h, w), len(kv), len(kh), up,
                                            down, (px0, px1, py0, py1))
        assert tfir.out_len(oh, len(kv), down, up, gy0, gy1) == h
        assert tfir.out_len(ow, len(kh), down, up, gx0, gx1) == w


def test_wrapper_rejects_what_the_kernel_does_not_take():
    kv, kh = _taps(BLUR)
    x = torch.zeros((1, 32, 8, 8))
    with pytest.raises(ValueError, match="float32"):
        tfir.upfirdn2d_fir(x.double(), kv, kh, 1, 1, (2, 2, 2, 2))
    with pytest.raises(ValueError, match="contiguous"):
        tfir.upfirdn2d_fir(x.transpose(2, 3), kv, kh, 1, 1, (2, 2, 2, 2))
    with pytest.raises(ValueError, match="taps"):
        tfir.upfirdn2d_fir(x, kv + (0.0,), kh, 1, 1, (2, 2, 2, 2))


def _counting(monkeypatch):
    """Count the calls _upfirdn2d sends to ops/fir.py's kernel wrapper."""
    calls = []
    inner = tfir.upfirdn2d_fir

    def counted(x, kv, kh, up, down, pad):
        calls.append((tuple(x.shape), up, down, pad))
        return inner(x, kv, kh, up, down, pad)

    monkeypatch.setattr(tfir, "upfirdn2d_fir", counted)
    return calls


@pytest.mark.parametrize("c,kern,up,down,pad,routed", [
    (32, BLUR, 1, 1, (2, 2), True),             # encoder pre-blur
    (64, BLUR * 4.0, 1, 1, (1, 1), True),       # decoder post-blur
    (32, BLUR, 1, 2, (1, 1), True),             # downsample
    (48, BLUR * 4.0, 2, 1, (2, 1), True),       # upsample
    (32, juf.haar_wavelets()[3], 1, 2, (0, 0), True),
    (3, BLUR, 1, 2, (1, 1), True),              # FromRGB: 3 channels
    (8, BLUR * 4.0, 2, 1, (2, 1), True),        # ToRGB's wavelet chain
    (32, BLUR, 4, 1, (2, 1), False),            # up > 2
    (32, np.eye(3, dtype=np.float32), 1, 1, (1, 1), False),  # not rank 1
    (32, juf.make_kernel((1,) * 5), 1, 1, (2, 2), False),    # 5 taps
])
def test_routes_exactly_the_gated_calls(monkeypatch, c, kern, up, down, pad,
                                        routed):
    """_upfirdn2d sends a call to upfirdn2d_fir exactly when it passes the
    gates (the JAX package's, without its 32-channel floor), and either way
    computes the JAX package's upfirdn2d; with plain=True a gated call
    takes the plain version and nothing reaches the kernel wrapper."""
    calls = _counting(monkeypatch)
    x = np.random.default_rng(c).standard_normal((2, 9, 11, c)).astype(
        np.float32)
    want = np.asarray(juf.upfirdn2d(jnp.asarray(x), kern, up, down, pad))
    got = _nhwc(tuf._upfirdn2d(_nchw(x), kern, up, down, pad))
    assert len(calls) == int(routed)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    got_plain = _nhwc(tuf._upfirdn2d(_nchw(x), kern, up, down, pad,
                                     plain=True))
    assert len(calls) == int(routed)
    np.testing.assert_array_equal(got_plain, got)


@pytest.fixture(scope="module")
def small_net():
    kw = dict(inp_size=64, inp_ch=3, out_ch=3, out_size=128, style_dim=32,
              n_mlp=2, channel_max=32)
    jnet = jsu.DualStyleUNet(**kw)
    params = jnet.init(jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    leaves = [l + 0.1 * jax.random.normal(k, l.shape) if l.ndim <= 1 else l
              for l, k in zip(leaves, keys)]
    params = jax.tree_util.tree_map(
        np.asarray, jax.tree_util.tree_unflatten(treedef, leaves))
    tnet = tsu.DualStyleUNet(**kw)
    tnet.load_state_dict(dual_styleunet_state(params))
    return jnet, params, tnet


def test_dual_styleunet_through_fir_matches_jax(monkeypatch, small_net):
    """A DualStyleUNet (64^2 -> 128^2, channel_max 32) against the JAX
    DualStyleUNet, at test_torch_styleunet.py's tolerance; every FIR of it
    went through the FIR function (conv_in's pre-blur, 2 FromRGB
    downsamples and 2 encoder pre-blurs, and per decoder branch 3 post-blurs
    and 2 wavelet upsamples), and its input gradient equals the one of
    plain=True, which differentiates the plain version's slices."""
    jnet, params, tnet = small_net
    calls = _counting(monkeypatch)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    style = rng.standard_normal((1, 32)).astype(np.float32)
    prev = jsu.CONV_PRECISION
    jsu.set_conv_precision("highest")
    try:
        want = np.asarray(jnet.apply(params, jnp.asarray(style),
                                     jnp.asarray(x)))
    finally:
        jsu.set_conv_precision(prev)
    xt = torch.tensor(x, requires_grad=True)
    got = tnet(torch.as_tensor(style), xt)
    n_fir = 1 + 2 + 2 + 2 * (3 + 2)
    assert len(calls) == n_fir
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())

    cot = torch.as_tensor(rng.standard_normal(got.shape).astype(np.float32))
    got.backward(cot)
    assert len(calls) == 2 * n_fir            # each backward is one more
    xo = torch.tensor(x, requires_grad=True)
    tnet(torch.as_tensor(style), xo, plain=True).backward(cot)
    assert len(calls) == 2 * n_fir
    rel = float((xt.grad - xo.grad).norm() / xo.grad.norm())
    # the transposed operator and autograd through the slices add each
    # input element's terms in another float32 order
    assert rel < 1e-5, rel
