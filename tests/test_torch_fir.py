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
    launches = []
    inner = tfir._launch
    monkeypatch.setattr(tfir, "_launch", lambda *a: launches.append(1)
                        or inner(*a))
    xt = torch.tensor(x, requires_grad=True)
    got = tnet(torch.as_tensor(style), xt)
    n_fir = 1 + 2 + 2 + 2 * (3 + 2)
    assert len(calls) == len(launches) == n_fir
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())

    cot = torch.as_tensor(rng.standard_normal(got.shape).astype(np.float32))
    got.backward(cot)
    # each backward is one more launch of the kernel's wrapper
    assert (len(calls), len(launches)) == (n_fir, 2 * n_fir)
    xo = torch.tensor(x, requires_grad=True)
    tnet(torch.as_tensor(style), xo, plain=True).backward(cot)
    assert (len(calls), len(launches)) == (n_fir, 2 * n_fir)
    rel = float((xt.grad - xo.grad).norm() / xo.grad.norm())
    # the transposed operator and autograd through the slices add each
    # input element's terms in another float32 order
    assert rel < 1e-5, rel


# -- the CUDA kernel's tiling, emulated on the CPU ---------------------------
# csrc/fir.cu runs only on the card. This emulation repeats its index
# arithmetic per block, with numpy float32 operations in its order: the
# shared-memory geometry of Geo<UP, DOWN>, the window's first row and
# 16-byte aligned first column, its zero fill, the vertical pass over the
# rows and columns a tile's outputs read (+0 outside the image; a ragged
# tile leaves the rest unwritten, NaN here), and the horizontal pass over
# each thread's span of vertical sums with the up = 2 phase split (stuffed
# taps a constant +0 term). A tiling bug shows here against the plain
# version, bit for bit.

KERNEL_TILE = (64, 16)   # csrc/fir.cu: TW, TH


def _emulate_fir_kernel(x, kv, kh, up, down, pad, tile=KERNEL_TILE):
    """csrc/fir.cu's blocks over x (N, C, H, W) float32 numpy; tile is the
    (TW, TH) output tile, TW a multiple of 4 (a thread's 4 outputs)."""
    tw, th = tile
    f32 = np.float32
    px0, px1, py0, py1 = pad
    n, c, h, w = x.shape
    oh = tfir.out_len(h, len(kv), up, down, py0, py1)
    ow = tfir.out_len(w, len(kh), up, down, px0, px1)
    v = [f32(t) for t in reversed(kv)]
    hz = [f32(t) for t in reversed(kh)]
    taps = tfir.MAX_TAPS
    step = 4 * down // up
    vec = min(step, 4)
    need = (3 * down + taps - 1 + up - 1) // up + 1
    span = -(-need // vec) * vec
    vs_w = (tw // 4 - 1) * step + span
    win_w = (vs_w + 6) // 4 * 4
    win_h = ((th - 1) * down + taps - 1 + up - 1) // up + 1
    planes = x.reshape(n * c, h, w)
    out = np.empty((n * c, oh, ow), f32)
    for oy0 in range(0, oh, th):
        for ox0 in range(0, ow, tw):
            ulx, uly = ox0 * down - px0, oy0 * down - py0
            fx, fy = ulx // up, uly // up
            phx, phy = ulx - fx * up, uly - fy * up
            cbase = fx & ~3
            offx = fx - cbase
            iy, ix = fy + np.arange(win_h), cbase + np.arange(win_w)
            win = np.zeros((n * c, win_h, win_w), f32)
            ry, rx = (iy >= 0) & (iy < h), (ix >= 0) & (ix < w)
            win[np.ix_(np.ones(n * c, bool), ry, rx)] = \
                planes[:, iy[ry]][:, :, ix[rx]]
            # a ragged tile computes only the rows and columns its outputs
            # read; the rest stays NaN here and must not reach an output
            rows_t = min(th, oh - oy0)
            cols_t = min(vs_w, (phx + (min(tw, ow - ox0) - 1) * down
                                + taps - 1) // up + 1)
            vs = np.full((n * c, th, vs_w), np.nan, f32)
            cols = fx + np.arange(cols_t)
            inside = (cols >= 0) & (cols < w)
            for r in range(rows_t):
                acc = None
                for t in range(len(kv)):
                    u = phy + r * down + t
                    xv = (np.zeros((n * c, cols_t), f32) if u % up else
                          win[:, u // up, offx:offx + cols_t])
                    term = xv * v[t]
                    acc = term if acc is None else acc + term
                vs[:, r, :cols_t] = np.where(inside, acc, f32(0.0))
            q = np.arange(tw // 4)
            outs = []
            for j in range(4):
                acc = None
                for m in range(len(kh)):
                    u = phx + j * down + m
                    xv = (np.zeros((n * c, th, tw // 4), f32)
                          if up == 2 and u & 1 else
                          vs[:, :, q * step + u // up])
                    term = xv * hz[m]
                    acc = term if acc is None else acc + term
                outs.append(acc)
            blk = np.stack(outs, -1).reshape(n * c, th, tw)
            ny, nx = min(th, oh - oy0), min(tw, ow - ox0)
            out[:, oy0:oy0 + ny, ox0:ox0 + nx] = blk[:, :ny, :nx]
    return out.reshape(n, c, oh, ow)


def _assert_bitwise(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_tiling_matches_plain(case, shape):
    """The kernel's blocks at its own tile size, over the cases and shapes
    the plain version is held to against Pallas, equal to it bit for bit."""
    kern, up, down, pad = CASES[case]
    x = np.random.default_rng(20 + case).standard_normal(shape).astype(
        np.float32)
    kv, kh = _taps(kern)
    xc = _nchw(x)
    want = tfir.upfirdn2d_fir_plain(xc, kv, kh, up, down, _pad4(pad))
    _assert_bitwise(_emulate_fir_kernel(xc.numpy(), kv, kh, up, down,
                                        _pad4(pad)), want.numpy())


@pytest.mark.parametrize("case,nchw,tile,transposed", [
    (0, (1, 2, 37, 45), (8, 5), False),      # tiles that do not divide
    (1, (2, 1, 19, 23), (12, 3), False),
    (3, (1, 3, 29, 35), (8, 7), False),      # down = 2, ragged
    (4, (1, 2, 13, 17), (8, 3), False),      # up = 2, ragged
    (7, (1, 3, 11, 9), (4, 2), False),       # up = 2, Haar, one-sided pad
    (3, (1, 2, 15, 18), (8, 5), True),       # grad of down = 2: up = 2
    # grad of a call padded beyond its taps: negative grad pads (crops)
    ((juf.haar_wavelets()[2], 1, 1, (2, 3, 3, 2)), (1, 3, 16, 20),
     KERNEL_TILE, True),
    ((BLUR, 1, 2, (4, 3, 5, 4)), (1, 2, 23, 30), (8, 5), True),
    (4, (1, 1, 9, 14), (8, 4), True),        # grad of up = 2: down = 2
    (0, (2, 3, 70, 131), KERNEL_TILE, True),  # several tiles each way
])
def test_kernel_tiling_ragged_and_transposed(case, nchw, tile, transposed):
    """Ragged edges (tile sizes that divide neither OH nor OW), 1-3
    channels, and the backward's calls: taps reversed, up and down swapped
    and grad_pads, some negative (crops)."""
    kern, up, down, pad = CASES[case] if isinstance(case, int) else case
    kv, kh = _taps(kern)
    pad = _pad4(pad)
    if transposed:
        fwd_hw = nchw[2:]
        h = tfir.out_len(fwd_hw[0], len(kv), up, down, pad[2], pad[3])
        w = tfir.out_len(fwd_hw[1], len(kh), up, down, pad[0], pad[1])
        pad = tfir.grad_pads(fwd_hw, len(kv), len(kh), up, down, pad)
        kv, kh, up, down = kv[::-1], kh[::-1], down, up
        nchw = nchw[:2] + (h, w)
        assert isinstance(case, int) or min(pad) < 0
    x = torch.as_tensor(np.random.default_rng(sum(nchw)).standard_normal(
        nchw).astype(np.float32))
    want = tfir.upfirdn2d_fir_plain(x, kv, kh, up, down, pad)
    _assert_bitwise(_emulate_fir_kernel(x.numpy(), kv, kh, up, down, pad,
                                        tile), want.numpy())


@pytest.mark.parametrize("pad", [(2, 1, 2, 1), (1, 0, 0, 2), (-1, 2, 1, -1)])
def test_kernel_tiling_up2_down2(pad):
    """up = 2 with down = 2, which the kernel takes though no caller of
    either package makes it: both phases, signed taps, crops."""
    kv, kh = _taps(juf.haar_wavelets()[3])
    kv4, kh4 = _taps(BLUR * 4.0)
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (1, 2, 21, 26)).astype(np.float32))
    for a, b in ((kv, kh), (kv4, kh4), (kv4, kh)):
        want = tfir.upfirdn2d_fir_plain(x, a, b, 2, 2, pad)
        _assert_bitwise(_emulate_fir_kernel(x.numpy(), a, b, 2, 2, pad,
                                            (8, 5)), want.numpy())


@pytest.mark.parametrize("case", [0, 3, 4, 5, 7])
def test_backward_launches_transposed_call(monkeypatch, case):
    """_FIR.backward on the CPU: one launch of the wrapper with the
    transposed arguments, equal bit for bit to that call of the plain
    version, and equal to autograd through the plain version's slices up
    to float32 summation order; with a cotangent that carries a gradient,
    the same launch as a differentiable function of it."""
    kern, up, down, pad = CASES[case]
    kv, kh = _taps(kern)
    pad = _pad4(pad)
    rng = np.random.default_rng(30 + case)
    x = rng.standard_normal((2, 3, 14, 18)).astype(np.float32)
    seen = []
    inner = tfir._launch
    monkeypatch.setattr(tfir, "_launch", lambda *a: seen.append(a[1:])
                        or inner(*a))
    xt = torch.tensor(x, requires_grad=True)
    y = tfir.upfirdn2d_fir(xt, kv, kh, up, down, pad)
    g = torch.as_tensor(rng.standard_normal(y.shape).astype(np.float32))
    y.backward(g)
    gpad = tfir.grad_pads((14, 18), len(kv), len(kh), up, down, pad)
    assert seen == [(kv, kh, up, down, pad),
                    (kv[::-1], kh[::-1], down, up, gpad)]
    _assert_bitwise(xt.grad.numpy(), tfir.upfirdn2d_fir_plain(
        g, kv[::-1], kh[::-1], down, up, gpad).numpy())
    xp = torch.tensor(x, requires_grad=True)
    tfir.upfirdn2d_fir_plain(xp, kv, kh, up, down, pad).backward(g)
    np.testing.assert_allclose(xt.grad.numpy(), xp.grad.numpy(), rtol=0,
                               atol=1e-6 * float(xp.grad.abs().max()))
    # with a cotangent that carries a gradient the backward is recorded
    # (_FIRGrad): the same transposed launch and bits, and its own
    # gradient is the forward call
    seen.clear()
    gr = g.clone().requires_grad_(True)
    gx, = torch.autograd.grad(tfir.upfirdn2d_fir(xt, kv, kh, up, down, pad),
                              xt, gr, create_graph=True)
    _assert_bitwise(gx.detach().numpy(), xt.grad.numpy())
    gx.backward(torch.ones_like(gx))
    assert seen == [(kv, kh, up, down, pad),
                    (kv[::-1], kh[::-1], down, up, gpad),
                    (kv, kh, up, down, pad)]
