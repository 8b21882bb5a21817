"""The port's StyleGAN losses and R1 penalty against the JAX package on the
CPU, and the second derivative through the FIR wrapper (``ops/fir.py``:
``_FIR`` and ``_FIRGrad``) against autograd through its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatablegaussians_tpu.models import discriminator as jdisc
from animatablegaussians_tpu.models import styleunet as jsu
from animatablegaussians_tpu.ops import fir_pallas as jfp
from animatablegaussians_tpu.ops import upfirdn2d as juf
from animatablegaussians_tpu.training import losses as jl
from animatablegaussians_torch.models import discriminator as tdisc
from animatablegaussians_torch.ops import fir as tfir
from animatablegaussians_torch.ops import upfirdn2d as tuf
from animatablegaussians_torch.training import losses as tl
from animatablegaussians_torch.utils import convert
from test_torch_stylegan import init_params

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

DISC_KW = dict(size=32, img_channel=3, channel_max=16)


@pytest.fixture(scope="module", autouse=True)
def _highest_precision():
    prev = jsu.CONV_PRECISION
    jsu.set_conv_precision("highest")
    yield
    jsu.set_conv_precision(prev)


def test_adversarial_losses_match_jax():
    rng = np.random.default_rng(0)
    real, fake = (rng.standard_normal((4, 1)).astype(np.float32) * 3
                  for _ in range(2))
    pairs = [(tl.d_logistic_loss(torch.as_tensor(real),
                                 torch.as_tensor(fake)),
              jl.d_logistic_loss(jnp.asarray(real), jnp.asarray(fake))),
             (tl.g_nonsaturating_loss(torch.as_tensor(fake)),
              jl.g_nonsaturating_loss(jnp.asarray(fake)))]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.fixture(scope="module")
def disc():
    jnet = jdisc.Discriminator(**DISC_KW)
    params = init_params(jnet, 0)
    tnet = tdisc.Discriminator(device="cpu", **DISC_KW)
    tnet.load_state_dict(convert.discriminator_state(params), strict=True)
    return jnet, params, tnet


def test_r1_penalty_and_its_gradient_match_jax(disc):
    """d_r1_loss and its gradient with respect to every parameter of the
    Discriminator (B = 4, one stddev group) against jax.grad of the JAX
    penalty; the JAX gradient tree is carried into the port's layout by
    the same (linear) converter as the weights. The port's FIRs run
    through ``_launch`` in all three directions, as
    ``chip_smoke.fir_calls`` records them: the forward, the first
    derivative (the transposed call, ``_launch_grad``) and the second
    (``_launch_grad2``), each derivative of a forward call it recorded.
    Gradients of a gradient through ~20 float32 layers: rtol 1e-4 of each
    parameter's largest gradient."""
    jnet, params, tnet = disc
    real = np.random.default_rng(1).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)

    def jax_r1(p):
        return jl.d_r1_loss(lambda x: jnet.apply(p, x), jnp.asarray(real))

    want, want_grad = jax.jit(jax.value_and_grad(jax_r1))(params)
    want_grad = convert.discriminator_state(
        jax.tree_util.tree_map(np.asarray, want_grad))

    import chip_smoke

    tnet.zero_grad()
    with chip_smoke.fir_calls() as calls:
        got = tl.d_r1_loss(tnet, torch.as_tensor(real))
        got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    assert {order for _, order, _ in calls} == {0, 1, 2}
    forward = {key for key, order, _ in calls if order == 0}
    assert {key for key, _, _ in calls} == forward
    for name, p in tnet.named_parameters():
        w = want_grad[name].numpy()
        if p.grad is None:      # no path to dD/dx (the last bias): JAX's 0
            assert not w.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


BLUR = juf.make_kernel((1, 3, 3, 1))
HAAR = juf.haar_wavelets()
# (kernel, up, down, pad) for the three (up, down) pairs the nets use
SECOND = [(BLUR, 1, 1, (2, 1, 2, 1)), (BLUR * 4.0, 2, 1, (2, 1, 2, 1)),
          (HAAR[1], 2, 1, (1, 0, 1, 0)), (BLUR, 1, 2, (1, 1, 1, 1)),
          (HAAR[3], 1, 2, (0, 0, 0, 0))]


@pytest.mark.parametrize("case", range(len(SECOND)))
@pytest.mark.parametrize("hw", [(8, 10), (9, 11)])
def test_second_derivative_matches_plain(monkeypatch, case, hw):
    """With a cotangent that carries a gradient, the FIR's first
    derivative is recorded (``_FIRGrad``): its values are, bit for bit,
    the transposed call the backward launches without a graph (the
    arguments of ``_grad_args``, launched once), and its gradient with
    respect to the cotangent is the forward call, on the forward's own
    output shape; on odd and even sizes (at down = 2 an odd length leaves
    a last row no output reads). Against autograd over the plain
    version's torch ops (a gradient of a gradient through its slices),
    which sums in another order: 1e-6 of the largest entry."""
    kern, up, down, pad = SECOND[case]
    kv, kh = (tuple(t.tolist()) for t in jfp.separable_factors(kern))
    rng = np.random.default_rng(case)
    x = rng.standard_normal((2, 3) + hw).astype(np.float32)
    args = (kv, kh, up, down, pad)
    y_shape = tuple(tfir.upfirdn2d_fir_plain(torch.as_tensor(x), *args)
                    .shape)
    c = rng.standard_normal(y_shape).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)

    def run(fn):
        xt = torch.tensor(x, requires_grad=True)
        ct = torch.tensor(c, requires_grad=True)
        gx, = torch.autograd.grad(fn(xt, *args), xt, ct, create_graph=True)
        gc, = torch.autograd.grad(gx, ct, torch.as_tensor(r))
        return gx.detach(), gc

    seen = []
    inner = tfir._launch
    monkeypatch.setattr(tfir, "_launch", lambda *a: seen.append(a[1:])
                        or inner(*a))
    gx, gc = run(tfir.upfirdn2d_fir)
    gargs = tfir._grad_args(hw, *args)
    assert seen == [args, gargs, args]
    first = tfir.upfirdn2d_fir_plain(torch.as_tensor(c), *gargs)
    assert torch.equal(gx, first)
    assert gc.shape == y_shape
    assert torch.equal(gc, tfir.upfirdn2d_fir_plain(torch.as_tensor(r),
                                                    *args))
    px, pc = run(tfir.upfirdn2d_fir_plain)
    for got, want in ((gx, px), (gc, pc)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6 * float(want.abs().max()))


def test_first_derivative_without_a_graph_is_unchanged(monkeypatch):
    """A backward that builds no graph (a train step's) launches the
    transposed call directly, as before ``_FIRGrad``: no second
    autograd node, the same launch and the same bits."""
    kern, up, down, pad = SECOND[3]
    kv, kh = (tuple(t.tolist()) for t in jfp.separable_factors(kern))
    args = (kv, kh, up, down, pad)
    rng = np.random.default_rng(9)
    xt = torch.tensor(rng.standard_normal((1, 4, 13, 12)).astype(np.float32),
                      requires_grad=True)
    applied = []
    monkeypatch.setattr(tfir._FIRGrad, "apply",
                        lambda *a: applied.append(a) or None)
    y = tfir.upfirdn2d_fir(xt, *args)
    g = torch.as_tensor(rng.standard_normal(y.shape).astype(np.float32))
    y.backward(g)
    assert not applied
    assert torch.equal(xt.grad, tfir.upfirdn2d_fir_plain(
        g, *tfir._grad_args((13, 12), *args)))


def test_wavelet_downsample_plain_switch(monkeypatch):
    """``plain=True`` sends the wavelet downsample's FIR to the plain
    version, in the NCHW core and through the NHWC wrapper; without it
    the call goes to the wrapper of the kernel."""
    x = torch.randn(1, 12, 16, 16)
    want = tuf._wavelet_downsample(x)
    monkeypatch.setattr(tfir, "upfirdn2d_fir", None)
    assert torch.equal(tuf._wavelet_downsample(x, plain=True), want)
    assert torch.equal(tuf.wavelet_downsample(x.permute(0, 2, 3, 1),
                                              plain=True),
                       want.permute(0, 2, 3, 1))
    with pytest.raises(TypeError):
        tuf._wavelet_downsample(x)
