"""The port's StyleGAN losses and R1 penalty against the JAX package on the
CPU, and the second derivative through the FIR wrapper (``ops/fir.py``:
``_FIR`` and ``_FIRGrad``) against autograd through its plain version.

Marked ``gpu`` (skipped without a CUDA device), the StyleGAN2 family at the
avatar heads' widths (``GAN_KW``): each generator's forward through the
FIR kernel against its plain version, bit for bit under cuDNN's
deterministic algorithms; StyleGenerator(1024, n_mlp 8) forward and
backward; one GAN step at B = 2 with its R1 penalty (the FIR's second
derivative), step 0 through the kernel against the plain path, the FIR
launches of a step in each direction, and the kernel against its plain
version at each distinct FIR call of the step in each direction it ran."""

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
from on_card import (assert_step_matches, by_direction, card,  # noqa
                     check_fir_calls, cudnn_deterministic, fir_calls,
                     grad_snapshot, launches, reset_launches)

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
    ``on_card.fir_calls`` records them: the forward, the first
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

    tnet.zero_grad()
    with fir_calls() as calls:
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


# ---------------------------------------------------------------------------
# on the card, at the avatar heads' widths
# ---------------------------------------------------------------------------

# the StyleGAN2 family at the avatar heads' widths (models/avatar.py:
# 129-135): 512^2 condition maps in, 1024^2 out
GAN_KW = dict(inp_size=512, inp_ch=3, out_ch=3, out_size=1024,
              style_dim=512, n_mlp=2, channel_max=512)
# the GAN step's batch, the steps before the recorded one and those
# counted after it, the R1 weight (StyleGAN2's gamma, as r1 / 2 * gamma)
# and Adam's settings (StyleGAN2's)
GAN_B, GAN_WARMUP, GAN_COUNTED = 2, 2, 3
GAN_R1_GAMMA, GAN_LR, GAN_BETAS = 10.0, 2e-3, (0.0, 0.99)
# the host's draw of the default inject_index, seeded alike before each
# route's forward
GAN_INJECT_SEED = 19


def _build(cls, seed, dev, **kw):
    net = cls(generator=torch.Generator().manual_seed(seed), device=dev,
              **kw)
    with torch.no_grad():            # the noise weights start at zero
        for name, p in net.named_parameters():
            if name.endswith("noise.weight"):
                p.fill_(0.1)
    return net


@pytest.mark.gpu
@pytest.mark.parametrize("seed,label", [(100, "base"), (101, "add_dwt"),
                                        (102, "wo_dwt"), (103, "SWGANUnet")])
def test_generator_through_the_kernel_matches_plain(card, seed, label):
    """A B = 1 forward with two styles mixed at the default inject_index
    and fixed noise. A generator's forward through the FIR kernel against
    through its plain version is held bit for bit under cuDNN's
    deterministic algorithms: every FIR launch of it equals its plain
    version bit for bit, and deterministic cuDNN sums equal inputs alike
    (under the default algorithms the same route run twice already
    differs by 7.2e-7 to 1.42e-6 of the output's largest |value| on the
    H100). The plain route launches no kernel."""
    import random

    from animatablegaussians_torch.models.styleunet_v2 import (
        DualStyleUNetV2, SWGANUnet)
    gen = torch.Generator(device=card).manual_seed(19)
    net = (_build(SWGANUnet, seed, card, **GAN_KW) if label == "SWGANUnet"
           else _build(DualStyleUNetV2, seed, card, mode=label, **GAN_KW))
    cond = torch.randn((1, GAN_KW["inp_size"], GAN_KW["inp_size"], 3),
                       generator=gen, device=card)
    styles = [torch.randn((1, GAN_KW["style_dim"]), generator=gen,
                          device=card) for _ in range(2)]
    noise = net.make_noise(gen)
    outs = {}
    with cudnn_deterministic(), torch.no_grad():
        for plain in (False, True):
            reset_launches(tfir.upfirdn2d_fir)
            random.seed(GAN_INJECT_SEED)
            outs[plain] = net(styles, cond, noise=noise, plain=plain)[0]
            outs[plain, "launches"] = launches(
                tfir.upfirdn2d_fir)["upfirdn2d_fir"]
    out = outs[False]
    assert tuple(out.shape) == (1, GAN_KW["out_size"], GAN_KW["out_size"],
                                GAN_KW["out_ch"] * len(net.BRANCHES))
    assert bool(torch.isfinite(out).all()) and float(out.abs().max()) > 0
    assert outs[False, "launches"] > 0 and outs[True, "launches"] == 0
    assert torch.equal(out, outs[True])


@pytest.mark.gpu
def test_style_generator_forward_and_backward(card):
    from animatablegaussians_torch.models.stylegan import StyleGenerator
    gen = torch.Generator(device=card).manual_seed(19)
    sg = _build(StyleGenerator, 110, card, size=GAN_KW["out_size"],
                style_dim=GAN_KW["style_dim"], n_mlp=8, channel_multiplier=2)
    z = [torch.randn((GAN_B, GAN_KW["style_dim"]), generator=gen,
                     device=card)]
    img = sg(z, noise=sg.make_noise(gen))[0]
    img.square().mean().backward()
    assert tuple(img.shape) == (GAN_B, GAN_KW["out_size"],
                                GAN_KW["out_size"], 3)
    assert bool(torch.isfinite(img).all())
    assert all(bool(torch.isfinite(p.grad).all())
               for p in sg.parameters() if p.grad is not None)


@pytest.mark.gpu
def test_gan_step_through_the_kernel(card):
    """G the base DualStyleUNetV2, D the Discriminator(1024, 6 channels) on
    G's [front | back] output and seeded real maps; the D half's logistic
    loss and R1 penalty (a gradient of a gradient: the FIR's second
    derivative through ops/fir.py::_FIRGrad), Adam; the G half's
    non-saturating loss, Adam. Step 0's losses and gradients per group
    through the kernel against the plain path; each step's losses finite;
    a step's FIR launches in every direction, as many each step; each
    distinct FIR call of the step in each direction it ran against the
    plain version (forward bit for bit, derivatives within RTOL_FIR)."""
    from animatablegaussians_torch.models.styleunet_v2 import \
        DualStyleUNetV2
    gen = torch.Generator(device=card).manual_seed(19)
    G = _build(DualStyleUNetV2, 100, card, mode="base", **GAN_KW)
    D = _build(tdisc.Discriminator, 120, card, size=GAN_KW["out_size"],
               img_channel=2 * GAN_KW["out_ch"],
               channel_max=GAN_KW["channel_max"])
    side = GAN_KW["inp_size"]
    cond = torch.randn((GAN_B, side, side, 3), generator=gen, device=card)
    z = [torch.randn((GAN_B, GAN_KW["style_dim"]), generator=gen,
                     device=card)]
    real = torch.randn((GAN_B, GAN_KW["out_size"], GAN_KW["out_size"],
                        2 * GAN_KW["out_ch"]), generator=gen, device=card)
    noise = G.make_noise(gen)

    def d_half(plain):
        D.requires_grad_(True)
        D.zero_grad(set_to_none=True)
        with torch.no_grad():
            fake = G(z, cond, noise=noise, plain=plain)[0]
        d_loss = tl.d_logistic_loss(D(real, plain=plain),
                                    D(fake, plain=plain))
        r1 = tl.d_r1_loss(lambda x: D(x, plain=plain), real)
        (d_loss + GAN_R1_GAMMA / 2 * r1).backward()
        return {"d_logistic": d_loss.detach(), "r1": r1.detach()}

    def g_half(plain):
        D.requires_grad_(False)
        G.zero_grad(set_to_none=True)
        fake = G(z, cond, noise=noise, plain=plain)[0]
        g_loss = tl.g_nonsaturating_loss(D(fake, plain=plain))
        g_loss.backward()
        return {"g_nonsaturating": g_loss.detach()}

    def halves(plain):
        terms = d_half(plain)
        g_d = grad_snapshot(D)
        terms.update(g_half(plain))
        return terms, g_d, grad_snapshot(G)

    t_k, gd_k, gg_k = halves(False)
    t_p, gd_p, gg_p = halves(True)
    assert_step_matches(G, (t_k, gg_k), (t_p, gg_p))
    assert_step_matches(D, (t_k, gd_k), (t_p, gd_p))
    assert all(np.isfinite(float(v)) for v in t_k.values())
    del gd_k, gg_k, gd_p, gg_p

    g_opt = torch.optim.Adam(G.parameters(), lr=GAN_LR, betas=GAN_BETAS)
    d_opt = torch.optim.Adam(D.parameters(), lr=GAN_LR, betas=GAN_BETAS)

    def step():
        terms = d_half(False)
        d_opt.step()
        terms.update(g_half(False))
        g_opt.step()
        assert all(np.isfinite(float(v)) for v in terms.values()), terms

    for _ in range(GAN_WARMUP):
        step()
    with fir_calls() as calls:
        step()
    reset_launches(tfir.upfirdn2d_fir)
    for _ in range(GAN_COUNTED):
        step()
    by_dir = by_direction(calls)
    print(f"FIR launches of a GAN step, forward / first / second "
          f"derivative: {by_dir}")
    assert min(by_dir.values()) > 0
    assert launches(tfir.upfirdn2d_fir)["upfirdn2d_fir"] == \
        GAN_COUNTED * len(calls)
    del G, D, g_opt, d_opt
    check_fir_calls(calls, card, step=True)
