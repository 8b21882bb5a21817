"""The port's ``remat`` and ``random_style`` against the JAX package on the
CPU: one DualStyleUNet's gradients with remat against JAX's
``DualStyleUNet(remat=True)``; remat on against remat off in the port (the
same gradients and the FIR launches the recompute adds); an avatar train
step with ``remat: true`` and one with ``random_style: true`` against
JAX's; render and render_sequence unchanged by remat; the batched step's
refusal of ``random_style`` and the draws of a net without it.

Both sides get the same numbers: the JAX weights are carried across with
``params_from_jax``, and the step's draws, the random style among them, are
made from the JAX package's own key splits and handed to the port. The
loss is L1 + offset (no LPIPS: neither option reaches it), so each JAX
step compiles once.

Marked ``gpu`` (skipped without a CUDA device), on the full-width fixture
with the bench's settings: a B = 1 and a B = 2 step with remat against
the same steps without it under cuDNN's deterministic algorithms, with
the FIR launches the recompute adds; the render with remat bit for bit;
a B = 1 step with random_style through the kernels against
``plain=True``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatablegaussians_tpu.models import styleunet as jsu
from animatablegaussians_tpu.models.avatar import AvatarNet as JAvatarNet
from animatablegaussians_tpu.models.gaussian_model import GaussianParams
from animatablegaussians_tpu.ops.rasterize import RasterizeConfig
from animatablegaussians_tpu.training import avatar_trainer as jat
from animatablegaussians_tpu.training.checkpoint import (
    import_avatar_params, import_dual_styleunet)
from animatablegaussians_tpu.utils import synthetic as jsyn
from animatablegaussians_torch.models import styleunet as tsu
from animatablegaussians_torch.models.avatar import AvatarNet as TAvatarNet
from animatablegaussians_torch.ops import fir
from animatablegaussians_torch.training import avatar_trainer as tat
from animatablegaussians_torch.utils.convert import (dual_styleunet_state,
                                                      params_from_jax)
from on_card import (assert_step_matches, by_direction, card,  # noqa: F401
                     cudnn_deterministic, finite, fir_calls, fir_count, full,
                     full_width, grad_snapshot, train_kw)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

MAP_H, IMG = 64, 64
LOSS_WEIGHT = dict(l1=1.0, offset=0.005)
STEP_KW = dict(loss_weight=LOSS_WEIGHT, img_w=IMG, img_h=IMG)
# float32 on both sides, the JAX CNN with polyphase resampling against the
# port's chains (sums in another order); the same limits as
# tests/test_torch_train.py's step and DualStyleUNet comparisons
RTOL_LOSS, GRAD_RTOL = 1e-4, 1e-4
UNET_KW = dict(inp_size=32, inp_ch=3, out_ch=3, out_size=64, style_dim=32,
               n_mlp=2, channel_max=32)


@pytest.fixture(autouse=True)
def _highest_precision():
    prev = jsu.CONV_PRECISION
    jsu.set_conv_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield
    jsu.set_conv_precision(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params_np(params):
    p = dict(params)
    p["cano_gaussian"] = dataclasses.asdict(params["cano_gaussian"])
    return _np(p)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


class _FIRCount:
    """Counts ``ops/fir._launch`` calls in the block (every FIR launch
    goes through it, the plain version on the CPU included)."""

    def __enter__(self):
        self.n, self._saved = 0, fir._launch

        def launch(*args):
            self.n += 1
            return self._saved(*args)

        fir._launch = launch
        return self

    def __exit__(self, *exc):
        fir._launch = self._saved


# ---------------------------------------------------------------------------
# 1-2. one DualStyleUNet with remat
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unet():
    """DualStyleUNet weights as JAX params (the port's seeded init, 1-D
    leaves moved off it by seeded noise so that every bias has a gradient,
    read by the JAX package's importer: its own initializer compiles leaf
    by leaf on the CPU), a style, a condition and an output cotangent."""
    rng = np.random.default_rng(3)
    sd = {k: v.numpy() for k, v in tsu.DualStyleUNet(
        **UNET_KW, generator=torch.Generator().manual_seed(0)).state_dict(
    ).items()}
    for k, v in sd.items():
        if v.ndim <= 1:
            sd[k] = v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
    params = import_dual_styleunet(sd, "", jsu.DualStyleUNet(**UNET_KW))
    style = rng.standard_normal((1, 32)).astype(np.float32)
    cond = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    cot = rng.standard_normal((1, 64, 64, 6)).astype(np.float32)
    return dict(params=_np(params), style=style, cond=cond, cot=cot)


def _port_unet_grads(unet, remat: bool):
    """The port net's output, input gradient, parameter gradients and FIR
    launches (forward, then backward) for the fixture's cotangent."""
    tnet = tsu.DualStyleUNet(**UNET_KW, remat=remat)
    tnet.load_state_dict(dual_styleunet_state(unet["params"]))
    cond = torch.tensor(unet["cond"], requires_grad=True)
    with _FIRCount() as fwd:
        out = tnet(torch.as_tensor(unet["style"]), cond)
    with _FIRCount() as bwd:
        out.backward(torch.as_tensor(unet["cot"]))
    return tnet, dict(out=out.detach(), cond=cond.grad,
                      params={n: p.grad for n, p in tnet.named_parameters()},
                      fwd=fwd.n, bwd=bwd.n)


def test_dual_styleunet_remat_gradients_match_jax(unet):
    """Input and every parameter's gradient of one DualStyleUNet with remat
    (32^2 -> 64^2, channel_max 32) against jax.vjp of JAX's
    DualStyleUNet(remat=True) (jitted), for one numpy cotangent."""
    jnet = jsu.DualStyleUNet(**UNET_KW, remat=True)

    @jax.jit
    def vjp(p, c, cot):
        out, f = jax.vjp(lambda p, c: jnet.apply(p, unet["style"], c), p, c)
        return out, f(cot)

    out, (gp, gc) = _np(vjp(unet["params"], unet["cond"], unet["cot"]))
    tnet, got = _port_unet_grads(unet, remat=True)
    assert _rel(got["out"].numpy(), out) < 1e-5
    assert _rel(got["cond"].numpy(), gc) < 1e-5
    want = dual_styleunet_state(gp)
    assert set(got["params"]) == {k for k in want
                                  if not k.startswith("noises.")}
    for name, g in got["params"].items():
        assert _rel(g.numpy(), want[name].numpy()) < GRAD_RTOL, name


def test_remat_equals_no_remat(unet):
    """remat on against off in the port: the output and every gradient bit
    for bit on the CPU (asked: 1e-6; remat recomputes the same float32
    operations in the same order). The backward launches the forward's
    FIRs again where the recompute needs them: the up-conv's blur of each
    decoder stage of both branches (its output feeds the saved noise
    injection and leaky ReLU). The ToRGB's upsample of the skip saves no
    tensor of its own, so the recompute stops before it (checkpoint's
    early stop)."""
    tnet, off = _port_unet_grads(unet, remat=False)
    _, on = _port_unet_grads(unet, remat=True)
    assert torch.equal(on["out"], off["out"])
    assert torch.equal(on["cond"], off["cond"])
    for name, g in off["params"].items():
        assert torch.equal(on["params"][name], g), name
    assert on["fwd"] == off["fwd"]
    assert on["bwd"] == off["bwd"] + len(tnet.convs1)


# ---------------------------------------------------------------------------
# 3-6. the avatar with remat and random_style
# ---------------------------------------------------------------------------

def tiny_params(opt, pos, lbs, nml):
    """The port's seeded init with the position/other heads' ToRGB weights
    scaled by 0.05 (as tests/test_torch_train.py's fixture: the Gaussians
    stay near their create_from_pcd attributes), as JAX params through the
    JAX package's importer (its own initializer is slow on the CPU)."""
    sd = {k: v.numpy() for k, v in TAvatarNet(
        opt, pos, lbs, cano_nml_map=nml, device="cpu").state_dict().items()}
    for k in sd:
        if k.startswith(("position_net.to_rgbs", "other_net.to_rgbs")) \
                and k.endswith(".conv.weight"):
            sd[k] = 0.05 * sd[k]
    cano = GaussianParams(**{f: jnp.asarray(sd[f"cano_gaussian.{f}"])
                             for f in GaussianParams.__dataclass_fields__})
    return import_avatar_params(sd, JAvatarNet(opt, pos, lbs,
                                               cano_nml_map=nml),
                                {"cano_gaussian": cano})


@pytest.fixture(scope="module")
def tiny():
    pos, nml, lbs = jsyn.make_cano_map(map_h=MAP_H)
    opt = {"with_viewdirs": True, "channel_max": 32}
    params = tiny_params(opt, pos, lbs, nml)
    items = jsyn.make_items(img_w=IMG, img_h=IMG, cano_pos_map=pos)
    items["boundary_mask_img"][6:10, :] = 1.0
    return dict(pos=pos, nml=nml, lbs=lbs, opt=opt, params=params,
                items=items)


def _jax_net(tiny, **opt):
    # caps that drop nothing (n_overflow is checked)
    return JAvatarNet(dict(tiny["opt"], **opt), tiny["pos"], tiny["lbs"],
                      cano_nml_map=tiny["nml"],
                      raster_config=RasterizeConfig(
                          backend="ref", k_max=4096, max_dup=64,
                          max_active_tiles=0))


def _port_net(tiny, **opt):
    net = TAvatarNet(dict(tiny["opt"], **opt), tiny["pos"], tiny["lbs"],
                     cano_nml_map=tiny["nml"], device="cpu")
    net.load_state_dict(params_from_jax(_params_np(tiny["params"])))
    return net


def _draws(rng, n_points, style: bool = False):
    """The JAX step's own draws from ``rng`` (avatar_trainer.py:126-128,
    avatar.py:428-442, losses.py:116-118) as the port's ``draws``: render
    splits rng_net into (rng, vd_rng), the view jitter from vd_rng and the
    random style, U[0, 1)^(1, 512), from the rest."""
    rng_bg, rng_net, rng_crop = jax.random.split(rng, 3)
    rng_style, vd_rng = jax.random.split(rng_net)
    kv, ku = jax.random.split(rng_crop)
    draws = dict(
        bg=torch.tensor(np.asarray(jax.random.uniform(rng_bg, (3,)))),
        viewdir_noise=torch.tensor(np.asarray(
            jax.random.normal(vd_rng, (n_points, 3)))),
        crop=(float(jax.random.uniform(kv)), float(jax.random.uniform(ku))))
    if style:
        draws["style"] = torch.tensor(np.asarray(
            jax.random.uniform(rng_style, (1, 512))))
    return draws


def _step_against_jax(tiny, **opt):
    """Step 0's loss terms and every parameter group's gradient, the port
    against JAX, for a net with the model keys ``opt``."""
    jnet = _jax_net(tiny, **opt)
    rng = jax.random.PRNGKey(10)

    def loss(p, it, rng):
        return jat.compute_losses(jnet, p, it, rng, jnp.zeros((), jnp.int32),
                                  **STEP_KW)
    (_, jterms), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        tiny["params"], {k: jnp.asarray(v) for k, v in tiny["items"].items()},
        rng)
    assert int(jterms["n_overflow"]) == 0
    net = _port_net(tiny, **opt)
    state = tat.make_train_state(net)
    step = tat.make_train_step(net, **STEP_KW)
    terms = step.loss_and_grads(
        state, {k: torch.as_tensor(v) for k, v in tiny["items"].items()},
        _draws(rng, net.n_points, style=net.random_style))
    assert terms.keys() == {k for k in jterms
                            if k not in ("n_overflow", "n_pairs")}
    for k, v in terms.items():
        np.testing.assert_allclose(float(v), float(jterms[k]),
                                   rtol=RTOL_LOSS, err_msg=k)
    want = params_from_jax(_params_np(jgrads))
    errs, grads = {}, {}
    for name, p in net.named_parameters():
        if p.grad is None:     # unused by the loss: JAX gives 0
            np.testing.assert_array_equal(want[name].numpy(), 0.0)
            continue
        grads[name] = p.grad.clone()
        got_w = errs.setdefault(name.split(".")[0], ([], []))
        got_w[0].append(p.grad.numpy().ravel())
        got_w[1].append(want[name].numpy().ravel())
    errs = {k: _rel(np.concatenate(a), np.concatenate(b))
            for k, (a, b) in errs.items()}
    # viewdir_net reaches the image only at out_size 1024
    assert set(errs) == {"color_net", "position_net", "other_net",
                         "cano_gaussian"}
    assert max(errs.values()) < GRAD_RTOL, errs
    return net, terms, grads


def test_remat_train_step_matches_jax(tiny):
    """Step 0 with ``remat: true`` on both sides (JAX: jax.checkpoint per
    decoder stage, models/avatar.py:157), against JAX's; and the port's
    remat step equals its plain step bit for bit."""
    net, terms, grads = _step_against_jax(tiny, remat=True)
    assert all(h.remat for h in (net.color_net, net.position_net,
                                 net.other_net))
    plain = _port_net(tiny)
    titems = {k: torch.as_tensor(v) for k, v in tiny["items"].items()}
    want = tat.make_train_step(plain, **STEP_KW).loss_and_grads(
        tat.make_train_state(plain), titems,
        _draws(jax.random.PRNGKey(10), plain.n_points))
    for k, v in want.items():
        assert torch.equal(terms[k], v), k
    for name, p in plain.named_parameters():
        if p.grad is not None:
            assert torch.equal(grads[name], p.grad), name


def test_remat_render_is_bitwise(tiny):
    """render and render_sequence run under no_grad, where remat changes
    nothing: the same images bit for bit."""
    on, off = _port_net(tiny, remat=True), _port_net(tiny)
    items = {k: torch.as_tensor(v) for k, v in tiny["items"].items()}
    seq = {k: torch.stack([v, v]) for k, v in items.items()}
    a = on.render(items, img_w=IMG, img_h=IMG)
    b = off.render(items, img_w=IMG, img_h=IMG)
    for k in ("rgb_map", "mask_map", "depth_map", "offset", "cano_tex_map"):
        assert torch.equal(a[k], b[k]), k
    a = on.render_sequence(seq, img_w=IMG, img_h=IMG)
    b = off.render_sequence(seq, img_w=IMG, img_h=IMG)
    for k in ("rgb_map", "mask_map", "depth_map"):
        assert torch.equal(a[k], b[k]), k


def test_random_style_train_step_matches_jax(tiny):
    """Step 0 with ``random_style: true``: the colour head takes the style
    drawn from the step's key as JAX's render splits it (avatar.py:
    431-442), handed to the port in ``draws``; the other heads keep the
    constant style. A different style moves the loss."""
    net, terms, _ = _step_against_jax(tiny, random_style=True)
    titems = {k: torch.as_tensor(v) for k, v in tiny["items"].items()}
    draws = _draws(jax.random.PRNGKey(10), net.n_points, style=True)
    other = tat.make_train_step(net, **STEP_KW).loss_and_grads(
        tat.make_train_state(net), titems,
        dict(draws, style=torch.full((1, 512), 0.5)))
    assert float(other["l1_loss"]) != float(terms["l1_loss"])
    with torch.no_grad():
        # an inference render keeps the constant style
        a = net.render(titems, img_w=IMG, img_h=IMG)
        b = _port_net(tiny).render(titems, img_w=IMG, img_h=IMG)
    assert torch.equal(a["rgb_map"], b["rgb_map"])


def test_random_style_draws_and_batched_refusal(tiny):
    """The batched step refuses ``random_style`` (JAX avatar_trainer.py:
    226-229). A net without it draws exactly what make_draws drew before
    the style existed (bg, view jitter, crop from one generator); with it
    the style comes after those, U[0, 1)^(1, 512)."""
    rs = _port_net(tiny, random_style=True)
    with pytest.raises(NotImplementedError, match="random_style"):
        tat.make_train_step_batched(rs, **STEP_KW)
    with pytest.raises(NotImplementedError, match="random_style"):
        tat.compute_losses_batched(rs, {}, [], 0, **STEP_KW)
    plain = _port_net(tiny)
    assert tat.draws_style_dim(plain) == 0
    assert tat.draws_style_dim(rs) == 512
    n = plain.n_points
    d = tat.make_draws(torch.Generator().manual_seed(5), n,
                       tat.draws_style_dim(plain))
    g = torch.Generator().manual_seed(5)
    want = dict(bg=torch.rand(3, generator=g),
                viewdir_noise=torch.randn((n, 3), generator=g),
                crop=tuple(torch.rand(2, generator=g).tolist()))
    assert d.keys() == want.keys()
    assert torch.equal(d["bg"], want["bg"])
    assert torch.equal(d["viewdir_noise"], want["viewdir_noise"])
    assert d["crop"] == want["crop"]
    s = tat.make_draws(torch.Generator().manual_seed(5), n,
                       tat.draws_style_dim(rs))
    assert torch.equal(s["viewdir_noise"], d["viewdir_noise"])
    assert s["crop"] == d["crop"]
    assert torch.equal(s["style"], torch.rand((1, 512), generator=g))
    with pytest.raises(KeyError, match="style"):
        rs.render({k: torch.as_tensor(v) for k, v in tiny["items"].items()},
                  training=True, draws=d, img_w=IMG, img_h=IMG)


# ---------------------------------------------------------------------------
# on the card, at full width
# ---------------------------------------------------------------------------

# remat's steps against the same steps without it under cuDNN's
# deterministic algorithms: the forward is the same float32 arithmetic in
# the same order, so the losses may differ only by the rounding of their
# last sums; the gradients by the backward blend's atomics, which sum in a
# run-dependent order (the events of on_card.RTOL_GRAD cannot occur, the
# forward being identical)
RTOL_REMAT_LOSS, RTOL_REMAT_GRAD = 1e-6, 1e-4


def _set_remat(net, on: bool) -> None:
    """The three heads' ``remat``, as ``AvatarNet({"remat": on})`` sets it
    (models/avatar.py)."""
    for head in (net.position_net, net.other_net, net.color_net):
        head.remat = on


def _remat_fir_count(net) -> int:
    """FIR forwards that remat's recompute adds to a train step's backward,
    from the heads' structure: each decoder stage of each branch reruns its
    up-conv's blur, whose output the backward of the noise injection and
    leaky ReLU after it needs; the ToRGB's upsample of the skip saves no
    tensor, so the recompute stops before it (torch.utils.checkpoint's
    early stop). One a stage and branch: ``len(convs1)`` a head (two
    StyledConvs a stage, two branches)."""
    return sum(len(h.convs1) for h in (net.position_net, net.other_net,
                                       net.color_net))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2])
def test_remat_step_equals_no_remat_at_full_width(full_width, train_kw, b):
    from animatablegaussians_torch.tools import render_fixture as rf
    net, items, fixture = full_width
    gen = torch.Generator(device=items["extr"].device).manual_seed(20)
    if b == 1:
        step, batch = tat.make_train_step(net, **train_kw), items
        draws = tat.make_draws(gen, net.n_points)
    else:
        step = tat.make_train_step_batched(net, **train_kw)
        batch = rf.sequence({k: items[k] for k in rf.TRAIN_KEYS}, b)
        draws = [tat.make_draws(gen, net.n_points) for _ in range(b)]
    runs = {}
    try:
        for on in (False, True):
            _set_remat(net, on)
            net.load_state_dict(fixture)
            state = tat.make_train_state(net, rf.LR_INIT, rf.ITER_NUM)
            with cudnn_deterministic(), fir_calls() as calls:
                terms = step.loss_and_grads(state, batch, draws)
            runs[on] = (terms, grad_snapshot(net),
                        by_direction(calls, (0, 1)))
            net.zero_grad(set_to_none=True)
    finally:
        _set_remat(net, False)
    n_fir, n_fir_grad = fir_count(net)
    assert runs[False][2] == {0: n_fir, 1: n_fir_grad}
    assert runs[True][2] == {0: n_fir + _remat_fir_count(net),
                             1: n_fir_grad}
    assert_step_matches(net, runs[True][:2], runs[False][:2],
                        RTOL_REMAT_LOSS, RTOL_REMAT_GRAD)


@pytest.mark.gpu
@torch.no_grad()
def test_remat_render_is_bitwise_at_full_width(full):
    from animatablegaussians_torch.tools import render_fixture as rf
    net, items = full
    renders = {}
    try:
        for on in (False, True):
            _set_remat(net, on)
            with cudnn_deterministic():
                renders[on] = net.render(items, img_w=rf.IMG_W,
                                         img_h=rf.IMG_H)
    finally:
        _set_remat(net, False)
    for k in ("rgb_map", "mask_map", "depth_map"):
        assert torch.equal(renders[True][k], renders[False][k]), k


@pytest.mark.gpu
def test_random_style_step_kernels_match_plain_at_full_width(full,
                                                             train_kw):
    """Step 0 through the kernels against ``plain=True`` (the tolerances of
    tests/test_torch_train.py's gpu tests), a style draw that differs
    between two steps, the next step finite."""
    from animatablegaussians_torch.tools import render_fixture as rf
    net, items = full
    gen = torch.Generator(device=items["extr"].device).manual_seed(20)
    net.random_style = True
    try:
        sd = tat.draws_style_dim(net)
        d1, d2 = (tat.make_draws(gen, net.n_points, sd) for _ in range(2))
        res = []
        for plain in (True, False):
            state = tat.make_train_state(net, rf.LR_INIT, rf.ITER_NUM)
            step = tat.make_train_step(net, plain=plain, **train_kw)
            res.append((step.loss_and_grads(state, items, d1),
                        grad_snapshot(net)))
        assert_step_matches(net, res[1], res[0])
        state, terms = step(state, items, d2)
        assert finite(terms), terms
        assert not torch.equal(d1["style"], d2["style"])
    finally:
        net.random_style = False
