"""The port's avatar train step against the JAX package on the CPU: the
losses and the LPIPS crop, LPIPS, one DualStyleUNet's gradients, the
whole train step (loss terms, every parameter group's gradient, the
parameters after three Adam steps), the pretrain step, finetune_color, and
a subprocess check that a train step imports no jax.

Both sides get the same numbers: the JAX weights are carried across with
``params_from_jax`` and ``lpips_from_jax``, and the step's random draws are
made from the JAX package's own key splits and handed to the port."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatablegaussians_tpu.models import styleunet as jsu
from animatablegaussians_tpu.models.avatar import AvatarNet as JAvatarNet
from animatablegaussians_tpu.ops.rasterize import RasterizeConfig
from animatablegaussians_tpu.training import avatar_trainer as jat
from animatablegaussians_tpu.training import losses as jL
from animatablegaussians_tpu.training import lpips as jlp
from animatablegaussians_tpu.utils import synthetic as jsyn
from animatablegaussians_torch.models import styleunet as tsu
from animatablegaussians_torch.models.avatar import AvatarNet as TAvatarNet
from animatablegaussians_torch.training import avatar_trainer as tat
from animatablegaussians_torch.training import losses as tL
from animatablegaussians_torch.training import lpips as tlp
from animatablegaussians_torch.utils.convert import (dual_styleunet_state,
                                                      lpips_from_jax,
                                                      params_from_jax)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

MAP_H, IMG, PATCH = 64, 64, 32
LOSS_WEIGHT = dict(l1=1.0, lpips=0.1, offset=0.005)
LR, ITER_NUM = 5e-4, 100
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# ---------------------------------------------------------------------------
# 5. losses, the LPIPS crop and LPIPS, value and gradient
# ---------------------------------------------------------------------------

def _vjp_pair(jfn, tfn, args, seed=0):
    """Value and input gradients of a JAX function and its port on the
    same numpy inputs and the same numpy output cotangent."""
    want, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    cot = np.random.default_rng(seed).standard_normal(
        np.shape(want)).astype(np.float32)
    want_g = vjp(jnp.asarray(cot))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    got = tfn(*ts)
    got.backward(torch.as_tensor(cot))
    return (got.detach().numpy(), np.asarray(want),
            [t.grad.numpy() for t in ts], [np.asarray(g) for g in want_g])


def _mask_img(h, w, box, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    mask = np.zeros((h, w), np.float32)
    mask[box[0]:box[1], box[2]:box[3]] = 1.0
    return img, mask


@pytest.mark.parametrize("box,patch,crop", [
    ((10, 58, 9, 35), 32, None),        # 48x26 bbox -> 32: downscale
    ((20, 36, 12, 30), 32, None),       # 16x18 bbox -> 32: upscale
    ((10, 58, 9, 45), 16, "draws"),     # random window, injected (fv, fu)
])
def test_crop_to_mask_matches_jax(box, patch, crop):
    """crop_to_mask on a downscale (antialiased triangle kernel, widened
    by 1/scale), an upscale, and the random window with the JAX package's
    (fv, fu) draws handed over."""
    img, mask = _mask_img(64, 48, box)
    rng = None
    tcrop = None
    if crop:
        rng = jax.random.PRNGKey(5)
        kv, ku = jax.random.split(rng)
        tcrop = (float(jax.random.uniform(kv)), float(jax.random.uniform(ku)))
    got, want, gg, gw = _vjp_pair(
        lambda a: jL.crop_to_mask(a, jnp.asarray(mask), patch, rng=rng),
        lambda a: tL.crop_to_mask(a, torch.as_tensor(mask), patch,
                                  crop=tcrop), [img])
    assert got.shape == (patch, patch, 3)
    # float32 resampling matrices built by the same formula; the products
    # sum in another order: a few ulps of [0, 1] images
    np.testing.assert_allclose(got, want, atol=2e-6)
    np.testing.assert_allclose(gg[0], gw[0], atol=2e-6)


def test_offset_and_pixel_losses_match_jax():
    """offset_loss (with exactly-zero rows: zero, not NaN, gradient), the
    L1, mask and SSIM losses, value and gradient."""
    rng = np.random.default_rng(1)
    off = rng.standard_normal((20, 3)).astype(np.float32)
    off[::3] = 0.0
    got, want, gg, gw = _vjp_pair(jL.offset_loss, tL.offset_loss, [off])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.isfinite(gg[0]).all()
    np.testing.assert_array_equal(gg[0][::3], 0.0)
    np.testing.assert_allclose(gg[0], gw[0], atol=1e-6)

    a = rng.uniform(0, 1, (24, 20, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (24, 20, 3)).astype(np.float32)
    wgt = (rng.uniform(0, 1, (24, 20, 1)) > 0.3).astype(np.float32)
    for jfn, tfn in ((jL.l1_loss, tL.l1_loss), (jL.mask_loss, tL.mask_loss),
                     (jL.ssim_loss, tL.ssim_loss)):
        args = [a, b, wgt] if jfn is not jL.ssim_loss else [a, b]
        got, want, gg, gw = _vjp_pair(jfn, tfn, args)
        # float32 means and (SSIM) 7x7 box filters summed in another order
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        for x, y in zip(gg, gw):
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def lpips_pair():
    params = jlp.init_random(jax.random.PRNGKey(7))
    return params, tlp.LPIPS(lpips_from_jax(_np(params)), device="cpu")


def test_lpips_matches_jax(lpips_pair):
    """LPIPS value and input gradient on two 32x32 images. Both sides pool
    with the reshape-max form, whose gradient splits an exact tie equally;
    but with random weights some inputs put two activations of a 2x2 window
    within rounding of each other, and the two sides then send the
    gradient to different winners (seed 2 of this shape does, 0.2% off).
    These inputs have no such window."""
    params, tmod = lpips_pair
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    y = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    got, want, gg, gw = _vjp_pair(
        lambda a, b: jlp.lpips(params, a, b), lambda a, b: tmod(a, b),
        [x, y])
    # thirteen float32 3x3 convolutions, summed in another order
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for a, b in zip(gg, gw):
        assert _rel(a, b) < 1e-5
    assert not any(p.requires_grad for p in tmod.parameters())


def test_lpips_torch_weight_files_match_jax_loader(tmp_path, lpips_pair):
    """load_torch_weights reads the torchvision vgg16 / LPIPS lin file
    layout into the same weights as the JAX package's loader."""
    params, tmod = lpips_pair
    sd = tmod.state_dict()
    vgg, lin, idx = {}, {}, 0
    for i in range(13):
        vgg[f"features.{idx}.weight"] = sd[f"convs.{i}.weight"]
        vgg[f"features.{idx}.bias"] = sd[f"convs.{i}.bias"]
        idx += 2 + (i in (1, 3, 6, 9))
    for i in range(5):
        lin[f"lin{i}.model.1.weight"] = sd[f"lins.{i}"].reshape(1, -1, 1, 1)
    torch.save(vgg, tmp_path / "vgg16.pth")
    torch.save(lin, tmp_path / "lin.pth")
    got = tlp.load_torch_weights(str(tmp_path / "vgg16.pth"),
                                 str(tmp_path / "lin.pth"))
    want = lpips_from_jax(_np(jlp.load_torch_weights(
        str(tmp_path / "vgg16.pth"), str(tmp_path / "lin.pth"))))
    assert got.keys() == want.keys() == sd.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
        np.testing.assert_array_equal(got[k].numpy(), sd[k].numpy())


# ---------------------------------------------------------------------------
# 4. one DualStyleUNet: input and parameter gradients
# ---------------------------------------------------------------------------

def test_dual_styleunet_gradients_match_jax():
    """Input and every parameter's gradient of one DualStyleUNet (32^2 ->
    64^2, channel_max 32) against jax.vjp, for one numpy cotangent. The
    noise buffers get none (JAX: stop_gradient). View features join the
    decoder after its fifth stage and reach the output only through a
    sixth (out_size 1024), which a CPU-sized net does not have; the GPU
    run's train phase holds that path's gradient, viewdir_net's, between
    the kernel and the plain splat."""
    kw = dict(inp_size=32, inp_ch=3, out_ch=3, out_size=64, style_dim=32,
              n_mlp=2, channel_max=32)
    jnet = jsu.DualStyleUNet(**kw)
    params = jnet.init(jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    leaves = [l + 0.1 * jax.random.normal(k, l.shape) if l.ndim <= 1 else l
              for l, k in zip(leaves, keys)]
    params = _np(jax.tree_util.tree_unflatten(treedef, leaves))
    tnet = tsu.DualStyleUNet(**kw)
    tnet.load_state_dict(dual_styleunet_state(params))

    rng = np.random.default_rng(3)
    style = rng.standard_normal((1, 32)).astype(np.float32)
    cond = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    out, vjp = jax.vjp(lambda p, c: jnet.apply(p, jnp.asarray(style), c),
                       jax.tree_util.tree_map(jnp.asarray, params),
                       jnp.asarray(cond))
    cot = rng.standard_normal(out.shape).astype(np.float32)
    gp, gc = _np(vjp(jnp.asarray(cot)))

    cond_t = torch.tensor(cond, requires_grad=True)
    got = tnet(torch.as_tensor(style), cond_t)
    got.backward(torch.as_tensor(cot))
    # float32 on both sides; the JAX side folds its resampling chains into
    # polyphase convolutions, so sums run in another order
    assert _rel(cond_t.grad.numpy(), gc) < 1e-5
    want = dual_styleunet_state(gp)
    named = dict(tnet.named_parameters())
    assert set(named) == {k for k in want if not k.startswith("noises.")}
    for name, p in named.items():
        assert _rel(p.grad.numpy(), want[name].numpy()) < 1e-4, name
    assert not any(b.requires_grad for b in tnet.noises.buffers())


# ---------------------------------------------------------------------------
# 6. the whole train step, the pretrain step, finetune_color
# ---------------------------------------------------------------------------

def _tiny_params(jnet):
    """JAX init with the position/other heads' ToRGB weights scaled by
    0.05: the Gaussians stay near their create_from_pcd attributes, as in
    the bench fixture, while every layer still gets a gradient."""
    params = jnet.init(jax.random.PRNGKey(0))
    for name in ("position_net", "other_net"):
        for branch in ("to_rgbs1", "to_rgbs2"):
            for p in params[name][branch]:
                p["conv"]["weight"] = 0.05 * p["conv"]["weight"]
    return params


@pytest.fixture(scope="module")
def tiny():
    pos, nml, lbs = jsyn.make_cano_map(map_h=MAP_H)
    opt = {"with_viewdirs": True, "channel_max": 32}
    # caps that drop nothing (n_overflow is checked per step)
    jnet = JAvatarNet(opt, pos, lbs, cano_nml_map=nml,
                      raster_config=RasterizeConfig(
                          backend="ref", k_max=4096, max_dup=64,
                          max_active_tiles=0))
    params = _tiny_params(jnet)
    items = jsyn.make_items(img_w=IMG, img_h=IMG, cano_pos_map=pos)
    # a boundary band, so the band masking is exercised
    items["boundary_mask_img"][6:10, :] = 1.0
    lp_params = jlp.init_random(jax.random.PRNGKey(7))
    return dict(pos=pos, nml=nml, lbs=lbs, opt=opt, jnet=jnet, params=params,
                items=items, lp_params=lp_params,
                lpips=tlp.LPIPS(lpips_from_jax(_np(lp_params)), device="cpu"))


def _port_net(tiny):
    net = TAvatarNet(tiny["opt"], tiny["pos"], tiny["lbs"],
                     cano_nml_map=tiny["nml"], device="cpu")
    net.load_state_dict(params_from_jax(_params_np(tiny["params"])))
    return net


def _draws(rng, n_points):
    """The JAX step's own draws from ``rng`` (avatar_trainer.py:126-128,
    avatar.py:430-432 and :319-320, losses.py:116-118), as the port's
    ``draws``."""
    rng_bg, rng_net, rng_crop = jax.random.split(rng, 3)
    vd_rng = jax.random.split(rng_net)[1]
    kv, ku = jax.random.split(rng_crop)
    return dict(
        bg=torch.tensor(np.asarray(jax.random.uniform(rng_bg, (3,)))),
        viewdir_noise=torch.tensor(np.asarray(
            jax.random.normal(vd_rng, (n_points, 3)))),
        crop=(float(jax.random.uniform(kv)), float(jax.random.uniform(ku))))


def _group_rel_errors(net, jgrads):
    """Relative L2 error of the port's gradients against the JAX ones, per
    top-level parameter group."""
    want = params_from_jax(_params_np(jgrads))
    groups = {}
    for name, p in net.named_parameters():
        g = p.grad
        if g is None:     # unused by the loss (features_dc): JAX gives 0
            np.testing.assert_array_equal(want[name].numpy(), 0.0)
            continue
        got_w = groups.setdefault(name.split(".")[0], ([], []))
        got_w[0].append(g.numpy().ravel())
        got_w[1].append(want[name].numpy().ravel())
    return {k: _rel(np.concatenate(a), np.concatenate(b))
            for k, (a, b) in groups.items()}


# Where the gradient of every group must agree: float32 on both sides, the
# JAX CNN with polyphase resampling against the port's chains (sums in
# another order); measured 2.4e-6 at most. A splat decision (alpha >= 1/255,
# the 1e-4 cutoff) that flipped for a pixel within rounding of its
# threshold would show as a jump well above this.
GRAD_RTOL = 1e-4
# Adam moves each element by about lr sign(g) per step, whatever |g|: an
# element whose gradient sits near zero could take the other sign on the
# other side, a jump of ~2 lr per step. None does here (largest 0.06 lr
# after three steps); elsewhere the steps agree to a small fraction of lr.
PARAM_ATOL_LR = 0.25


def test_train_step_matches_jax(tiny):
    """Step 0 of make_train_step on both sides with the same draws: loss
    terms and every parameter group's gradient; then the parameters after
    three Adam steps (steps 1-2 take the random LPIPS crop)."""
    jnet, params, items = tiny["jnet"], tiny["params"], tiny["items"]
    kw = dict(loss_weight=LOSS_WEIGHT, patch_size=PATCH,
              random_patch_after=1, img_w=IMG, img_h=IMG)
    jitems = {k: jnp.asarray(v) for k, v in items.items()}
    titems = {k: torch.as_tensor(v) for k, v in items.items()}
    rngs = [jax.random.PRNGKey(10 + i) for i in range(3)]

    # JAX: the gradient of step 0, then three steps of make_train_step
    def loss(p, it, rng):
        return jat.compute_losses(jnet, p, it, rng, jnp.zeros((), jnp.int32),
                                  lpips_params=tiny["lp_params"], **kw)
    (_, jterms), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, jitems, rngs[0])
    opt = jat.make_optimizer(lr_init=LR, iter_num=ITER_NUM)
    jstate = jat.TrainState(params, opt.init(params),
                            jnp.zeros((), jnp.int32))
    jstep = jat.make_train_step(jnet, opt, lpips_params=tiny["lp_params"],
                                donate=False, **kw)
    for rng in rngs:
        jstate, t = jstep(jstate, jitems, rng)
        assert int(t["n_overflow"]) == 0

    net = _port_net(tiny)
    state = tat.make_train_state(net, LR, ITER_NUM)
    step = tat.make_train_step(net, lpips=tiny["lpips"], **kw)
    terms = step.loss_and_grads(state, titems, _draws(rngs[0], net.n_points))
    assert terms.keys() == {k for k in jterms
                            if k not in ("n_overflow", "n_pairs")}
    for k, v in terms.items():
        # float32 CNN and splat as above, reduced to one scalar each
        np.testing.assert_allclose(float(v), float(jterms[k]), rtol=1e-4,
                                   err_msg=k)
    errs = _group_rel_errors(net, jgrads)
    # viewdir_net has no gradient on either side at this size (see
    # test_dual_styleunet_gradients_match_jax)
    assert set(errs) == {"color_net", "position_net", "other_net",
                         "cano_gaussian"}
    assert max(errs.values()) < GRAD_RTOL, errs

    before = {k: v.detach().clone() for k, v in net.state_dict().items()}
    for rng in rngs:
        state, _ = step(state, titems, _draws(rng, net.n_points))
    assert state.iter_idx == 3 == int(jstate.iter_idx)
    want = params_from_jax(_params_np(jstate.params))
    diffs = []
    for name, p in net.named_parameters():
        if p.numel() == 0:      # features_rest at SH degree 0
            continue
        d = np.abs(p.detach().numpy() - want[name].numpy()) / LR
        assert d.max() <= PARAM_ATOL_LR, name
        diffs.append(d.ravel())
        moved = np.abs(p.detach().numpy() - before[name].numpy()).max()
        # features_dc is unused by the loss, viewdir_net unreached at this
        # size: neither has a gradient on either side
        assert moved > 0 or name.startswith(
            ("viewdir_net.", "cano_gaussian.features_dc")), name
    assert np.quantile(np.concatenate(diffs), 0.999) < 1e-3


def test_pretrain_step_matches_jax(tiny):
    """Two pretrain steps: the loss terms and the parameters against
    make_pretrain_step."""
    jnet, params = tiny["jnet"], tiny["params"]
    pose_map = np.asarray(tiny["pos"])[:, :MAP_H][::2, ::2]
    opt = jat.make_optimizer(lr_init=LR, iter_num=ITER_NUM)
    jstate = jat.TrainState(params, opt.init(params),
                            jnp.zeros((), jnp.int32))
    jstep = jat.make_pretrain_step(jnet, opt)
    net = _port_net(tiny)
    state = tat.make_train_state(net, LR, ITER_NUM)
    step = tat.make_pretrain_step(net)
    for _ in range(2):
        jstate, jterms = jstep(jstate, jnp.asarray(pose_map))
        state, terms = step(state, torch.as_tensor(pose_map))
        for k, v in terms.items():
            # float32 heads and a masked mean over ~2k points
            np.testing.assert_allclose(float(v), float(jterms[k]),
                                       rtol=1e-4, err_msg=k)
    want = params_from_jax(_params_np(jstate.params))
    for name, p in net.named_parameters():
        if p.numel() == 0:
            continue
        d = np.abs(p.detach().numpy() - want[name].numpy()) / LR
        assert d.max() <= PARAM_ATOL_LR, name


def test_finetune_color_leaves_position_net(tiny):
    """finetune_color: the position net is out of the optimizer, so its
    weights stay bit-identical while the others move."""
    net = _port_net(tiny)
    before = {k: v.detach().clone() for k, v in net.state_dict().items()}
    state = tat.make_train_state(net, LR, ITER_NUM, finetune_color=True)
    step = tat.make_train_step(net, loss_weight=dict(l1=1.0, offset=0.005),
                               img_w=IMG, img_h=IMG)
    titems = {k: torch.as_tensor(v) for k, v in tiny["items"].items()}
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        state, _ = step(state, titems, tat.make_draws(gen, net.n_points))
    after = net.state_dict()
    for k, v in before.items():
        same = torch.equal(v, after[k])
        if k.startswith("position_net."):
            assert same, k
    assert not torch.equal(before["color_net.conv_in.1.weight"],
                           after["color_net.conv_in.1.weight"])


def test_cosine_lr_matches_jax():
    sched = tat.cosine_lr(LR, ITER_NUM)
    jsched = jat.cosine_lr(LR, ITER_NUM)
    for t in (0, 1, 37, 50, 99, 100, 250):
        np.testing.assert_allclose(sched(t), float(jsched(jnp.asarray(t))),
                                   rtol=1e-6)


def test_port_trains_without_jax():
    """A train step and a pretrain step of the port on the CPU load no jax
    module."""
    code = (
        "import sys, torch\n"
        "from animatablegaussians_torch.tools import render_fixture as rf\n"
        "from animatablegaussians_torch.training import avatar_trainer as at\n"
        "from animatablegaussians_torch.training import lpips as lp\n"
        "net, items = rf.build('cpu', map_h=64, img_w=32, img_h=32, "
        "channel_max=8, keys=rf.TRAIN_KEYS)\n"
        "state = at.make_train_state(net, 5e-4, 100)\n"
        "step = at.make_train_step(net, loss_weight=rf.LOSS_WEIGHT, "
        "lpips=lp.LPIPS(lp.init_random(7), device='cpu'), patch_size=16, "
        "img_w=32, img_h=32)\n"
        "gen = torch.Generator().manual_seed(0)\n"
        "state, terms = step(state, items, at.make_draws(gen, net.n_points))\n"
        "state, _ = at.make_pretrain_step(net)(state, "
        "items['smpl_pos_map'][..., :3])\n"
        "assert torch.isfinite(terms['total_loss'])\n"
        "assert state.iter_idx == 2\n"
        "mods = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'animatablegaussians_tpu'))]\n"
        "assert not mods, mods\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
