"""The port's batched train step and train scans against the JAX package on
the CPU: make_train_step_batched at B = 2 against the JAX batched step
(loss terms, the parameters after two Adam steps), B = 1 against the
single step (exact), the B = 2 gradient against the mean of two single
steps, and both scans against the host loop of their steps (exact).

The JAX weights are carried across with ``params_from_jax`` and
``lpips_from_jax``; each item's random draws are made from the JAX batched
step's own key splits (avatar_trainer.py:230-244) and handed to the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatablegaussians_tpu.models import styleunet as jsu
from animatablegaussians_tpu.models.avatar import AvatarNet as JAvatarNet
from animatablegaussians_tpu.ops.rasterize import RasterizeConfig
from animatablegaussians_tpu.training import avatar_trainer as jat
from animatablegaussians_tpu.training import lpips as jlp
from animatablegaussians_tpu.utils import synthetic as jsyn
from animatablegaussians_torch.models.avatar import AvatarNet as TAvatarNet
from animatablegaussians_torch.training import avatar_trainer as tat
from animatablegaussians_torch.training import lpips as tlp
from animatablegaussians_torch.utils.convert import (lpips_from_jax,
                                                      params_from_jax)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

MAP_H, IMG, PATCH = 64, 64, 32
LOSS_WEIGHT = dict(l1=1.0, mask=0.1, lpips=0.1, offset=0.005)
LR, ITER_NUM = 5e-4, 100
# as tests/test_torch_train.py: Adam moves an element by about lr per step
# whatever the size of its gradient, so the parameters are compared in
# units of lr
PARAM_ATOL_LR = 0.25


@pytest.fixture(autouse=True)
def _highest_precision():
    prev = jsu.CONV_PRECISION
    jsu.set_conv_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield
    jsu.set_conv_precision(prev)


def _params_np(params):
    p = dict(params)
    p["cano_gaussian"] = dataclasses.asdict(params["cano_gaussian"])
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def tiny():
    pos, nml, lbs = jsyn.make_cano_map(map_h=MAP_H)
    opt = {"with_viewdirs": True, "channel_max": 32}
    # caps that drop nothing (n_overflow is checked per step)
    jnet = JAvatarNet(opt, pos, lbs, cano_nml_map=nml,
                      raster_config=RasterizeConfig(
                          backend="ref", k_max=4096, max_dup=64,
                          max_active_tiles=0))
    params = jnet.init(jax.random.PRNGKey(0))
    # the position/other heads' ToRGB scaled down, as test_torch_train.py's
    # fixture: the Gaussians stay near their canonical attributes
    for name in ("position_net", "other_net"):
        for branch in ("to_rgbs1", "to_rgbs2"):
            for p in params[name][branch]:
                p["conv"]["weight"] = 0.05 * p["conv"]["weight"]
    items = [jsyn.make_items(img_w=IMG, img_h=IMG, seed=s, cano_pos_map=pos)
             for s in range(4)]
    for it in items:
        it["boundary_mask_img"][6:10, :] = 1.0
    lp_params = jlp.init_random(jax.random.PRNGKey(7))
    return dict(pos=pos, nml=nml, lbs=lbs, opt=opt, jnet=jnet, params=params,
                items=items, lp_params=lp_params,
                lpips=tlp.LPIPS(lpips_from_jax(jax.tree_util.tree_map(
                    np.asarray, lp_params)), device="cpu"))


def _port_net(tiny):
    net = TAvatarNet(tiny["opt"], tiny["pos"], tiny["lbs"],
                     cano_nml_map=tiny["nml"], device="cpu")
    net.load_state_dict(params_from_jax(_params_np(tiny["params"])))
    return net


def _batch(items_list):
    return {k: torch.as_tensor(np.stack([it[k] for it in items_list]))
            for k in items_list[0]}


def _draws(rng, n_points):
    """The draws of one item of the JAX batched step from its key
    (avatar_trainer.py:231-244, avatar.py:319-320, losses.py:116-118)."""
    rng_bg, rng_net, rng_crop = jax.random.split(rng, 3)
    vd_rng = jax.random.split(rng_net)[1]
    kv, ku = jax.random.split(rng_crop)
    return dict(
        bg=torch.tensor(np.asarray(jax.random.uniform(rng_bg, (3,)))),
        viewdir_noise=torch.tensor(np.asarray(
            jax.random.normal(vd_rng, (n_points, 3)))),
        crop=(float(jax.random.uniform(kv)), float(jax.random.uniform(ku))))


def _kw(**over):
    return dict(dict(loss_weight=LOSS_WEIGHT, patch_size=PATCH,
                     random_patch_after=1, img_w=IMG, img_h=IMG), **over)


def test_batched_step_matches_jax(tiny):
    """Two B = 2 steps on both sides with the same draws (the second takes
    the random LPIPS crop): every loss term of each step, then the
    parameters after the two Adam updates."""
    jnet, params = tiny["jnet"], tiny["params"]
    jbatch = {k: jnp.asarray(v) for k, v in
              jsyn.batch_items(tiny["items"][:2]).items()}
    keys = [jax.random.split(jax.random.PRNGKey(20 + i), 2) for i in range(2)]
    opt = jat.make_optimizer(lr_init=LR, iter_num=ITER_NUM)
    jstate = jat.TrainState(params, opt.init(params),
                            jnp.zeros((), jnp.int32))
    jstep = jat.make_train_step_batched(jnet, opt,
                                        lpips_params=tiny["lp_params"],
                                        donate=False, **_kw())
    net = _port_net(tiny)
    state = tat.make_train_state(net, LR, ITER_NUM)
    step = tat.make_train_step_batched(net, lpips=tiny["lpips"], **_kw())
    batch = _batch(tiny["items"][:2])
    for rngs in keys:
        jstate, jterms = jstep(jstate, jbatch, rngs)
        assert int(jterms["n_overflow"]) == 0
        state, terms = step(state, batch,
                            [_draws(k, net.n_points) for k in rngs])
        assert terms.keys() == {k for k in jterms
                                if k not in ("n_overflow", "n_pairs")}
        for k, v in terms.items():
            # float32 CNN and splat on both sides (JAX folds its resampling
            # chains), each term a mean over the batch
            np.testing.assert_allclose(float(v), float(jterms[k]), rtol=1e-4,
                                       err_msg=k)
    assert state.iter_idx == 2 == int(jstate.iter_idx)
    want = params_from_jax(_params_np(jstate.params))
    for name, p in net.named_parameters():
        if p.numel():
            d = np.abs(p.detach().numpy() - want[name].numpy()) / LR
            assert d.max() <= PARAM_ATOL_LR, name


def _grads(net):
    return {n: p.grad.clone() for n, p in net.named_parameters()
            if p.grad is not None}


def test_batched_b1_equals_single_step(tiny):
    """B = 1: the same loss terms and gradients as make_train_step, bit
    for bit (one-frame batches of the same ops, a mean over one item)."""
    net = _port_net(tiny)
    state = tat.make_train_state(net, LR, ITER_NUM)
    items = tiny["items"][0]
    draws = _draws(jax.random.PRNGKey(3), net.n_points)
    single = tat.make_train_step(net, lpips=tiny["lpips"], **_kw())
    batched = tat.make_train_step_batched(net, lpips=tiny["lpips"], **_kw())
    t1 = single.loss_and_grads(state, {k: torch.as_tensor(v)
                                       for k, v in items.items()}, draws)
    g1 = _grads(net)
    tb = batched.loss_and_grads(state, _batch([items]), [draws])
    gb = _grads(net)
    assert t1.keys() == tb.keys()
    for k in t1:
        assert torch.equal(t1[k], tb[k]), k
    assert g1.keys() == gb.keys()
    for n in g1:
        assert torch.equal(g1[n], gb[n]), n


def test_batched_b2_gradient_is_mean_of_single_steps(tiny):
    """The B = 2 loss and gradient are the means of the two items' single
    steps: the data-parallel semantics of the batched step."""
    net = _port_net(tiny)
    state = tat.make_train_state(net, LR, ITER_NUM)
    kw = _kw(random_patch_after=10_000)
    single = tat.make_train_step(net, lpips=tiny["lpips"], **kw)
    batched = tat.make_train_step_batched(net, lpips=tiny["lpips"], **kw)
    rngs = jax.random.split(jax.random.PRNGKey(9), 2)
    draws = [_draws(k, net.n_points) for k in rngs]
    terms, grads = [], []
    for it, d in zip(tiny["items"][:2], draws):
        terms.append(single.loss_and_grads(
            state, {k: torch.as_tensor(v) for k, v in it.items()}, d))
        grads.append(_grads(net))
    tb = batched.loss_and_grads(state, _batch(tiny["items"][:2]), draws)
    gb = _grads(net)
    np.testing.assert_allclose(
        float(tb["total_loss"]),
        0.5 * (float(terms[0]["total_loss"]) + float(terms[1]["total_loss"])),
        rtol=1e-6)
    for n, g in gb.items():
        # float32: the batch-2 convs sum their weight gradients over the
        # items in another order than two batch-1 passes and an average
        np.testing.assert_allclose(g.numpy(),
                                   0.5 * (grads[0][n] + grads[1][n]).numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("batched", [False, True])
def test_scan_equals_host_loop(tiny, batched):
    """make_train_scan (one example, a single step) and
    make_train_scan_batched (its own B = 2 batch per step) against the same
    steps in a host loop from the same start: the same terms, stacked, and
    the same parameters, bit for bit."""
    n_steps = 2
    runs = []
    for use_scan in (True, False):
        net = _port_net(tiny)
        state = tat.make_train_state(net, LR, ITER_NUM)
        draws = [_draws(jax.random.PRNGKey(30 + i), net.n_points)
                 for i in range(2 * n_steps)]
        if batched:
            step = tat.make_train_step_batched(net, lpips=tiny["lpips"],
                                               **_kw())
            data = [_batch(tiny["items"][2 * i:2 * i + 2])
                    for i in range(n_steps)]
            step_draws = [draws[2 * i:2 * i + 2] for i in range(n_steps)]
        else:
            step = tat.make_train_step(net, lpips=tiny["lpips"], **_kw())
            data = [{k: torch.as_tensor(v)
                     for k, v in tiny["items"][0].items()}] * n_steps
            step_draws = draws[:n_steps]
        if use_scan and batched:
            stacked = {k: torch.stack([d[k] for d in data]) for k in data[0]}
            state, terms = tat.make_train_scan_batched(step)(
                state, stacked, step_draws)
        elif use_scan:
            state, terms = tat.make_train_scan(step)(state, data[0],
                                                     step_draws)
        else:
            seq = []
            for d, dr in zip(data, step_draws):
                state, t = step(state, d, dr)
                seq.append(t)
            terms = {k: torch.stack([t[k] for t in seq]) for k in seq[0]}
        assert state.iter_idx == n_steps
        runs.append((terms, {n: p.detach().clone()
                             for n, p in net.named_parameters()}))
    (t_scan, p_scan), (t_loop, p_loop) = runs
    assert t_scan.keys() == t_loop.keys()
    for k in t_scan:
        assert t_scan[k].shape == (n_steps,)
        assert torch.equal(t_scan[k], t_loop[k]), k
    for n in p_scan:
        assert torch.equal(p_scan[n], p_loop[n]), n
