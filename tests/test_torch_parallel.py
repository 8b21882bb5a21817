"""The port's data-parallel route and the ``model.module`` hook on the CPU:
the DP step on two gloo ranks against the JAX package's
``make_dp_train_step`` over a 2-device mesh (of conftest's 8 host
devices), DP on two copies of one item against the single step and the DP
scan against its steps; ``AvatarTrainer`` under two gloo ranks through
``main_avatar_torch -m train`` (the ranks end equal, rank 0 alone writes,
the checkpoint keeps the single process's names, and a config naming a
JAX module never imports jax); ``model.module`` with a port path, a JAX
path and a test module's subclass; the loader's rank blocks.

Each rank is a ``python -c`` subprocess with one torch thread, a
``file://`` rendezvous under ``tmp_path`` and a timeout of its own; the
ranks import nothing of JAX.

Marked ``gpu`` (skipped without a CUDA device): the data-parallel step on
a one-rank NCCL group at full width (the reduction leaves the rank's
gradients bit for bit; against make_train_step on the same item and
draws, the losses bit for bit and the gradients within RTOL_DP_GRAD),
and ``main_avatar_torch -m train`` under torchrun's variables for a world
of one on a full-width capture (an NCCL group, the rank on cuda:0,
use_dp off, one epoch, epoch_latest's net.pt loading strictly into a
fresh AvatarNet, the group torn down)."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from animatablegaussians_tpu.models import styleunet as jsu
from animatablegaussians_tpu.models.avatar import AvatarNet as JAvatarNet
from animatablegaussians_tpu.ops.rasterize import RasterizeConfig
from animatablegaussians_tpu.parallel import (make_dp_train_step,
                                              make_mesh, shard_batch)
from animatablegaussians_tpu.parallel.data_parallel import replicate
from animatablegaussians_tpu.training import avatar_trainer as jat
from animatablegaussians_tpu.utils import synthetic as jsyn
from animatablegaussians_torch.data.loader import PrefetchLoader
from animatablegaussians_torch.models import avatar as port_avatar
from animatablegaussians_torch.tools import capture_fixture as cf
from animatablegaussians_torch.training import driver
from animatablegaussians_torch.utils.convert import params_from_jax

import main_avatar_torch
from test_torch_remat import tiny_params
from on_card import (DRIVER_FRAMES, DRIVER_PRETRAIN, card,  # noqa: F401
                     cudnn_deterministic, finite, full, full_width,
                     grad_errors, grad_snapshot, train_kw, write_capture,
                     write_config)

MAP_H, IMG, LR, ITER_NUM = 64, 64, 5e-4, 100
STEP_KW = dict(loss_weight=dict(l1=1.0, offset=0.005), img_w=IMG, img_h=IMG)
# float32 on both sides, sums in another order (tests/test_torch_train.py's
# limits); Adam's first step moves each element by about lr sign(g), so
# the parameters after it agree to a fraction of lr unless a gradient sits
# at zero
RTOL_LOSS, GRAD_RTOL, PARAM_ATOL_LR = 1e-4, 1e-4, 0.25
RANK_TIMEOUT = 240      # seconds a rank may take before the test fails
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


def _run_ranks(code: str, work: str, world: int = 2, env=None) -> list:
    """Run ``code`` as ``world`` ranks at once (argv: work dir, rank),
    each with one torch thread; returns their stdout, failing on any
    rank's error or timeout."""
    base = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    base.update(OMP_NUM_THREADS="1", **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import torch\ntorch.set_num_threads(1)\n"
         + code, work, str(r)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(base, WORLD_SIZE=str(world), RANK=str(r),
                 LOCAL_RANK=str(r))) for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, f"rank {r}:\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    return outs


# ---------------------------------------------------------------------------
# the DP step against JAX's make_dp_train_step
# ---------------------------------------------------------------------------

DP_STEP_RANK = '''
import datetime, os, sys
import torch
import torch.distributed as dist
from animatablegaussians_torch.models.avatar import AvatarNet
from animatablegaussians_torch.parallel import data_parallel as dp
from animatablegaussians_torch.training import avatar_trainer as at

work, rank = sys.argv[1], int(sys.argv[2])
inp = torch.load(os.path.join(work, "inp.pt"), weights_only=False)
dp.GROUP_TIMEOUT = datetime.timedelta(seconds=120)
dev = dp.init_group("cpu", rank, 2, "file://" + os.path.join(work, "rdv"))
assert dev == torch.device("cpu") and dist.get_backend() == "gloo"
net = AvatarNet(inp["opt"], inp["pos"], inp["lbs"], cano_nml_map=inp["nml"],
                device="cpu")
step = at.make_train_step(net, **inp["kw"])
dp_step = dp.make_dp_train_step(step)


def fresh():
    net.load_state_dict(inp["state"])
    return at.make_train_state(net, inp["lr"], inp["iter_num"])


def grads():
    return {n: p.grad.clone() for n, p in net.named_parameters()
            if p.grad is not None}


out = {}
items, draws = inp["items"], inp["draws"]
# this rank's own item: its single-step gradients, then the DP step's
state = fresh()
step.loss_and_grads(state, items[rank], draws[rank])
out["own_grads"] = grads()
state = fresh()
out["terms"] = dp_step.loss_and_grads(state, items[rank], draws[rank])
out["dp_grads"] = grads()
at.apply_update(state)
out["params"] = {k: v.clone() for k, v in net.state_dict().items()}
out["exp_avg"] = {n: state.optimizer.state[p]["exp_avg"].clone()
                  for n, p in net.named_parameters()
                  if p in state.optimizer.state}
# both ranks on item 0 with the same draws: the DP step is the single step
state = fresh()
single = step.loss_and_grads(state, items[0], draws[0])
g_single = grads()
state = fresh()
both = dp_step.loss_and_grads(state, items[0], draws[0])
out["same_item_equal"] = (
    all(torch.equal(both[k], v) for k, v in single.items())
    and all(torch.equal(g, g_single[n]) for n, g in grads().items()))
# the DP scan over two of this rank's items against two DP steps
seq = [items[rank], items[1 - rank]]
batch = {k: torch.stack([s[k] for s in seq]) for k in seq[0]}
state = fresh()
state, scan_terms = dp.make_dp_train_scan(step)(state, batch, draws[:2])
scanned = {k: v.clone() for k, v in net.state_dict().items()}
state = fresh()
loop = []
for s, d in zip(seq, draws[:2]):
    state, t = dp_step(state, s, d)
    loop.append(t)
out["scan_equal"] = (
    state.iter_idx == 2
    and all(torch.equal(v, net.state_dict()[k]) for k, v in scanned.items())
    and all(torch.equal(scan_terms[k], torch.stack([t[k] for t in loop]))
            for k in loop[0]))
torch.save(out, os.path.join(work, f"out{rank}.pt"))
dist.destroy_process_group()
'''


def _draws(rng, n_points):
    """The JAX step's own draws from ``rng`` (avatar_trainer.py:126-128,
    avatar.py:428-432 and :319-320, losses.py:116-118) as the port's."""
    rng_bg, rng_net, rng_crop = jax.random.split(rng, 3)
    vd_rng = jax.random.split(rng_net)[1]
    kv, ku = jax.random.split(rng_crop)
    return dict(
        bg=torch.tensor(np.asarray(jax.random.uniform(rng_bg, (3,)))),
        viewdir_noise=torch.tensor(np.asarray(
            jax.random.normal(vd_rng, (n_points, 3)))),
        crop=(float(jax.random.uniform(kv)), float(jax.random.uniform(ku))))


def test_dp_step_on_two_gloo_ranks_matches_jax(tmp_path):
    """Two ranks, each on its own item (two camera jitters), against JAX's
    make_dp_train_step over a 2-device mesh: the reduced loss terms
    against its pmean-ed terms; Adam's first moment after the step (0.1 x
    the reduced gradient) against its, per parameter group; the parameters
    after the update against its, equal on both ranks. The reduced
    gradients equal the mean of the ranks' own single-step gradients bit
    for bit. On two copies of one item the DP step
    equals the single step bit for bit (as tests/test_driver.py:123 holds
    for JAX), and the DP scan equals its steps."""
    pos, nml, lbs = jsyn.make_cano_map(map_h=MAP_H)
    opt = {"with_viewdirs": True, "channel_max": 32}
    jnet = JAvatarNet(opt, pos, lbs, cano_nml_map=nml,
                      raster_config=RasterizeConfig(
                          backend="ref", k_max=4096, max_dup=64,
                          max_active_tiles=0))
    params = tiny_params(opt, pos, lbs, nml)
    items = [jsyn.make_items(img_w=IMG, img_h=IMG, seed=i, cano_pos_map=pos)
             for i in range(2)]
    rngs = jax.random.split(jax.random.PRNGKey(5), 2)

    # JAX: the DP step over a 2-device mesh, and each item's gradient
    jopt = jat.make_optimizer(lr_init=LR, iter_num=ITER_NUM)
    mesh = make_mesh(2)
    dp_step = make_dp_train_step(
        jat.make_train_step(jnet, jopt, axis_name="data", **STEP_KW), mesh)
    state0 = jax.device_get(jat.TrainState(params, jopt.init(params),
                                           jnp.zeros((), jnp.int32)))
    jstate, jterms = dp_step(replicate(mesh, state0),
                             shard_batch(mesh, jsyn.batch_items(items)),
                             shard_batch(mesh, rngs))
    assert int(jstate.iter_idx) == 1 and int(jterms["n_overflow"]) == 0

    # Adam's first moment after one step is 0.1 x the pmean-ed gradient
    jmu = params_from_jax(_params_np(jstate.opt_state[0].mu))

    work = str(tmp_path)
    n_points = port_avatar.AvatarNet(opt, pos, lbs, cano_nml_map=nml,
                                     device="cpu").n_points
    torch.save(dict(
        opt=opt, pos=pos, lbs=lbs, nml=nml, kw=STEP_KW, lr=LR,
        iter_num=ITER_NUM, state=params_from_jax(_params_np(params)),
        items=[{k: torch.as_tensor(v) for k, v in it.items()}
               for it in items],
        draws=[_draws(r, n_points) for r in rngs]),
        os.path.join(work, "inp.pt"))
    _run_ranks(DP_STEP_RANK, work)
    outs = [torch.load(os.path.join(work, f"out{r}.pt"), weights_only=False)
            for r in range(2)]

    for r, out in enumerate(outs):
        assert out["same_item_equal"], r
        assert out["scan_equal"], r
        assert out["terms"].keys() == {k for k in jterms
                                       if k not in ("n_overflow", "n_pairs")}
        for k, v in out["terms"].items():
            np.testing.assert_allclose(float(v), float(jterms[k]),
                                       rtol=RTOL_LOSS, err_msg=k)
            assert torch.equal(v, outs[0]["terms"][k]), k
    mean_own = {n: (outs[0]["own_grads"][n] + outs[1]["own_grads"][n]) / 2
                for n in outs[0]["own_grads"]}
    groups = {}
    for n, g in outs[0]["dp_grads"].items():
        assert torch.equal(g, outs[1]["dp_grads"][n]), n
        assert torch.equal(g, mean_own[n]), n
        a, b = groups.setdefault(n.split(".")[0], ([], []))
        a.append(outs[0]["exp_avg"][n].numpy().ravel())
        b.append(jmu[n].numpy().ravel())
    errs = {k: _rel(np.concatenate(a), np.concatenate(b))
            for k, (a, b) in groups.items()}
    assert set(errs) == {"color_net", "position_net", "other_net",
                         "cano_gaussian"}
    assert max(errs.values()) < GRAD_RTOL, errs
    want = params_from_jax(_params_np(jstate.params))
    for k, v in outs[0]["params"].items():
        assert torch.equal(v, outs[1]["params"][k]), k
        if k in want and v.numel():
            d = (v - want[k]).abs().max() / LR
            assert d <= PARAM_ATOL_LR, k


# ---------------------------------------------------------------------------
# AvatarTrainer under two ranks, and the model.module hook
# ---------------------------------------------------------------------------

TRAINER_RANK = '''
import os, sys
import torch
from animatablegaussians_torch.parallel import data_parallel as dp
from animatablegaussians_torch.training import checkpoint as ck
from animatablegaussians_torch.training.driver import AvatarTrainer
import main_avatar_torch

work, rank = sys.argv[1], int(sys.argv[2])
# no TensorBoard: in this test environment its tensorflow imports jax
sys.modules["torch.utils.tensorboard"] = None
dp.GROUP_TIMEOUT = __import__("datetime").timedelta(seconds=120)
AvatarTrainer.PRETRAIN_ITERS = 2
saved = []
save = ck.save_checkpoint


def recorded(path, *args, **kw):
    saved.append(os.path.basename(path))
    return save(path, *args, **kw)


ck.save_checkpoint = recorded
trainer = main_avatar_torch.main(
    ["-c", os.path.join(work, "avatar.yaml"), "-m", "train", "--device",
     "cpu"], num_epochs=1, init_method="file://" + os.path.join(work, "rdv"))
assert not torch.distributed.is_initialized()
mods = [m for m in sys.modules
        if m == "jax" or m.startswith(("jax.", "animatablegaussians_tpu"))]
torch.save(dict(saved=saved, mods=mods, use_dp=trainer.use_dp,
                world=(trainer.rank, trainer.world_size),
                iter_idx=trainer.iter_idx, n_terms=len(trainer.terms),
                cls=type(trainer.avatar_net).__module__,
                state=trainer.avatar_net.state_dict()),
           os.path.join(work, f"out{rank}.pt"))
'''


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("capture"))
    return d, cf.write_capture(d)


def _make_opt(data_dir, smpl_path, ckpt_dir):
    """tests/test_torch_driver.py's config (no LPIPS) at 3 frames x 2
    cameras: 6 items, 3 global batches of 2."""
    return dict(
        train=dict(
            dataset="MvRgbDatasetAvatarReX",
            data=dict(data_dir=data_dir, frame_range=[0, 3],
                      used_cam_ids=[0, 1], load_smpl_pos_map=True,
                      smpl_model_path=smpl_path),
            net_ckpt_dir=ckpt_dir,
            ckpt_interval=dict(epoch=1, batch=2),
            eval_interval=2,
            eval_training_ids=[0, 0],
            lr_init=5e-4,
            loss_weight=dict(l1=1.0, offset=0.005),
            finetune_color=False,
            batch_size=1, num_workers=2, random_bg_color=True),
        model=dict(with_viewdirs=True, channel_max=32),
    )


def test_trainer_on_two_gloo_ranks(capture, tmp_path):
    """main_avatar_torch -m train --device cpu under WORLD_SIZE=2: each rank
    brings up a gloo group, trains data parallel (rank 0 alone runs the
    pretrain phase, the other takes its parameters) for one epoch of 3
    steps and tears the group down. Both ranks end with equal parameters;
    rank 0 alone writes the checkpoints, loss.txt and the snapshots; the
    net.pt has the single process's names (no ``module.``) and loads
    strictly into a fresh AvatarNet. The config names the JAX package's
    module, which maps to the port's: no rank imports jax (the ranks run
    without TensorBoard, whose tensorflow imports jax here)."""
    data_dir, smpl_path = capture
    work = str(tmp_path)
    opt = _make_opt(data_dir, smpl_path, os.path.join(work, "ckpt"))
    opt["model"]["module"] = "animatablegaussians_tpu.models.avatar"
    with open(os.path.join(work, "avatar.yaml"), "w") as fp:
        yaml.safe_dump(opt, fp)
    _run_ranks(TRAINER_RANK, work)
    outs = [torch.load(os.path.join(work, f"out{r}.pt"), weights_only=False)
            for r in range(2)]
    for r, out in enumerate(outs):
        assert out["mods"] == [], (r, out["mods"])
        assert out["use_dp"] and out["world"] == (r, 2)
        assert out["iter_idx"] == 3 and out["n_terms"] == 3
        assert out["cls"] == "animatablegaussians_torch.models.avatar"
    assert outs[0]["saved"] == ["pretrained", "batch_2", "epoch_latest"]
    assert outs[1]["saved"] == []
    sd = outs[0]["state"]
    assert sd.keys() == outs[1]["state"].keys()
    for k, v in sd.items():
        assert torch.equal(v, outs[1]["state"][k]), k
    base = opt["train"]["net_ckpt_dir"]
    for name in ("loss.txt", "config_bk.yaml", "eval/training_2.jpg"):
        assert os.path.exists(os.path.join(base, name)), name
    ckpt = torch.load(os.path.join(base, "epoch_latest", "net.pt"),
                      weights_only=True)
    assert ckpt["iter_idx"] == 3
    assert not any(k.startswith("module.") for k in ckpt["avatar_net"])
    fresh = driver.AvatarTrainer._build_net(data_dir, opt["model"], "cpu")
    fresh.load_state_dict(ckpt["avatar_net"], strict=True)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k


class AvatarNet(port_avatar.AvatarNet):
    """A test module's AvatarNet: the port's, marked."""
    marked = True


@pytest.mark.parametrize("module,cls", [
    ("animatablegaussians_torch.models.avatar", port_avatar.AvatarNet),
    ("animatablegaussians_tpu.models.avatar", port_avatar.AvatarNet),
    (__name__, AvatarNet),
])
def test_model_module_hook(capture, module, cls):
    """model.module names the module whose AvatarNet the driver builds with
    the port's constructor contract: a port path, a JAX package path
    (mapped to the port's module at the same path) and a test module's
    subclass; the default is the port's avatar module."""
    data_dir, _ = capture
    model = dict(with_viewdirs=True, channel_max=16, module=module)
    net = driver.AvatarTrainer._build_net(data_dir, model, "cpu")
    assert type(net) is cls
    assert driver.avatar_module(module).startswith(
        ("animatablegaussians_torch.", __name__))
    assert net.n_points > 0 and next(net.parameters()).device.type == "cpu"
    if module == __name__:
        assert net.marked
        default = driver.AvatarTrainer._build_net(
            data_dir, dict(with_viewdirs=True, channel_max=16), "cpu")
        assert type(default) is port_avatar.AvatarNet
        assert default.state_dict().keys() == net.state_dict().keys()


def test_loader_rank_blocks_and_launch_refusals(monkeypatch):
    """Each rank's loader reads its own block of every global batch of
    world_size * batch_size shuffled items, the blocks together being the
    one-process loader's batches; a loader without drop_last is refused
    under DP; -m test refuses WORLD_SIZE > 1."""

    class DS:
        def __len__(self):
            return 11

    one = PrefetchLoader(DS(), batch_size=4, device="cpu")
    ranks = [PrefetchLoader(DS(), batch_size=2, device="cpu", rank=r,
                            world_size=2) for r in range(2)]
    assert len(one) == len(ranks[0]) == len(ranks[1]) == 2
    for epoch in (1, 2):
        glob = one.index_batches(epoch)
        blocks = [ld.index_batches(epoch) for ld in ranks]
        for b, g in enumerate(glob):
            np.testing.assert_array_equal(
                np.concatenate([blocks[0][b], blocks[1][b]]), g)
    with pytest.raises(ValueError, match="drop_last"):
        PrefetchLoader(DS(), batch_size=2, drop_last=False, device="cpu",
                       rank=0, world_size=2)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="one process"):
        main_avatar_torch.main(["-c", "unused.yaml", "-m", "test"],
                               device="cpu")


def test_training_cli_defaults_to_the_card(monkeypatch):
    """main_avatar_torch runs on the card unless asked for the CPU: without
    a card and without --device cpu it refuses, with and without
    torchrun's WORLD_SIZE, before it reads the config."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for env in ({}, dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main_avatar_torch.main(["-c", "unused.yaml", "-m", "train"])


# ---------------------------------------------------------------------------
# on the card, at full width
# ---------------------------------------------------------------------------

# the data-parallel step on a one-rank group against the single step
# (deterministic cuDNN): the losses bit for bit; the gradients by the
# backward blend's atomics, which sum in a run-dependent order
RTOL_DP_GRAD = 1e-4


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.mark.gpu
def test_dp_step_on_a_one_rank_group_at_full_width(full, train_kw,
                                                   tmp_path, monkeypatch):
    import torch.distributed as dist

    from animatablegaussians_torch.parallel import data_parallel as dp
    from animatablegaussians_torch.tools import render_fixture as rf
    from animatablegaussians_torch.training import avatar_trainer as at
    net, items = full
    dev = items["extr"].device
    rank_dev = dp.init_group(dev, 0, 1, "file://" + str(tmp_path / "rdv"))
    try:
        assert dist.get_backend() == dp.backend_for(dev) and rank_dev == dev
        step = at.make_train_step(net, **train_kw)
        dp_step = dp.make_dp_train_step(step)
        gen = torch.Generator(device=dev).manual_seed(20)
        draws = at.make_draws(gen, net.n_points)
        state = at.make_train_state(net, rf.LR_INIT, rf.ITER_NUM)
        before, reduce = {}, dp.reduce_gradients

        def spy(net_):
            before.update(grad_snapshot(net_))
            return reduce(net_)

        monkeypatch.setattr(dp, "reduce_gradients", spy)
        with cudnn_deterministic():
            t_single = step.loss_and_grads(state, items, draws)
            g_single = grad_snapshot(net)
            t_dp = dp_step.loss_and_grads(state, items, draws)
        g_dp = grad_snapshot(net)
        assert g_dp.keys() == before.keys()
        assert all(torch.equal(g_dp[n], before[n]) for n in g_dp)
        assert t_dp.keys() == t_single.keys()
        assert all(torch.equal(t_dp[k], t_single[k]) for k in t_single)
        grad_err = grad_errors(net, g_dp, g_single)
        assert max(grad_err.values()) <= RTOL_DP_GRAD, grad_err
        state, terms = dp_step(state, items, at.make_draws(gen,
                                                           net.n_points))
        assert state.iter_idx == 1 and finite(terms), terms
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


@pytest.mark.gpu
def test_training_cli_under_torchrun_variables_on_the_card(card, tmp_path,
                                                           monkeypatch):
    """One epoch (2 x DRIVER_FRAMES steps) of a full-width capture after
    DRIVER_PRETRAIN pretrain iterations, under WORLD_SIZE=1 RANK=0
    LOCAL_RANK=0."""
    import torch.distributed as dist

    from animatablegaussians_torch.parallel import data_parallel as dp
    opt = write_capture(str(tmp_path))
    opt["train"].update(eval_interval=10 ** 9,
                        ckpt_interval=dict(epoch=1, batch=10 ** 9))
    cfg = write_config(opt, str(tmp_path / "routes.yaml"))
    seen, init_group = {}, dp.init_group

    def spy_init(*args, **kw):
        rank_dev = init_group(*args, **kw)
        seen.update(device=rank_dev, backend=dist.get_backend(),
                    world=dist.get_world_size())
        return rank_dev

    monkeypatch.setattr(dp, "init_group", spy_init)
    monkeypatch.setattr(driver.AvatarTrainer, "PRETRAIN_ITERS",
                        DRIVER_PRETRAIN)
    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                     MASTER_ADDR="localhost",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    trainer = main_avatar_torch.main(["-c", cfg, "-m", "train"],
                                     num_epochs=1, device=card.type)
    assert seen == dict(device=card, backend=dp.backend_for(card), world=1)
    assert trainer.device == card and trainer.rank == 0
    assert not trainer.use_dp and not dist.is_initialized()
    assert len(trainer.terms) == 2 * DRIVER_FRAMES
    assert all(finite(t) for t in trainer.terms)
    ckpt = torch.load(os.path.join(opt["train"]["net_ckpt_dir"],
                                   "epoch_latest", "net.pt"),
                      map_location=card, weights_only=True)
    assert ckpt["iter_idx"] == trainer.iter_idx
    assert not [k for k in ckpt["avatar_net"] if k.startswith("module.")]
    fresh = driver.AvatarTrainer._build_net(
        opt["train"]["data"]["data_dir"], opt["model"], card)
    fresh.load_state_dict(ckpt["avatar_net"], strict=True)
