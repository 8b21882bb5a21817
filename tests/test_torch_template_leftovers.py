"""The template and data leftovers of the port against the JAX package on
the CPU: the eleven losses of ``training/losses.py`` (values and
gradients), ``PoseDataset.getitem``'s NeRF item, ``training/
base_trainer.BaseTrainer`` (its files, cadence and resume) and
``utils/geometry.barycentric_*``; and that no module this slice added
loads jax.

Tolerances: the losses and their gradients 1e-5 relative and 1e-6
absolute (float32 on both sides, reductions in another order);
``crop_square`` and ``mask_center`` bit for bit (a gather, and an int
truncation of float32 sums the tests keep off integer boundaries);
``random_crop_center``'s bounds bit for bit against JAX's arithmetic and
its draws inside them (JAX's ``randint`` stream cannot be reproduced); the
NeRF item's rays and bounds 1e-5 relative, 1e-6 absolute (from SMPL-X
vertices that agree to that); ``BaseTrainer``'s ``loss.txt`` values as
printed (four decimals) and its checkpoint names exactly; a resume bit for
bit; barycentric 1e-5 relative, 1e-6 absolute.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatablegaussians_tpu.data.pose_dataset import PoseDataset as JPose
from animatablegaussians_tpu.training import base_trainer as jbt
from animatablegaussians_tpu.training import losses as jL
from animatablegaussians_tpu.utils import geometry as jgeo
from animatablegaussians_torch.data import PoseDataset
from animatablegaussians_torch.tools import capture_fixture as cf
from animatablegaussians_torch.training import base_trainer as tbt
from animatablegaussians_torch.training import losses as tL
from animatablegaussians_torch.utils import geometry as tgeo
from tests.test_torch_data import _compare_items

RTOL, ATOL = 1e-5, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def _inputs(name, rng):
    """Each loss's numpy inputs (the first ones differentiated)."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    u = lambda *s: rng.random(s).astype(np.float32)  # noqa: E731
    return {
        "mse": (f(5, 4), f(5, 4)),
        "tv_loss": (f(6, 7, 3),),
        "eikonal_loss": (f(50, 3),),
        "second_order_smoothness": (f(3, 8, 2),),
        "weighted_mse": (f(5, 4), f(5, 4), u(5, 4)),
        "cosine_distance": (f(6, 3), f(6, 3), u(6)),
        "cosine_distance_raw": (f(6, 3), f(6, 3)),
        "iou_loss": (u(3, 5, 4), u(3, 5, 4)),
        "iou_loss_1d": (u(7), u(7)),
        "kld_loss": (f(4, 6), 0.3 * f(4, 6)),
    }[name]


LOSSES = {
    "mse": lambda L, *a: L.mse(*a),
    "tv_loss": lambda L, *a: L.tv_loss(*a),
    "eikonal_loss": lambda L, *a: L.eikonal_loss(*a),
    "second_order_smoothness": lambda L, x: L.second_order_smoothness(
        x, axis=1),
    "weighted_mse": lambda L, *a: L.weighted_mse(*a),
    "cosine_distance": lambda L, *a: L.cosine_distance(*a),
    "cosine_distance_raw": lambda L, *a: L.cosine_distance(
        *a, normalized=False),
    "iou_loss": lambda L, *a: L.iou_loss(*a),
    "iou_loss_1d": lambda L, *a: L.iou_loss(*a),
    "kld_loss": lambda L, *a: L.kld_loss(*a),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_and_gradient_match_jax(name):
    args = _inputs(name, np.random.default_rng(len(name)))
    fn = LOSSES[name]
    want, jgrad = jax.value_and_grad(
        lambda a0, *rest: fn(jL, a0, *rest))(
        *[jnp.asarray(a) for a in args])
    targs = [torch.tensor(a) for a in args]
    targs[0].requires_grad_(True)
    got = fn(tL, *targs)
    got.backward()
    _close(got.detach(), want, name)
    _close(targs[0].grad, jgrad, f"{name} gradient")


def test_crop_square_and_mask_center_match_jax():
    rng = np.random.default_rng(3)
    img = rng.random((20, 30, 3)).astype(np.float32)
    for c in [(15, 10), (0, 0), (29, 19), (2, 17), (-5, 40), (31, 3)]:
        got = tL.crop_square(torch.tensor(img), torch.tensor(c), 8)
        want = jL.crop_square(jnp.asarray(img), jnp.asarray(c), 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=str(c))
    # a crop of the whole image, and a gradient through the gather
    x = torch.tensor(img, requires_grad=True)
    tL.crop_square(x, torch.tensor([3, 3]), 20).sum().backward()
    assert x.grad[:, :20].eq(1).all() and x.grad[:, 20:].eq(0).all()
    for mask in (np.zeros((20, 30), np.float32),
                 (rng.random((20, 30)) > 0.6).astype(np.float32)):
        mask[5:9, 7:20] = 1.0
        got = tL.mask_center(torch.tensor(mask))
        want = jL.mask_center(jnp.asarray(mask))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    empty = np.zeros((6, 5), np.float32)
    np.testing.assert_array_equal(tL.mask_center(torch.tensor(empty)),
                                  np.asarray(jL.mask_center(empty)))


def _jax_bounds(mask):
    """JAX random_crop_center's [low, high) per (x, y): its arithmetic
    restated in jnp, without the draw."""
    h, w = mask.shape
    ys, xs = (mask > 0.5).any(1), (mask > 0.5).any(0)
    y0 = jnp.min(jnp.where(ys, jnp.arange(h), h))
    y1 = jnp.max(jnp.where(ys, jnp.arange(h), 0))
    x0 = jnp.min(jnp.where(xs, jnp.arange(w), w))
    x1 = jnp.max(jnp.where(xs, jnp.arange(w), 0))
    return ((int(jnp.minimum(x0, x1)), int(jnp.maximum(x1, x0 + 1))),
            (int(jnp.minimum(y0, y1)), int(jnp.maximum(y1, y0 + 1))))


@pytest.mark.parametrize("case", ["box", "empty", "one_pixel", "row"])
def test_random_crop_center_draws_within_jax_bounds(case):
    mask = np.zeros((12, 16), np.float32)
    if case == "box":
        mask[3:9, 5:14] = 1.0
    elif case == "one_pixel":
        mask[7, 2] = 1.0
    elif case == "row":
        mask[4, 1:15] = 0.8
    (xl, xh), (yl, yh) = _jax_bounds(mask)
    # JAX's own draws land in the same ranges
    for s in range(5):
        jx, jy = np.asarray(jL.random_crop_center(jax.random.PRNGKey(s),
                                                  jnp.asarray(mask), 4))
        assert xl <= jx < xh and yl <= jy < yh
    gen = torch.Generator().manual_seed(0)
    draws = np.stack([tL.random_crop_center(gen, torch.tensor(mask),
                                            4).numpy() for _ in range(400)])
    assert draws.dtype == np.int32
    assert (draws[:, 0] >= xl).all() and (draws[:, 0] < xh).all()
    assert (draws[:, 1] >= yl).all() and (draws[:, 1] < yh).all()
    # every value of a range is reached (here at most 17 values)
    assert len(set(draws[:, 0])) == xh - xl
    assert len(set(draws[:, 1])) == yh - yl
    if case == "empty":            # JAX's range runs one past the image
        assert (xl, xh, yl, yh) == (0, 17, 0, 13)
    if case == "one_pixel":
        assert (draws == [2, 7]).all()
    again = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(
        tL.random_crop_center(again, torch.tensor(mask), 4).numpy(),
        draws[0])


@pytest.fixture(scope="module")
def poses(tmp_path_factory):
    d = tmp_path_factory.mktemp("nerf_poses")
    smpl = str(d / "smplx.npz")
    cf.write_smplx(smpl, body_scale=0.3)
    path = cf.write_pose_sequence(str(d / "thuman4_pose_00.npz"), 4,
                                  scale=0.4)
    return path, smpl


@pytest.mark.parametrize("fix", [True, False])
def test_nerf_item_matches_jax(poses, fix):
    path, smpl = poses
    kw = dict(smpl_model_path=smpl, fix_head_pose=fix, fix_hand_pose=fix)
    want, got = JPose(path, **kw), PoseDataset(path, **kw)
    cam = dict(img_w=64, img_h=48, intr=np.array(
        [[60, 0, 32], [0, 60, 24], [0, 0, 1]], np.float32))
    for i, ckw in ((1, {}), (3, cam)):
        g, w = got.getitem(i, **ckw), want.getitem(i, **ckw)
        _compare_items(g, w)
        assert 0 < g["uv"].shape[0] <= g["img_w"] * g["img_h"]
        zeroed = g["pose"][[33, 34, 35, 42, 43, 44, 57, 58, 59, 60, 61, 62]]
        assert (zeroed == 0).all() == fix


class _Items:
    """Six items of a feature x (4,) and its index as a float."""

    def __init__(self, n=6):
        rng = np.random.default_rng(8)
        self.x = rng.standard_normal((n, 4)).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return dict(x=self.x[i], idx=np.float32(i))


def _opt(d):
    return {"train": {"loss_weight": {"l1": 1.0}, "net_ckpt_dir": d,
                      "ckpt_interval": {"epoch": 2, "batch": 4},
                      "eval_interval": 3}}


def _log_values(path):
    """loss.txt's lines without the elapsed seconds."""
    with open(path) as f:
        return [ln.split("(")[0] + ln.split("):")[1] for ln in f]


def test_base_trainer_files_match_jax(tmp_path, monkeypatch):
    """The same item order, log lines (every 2 iterations, 0.9 running
    mean), mini-test calls and checkpoint directories as the JAX
    trainer, over 3 epochs of 6 items (TensorBoard blocked on both
    sides: where TensorFlow is installed its import takes ~20 s;
    chip_smoke.py phase 22 checks the event file on the card)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    seen = {"jax": [], "torch": []}
    tests = {"jax": [], "torch": []}

    def terms(x, idx):
        return {"a": x.mean(), "b": 0.5 * idx}

    def jstep(state, items, rng):
        seen["jax"].append(float(items["idx"]))
        return {"w": state["w"] + 1.0}, terms(items["x"], items["idx"])

    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jtr = jbt.BaseTrainer(_opt(jd), jstep, {"w": jnp.zeros(2)}, _Items(),
                          mini_test_fn=lambda t: tests["jax"].append(
                              t.iter_idx))
    net = torch.nn.Linear(4, 1)

    def tstep(items, gen):
        seen["torch"].append(float(items["idx"]))
        return terms(items["x"], items["idx"])

    ttr = tbt.BaseTrainer(_opt(td), tstep, net, _Items(), device="cpu",
                          mini_test_fn=lambda t: tests["torch"].append(
                              t.iter_idx))
    for tr in (jtr, ttr):
        tr.log_interval = 2
        tr.train(num_epochs=3, num_threads=2)
    assert seen["torch"] == seen["jax"] and len(seen["jax"]) == 18
    assert tests["torch"] == tests["jax"] == [3, 6, 9, 12, 15, 18]
    assert _log_values(os.path.join(td, "loss.txt")) == \
        _log_values(os.path.join(jd, "loss.txt"))
    dirs = lambda d: sorted(n for n in os.listdir(d)  # noqa: E731
                            if n.startswith(("batch_", "epoch_")))
    assert dirs(td) == dirs(jd) == ["batch_16", "epoch_2", "epoch_latest"]
    assert os.path.exists(os.path.join(td, "config_bk.yaml"))
    assert (ttr.iter_idx, ttr.epoch_idx) == (18, 3)


def test_base_trainer_resume_bit_for_bit(tmp_path, monkeypatch):
    """A net trained with Adam and a schedule, checkpointed, restored into
    a fresh trainer bit for bit, trained on to the same weights as an
    uninterrupted run; an iteration cap stops mid-epoch."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)

    def make(d):
        torch.manual_seed(0)
        net = torch.nn.Linear(4, 1)
        opt = torch.optim.Adam(net.parameters(), lr=1e-2)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 0.9 ** s)

        def step(items, gen):
            opt.zero_grad(set_to_none=True)
            noise = torch.randn(1, generator=gen)
            loss = (net(items["x"]) - items["idx"] - noise).pow(2).mean()
            loss.backward()
            opt.step()
            sched.step()
            return {"loss": loss.detach()}

        return tbt.BaseTrainer(_opt(d), step, net, _Items(), optimizer=opt,
                               scheduler=sched, device="cpu")

    a = make(str(tmp_path / "a"))
    a.train(num_epochs=2, num_threads=1)
    b = make(str(tmp_path / "b"))
    assert b.load_ckpt(os.path.join(a.net_ckpt_dir, "epoch_latest")) == 2
    assert b.iter_idx == 12
    for k, v in a.net.state_dict().items():
        assert torch.equal(b.net.state_dict()[k], v), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for p in sa["state"]:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][p][k], sb["state"][p][k])
    assert a.scheduler.state_dict() == b.scheduler.state_dict()
    # the same draws from here on, then the same weights
    b.generator.set_state(a.generator.get_state())
    for tr in (a, b):
        tr.train(num_epochs=3, num_threads=1)
    for k, v in a.net.state_dict().items():
        assert torch.equal(b.net.state_dict()[k], v), k
    c = make(str(tmp_path / "c"))
    c.train(iter_num=8, num_threads=1)
    assert (c.iter_idx, c.epoch_idx) == (8, 2)
    assert sorted(os.listdir(c.net_ckpt_dir))[:2] == ["batch_8",
                                                      "config_bk.yaml"]


def test_barycentric_matches_jax():
    rng = np.random.default_rng(9)
    a, b, c, p = (rng.standard_normal((2, 5, 3)).astype(np.float32)
                  for _ in range(4))
    c[0, 0] = a[0, 0] + 2 * (b[0, 0] - a[0, 0])     # a degenerate triangle
    attrs = rng.standard_normal((2, 5, 3, 4)).astype(np.float32)
    got = tgeo.barycentric_coords(*map(torch.tensor, (p, a, b, c)))
    want = jgeo.barycentric_coords(*map(jnp.asarray, (p, a, b, c)))
    _close(got, want, "coords")
    _close(tgeo.barycentric_interp(got, torch.tensor(attrs)),
           jgeo.barycentric_interp(want, jnp.asarray(attrs)), "interp")
    # a point on the triangle's plane is rebuilt from its corners
    w = torch.tensor([0.2, 0.3, 0.5])
    corners = torch.tensor(np.stack([a[1, 1], b[1, 1], c[1, 1]]))
    q = (w[:, None] * corners).sum(0)
    _close(tgeo.barycentric_coords(q, *corners), w, "round trip")


def test_new_modules_load_no_jax():
    """The modules this slice added or widened import without jax."""
    code = (
        "import sys\n"
        "import animatablegaussians_torch.data.native_io\n"
        "import animatablegaussians_torch.tools.bench_loader\n"
        "import animatablegaussians_torch.training.base_trainer\n"
        "import animatablegaussians_torch.models.feature2d\n"
        "from animatablegaussians_torch.models.smplx import FLAME, MANO, "
        "SMPL, SMPLH\n"
        "from animatablegaussians_torch.training.losses import kld_loss\n"
        "from animatablegaussians_torch.utils.geometry import "
        "barycentric_coords\n"
        "from animatablegaussians_torch.utils.exr import imread\n"
        "from animatablegaussians_torch.utils.convert import "
        "feature2d_state\n"
        "mods = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'animatablegaussians_tpu'))]\n"
        "assert not mods, mods\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
