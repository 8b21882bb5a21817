"""The port's training entry point on the CPU: checkpoints (a bit-for-bit
round trip of the train state, the reference's net.pt layout read by the
JAX package's importer, key checks), rotation and the resume precedence,
the LPIPS weight resolution, and AvatarTrainer / main_avatar_torch end to
end on a small synthetic capture (as tests/test_driver.py's
test_avatar_trainer_end_to_end: 3 pretrain iterations, one epoch of 6
steps, a mini-test snapshot, checkpoints, resume)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from animatablegaussians_tpu.models.avatar import AvatarNet as JAvatarNet
from animatablegaussians_tpu.models.gaussian_model import GaussianParams
from animatablegaussians_tpu.training.checkpoint import import_avatar_params
from animatablegaussians_tpu.utils import synthetic as jsyn
from animatablegaussians_torch.models.avatar import AvatarNet
from animatablegaussians_torch.tools import capture_fixture as cf
from animatablegaussians_torch.training import avatar_trainer as at
from animatablegaussians_torch.training import checkpoint as ck
from animatablegaussians_torch.training import lpips as tlp
from animatablegaussians_torch.training.driver import AvatarTrainer
from animatablegaussians_torch.utils.convert import params_from_jax

import main_avatar_torch

MAP_H = 64


def _state_equal(a: at.TrainState, b: at.TrainState):
    """Weights, Adam's state, the schedule and the step count, bitwise."""
    assert a.iter_idx == b.iter_idx
    sa, sb = a.net.state_dict(), b.net.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert a.scheduler.state_dict() == b.scheduler.state_dict()


def _net(seed=0):
    pos, nml, lbs = jsyn.make_cano_map(map_h=MAP_H)
    return AvatarNet({"with_viewdirs": True, "channel_max": 16}, pos, lbs,
                     cano_nml_map=nml, device="cpu", seed=seed)


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    """Two pretrain steps, save, then a fresh net and optimizer loaded from
    the directory equal the saved ones bit for bit."""
    net = _net()
    state = at.make_train_state(net, 5e-4, 100)
    step = at.make_pretrain_step(net)
    pose = torch.as_tensor(jsyn.pose_map_from_cano(
        jsyn.make_cano_map(map_h=MAP_H)[0])[..., :3])
    for _ in range(2):
        state, _ = step(state, pose)
    d = str(tmp_path / "ckpt")
    ck.save_checkpoint(d, net, state.optimizer, state.scheduler,
                       epoch_idx=3, iter_idx=state.iter_idx)
    other = at.make_train_state(_net(seed=1), 5e-4, 100)
    meta = ck.load_checkpoint(d, other.net, other.optimizer, other.scheduler)
    assert meta == {"epoch_idx": 3, "iter_idx": 2}
    other.iter_idx = meta["iter_idx"]
    _state_equal(state, other)
    assert other.scheduler.get_last_lr() == state.scheduler.get_last_lr()


def test_net_pt_reads_in_the_jax_importer(tmp_path):
    """A net.pt the port writes, read by the JAX package's
    import_avatar_params, gives back the JAX params the port's weights
    came from (params_from_jax). The JAX params are a draw of the port's
    carried across by the same importer (the JAX initializer is slow on
    the CPU)."""
    pos, nml, lbs = jsyn.make_cano_map(map_h=MAP_H)
    opt = {"with_viewdirs": True, "channel_max": 16}
    jnet = JAvatarNet(opt, pos, lbs, cano_nml_map=nml)
    sd0 = {k: v.numpy() for k, v in _net(seed=2).state_dict().items()}
    params = import_avatar_params(sd0, jnet, {"cano_gaussian": GaussianParams(
        **{f: jnp.asarray(sd0[f"cano_gaussian.{f}"])
           for f in GaussianParams.__dataclass_fields__})})
    p_np = dict(params)
    p_np["cano_gaussian"] = dataclasses.asdict(params["cano_gaussian"])
    net = AvatarNet(opt, pos, lbs, cano_nml_map=nml, device="cpu")
    net.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               p_np)))
    d = str(tmp_path / "ckpt")
    ck.save_checkpoint(d, net, iter_idx=7)
    back = import_avatar_params(os.path.join(d, "net.pt"), jnet, params)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))


def test_reference_layout_keeps_constructor_gaussians(tmp_path):
    """A reference net.pt (no cano_gaussian.*) loads the heads and keeps
    the constructor's canonical Gaussians; another missing or an unexpected
    key is refused."""
    src, dst = _net(seed=0), _net(seed=1)
    sd = {k: v for k, v in src.state_dict().items()
          if not k.startswith("cano_gaussian.")}
    cano = {k: v.clone() for k, v in dst.state_dict().items()
            if k.startswith("cano_gaussian.")}
    d = str(tmp_path / "ref")
    os.makedirs(d)
    torch.save({"epoch_idx": 1, "iter_idx": 5, "avatar_net": sd},
               os.path.join(d, "net.pt"))
    assert ck.load_checkpoint(d, dst) == {"epoch_idx": 1, "iter_idx": 5}
    got = dst.state_dict()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    for k, v in cano.items():
        assert torch.equal(got[k], v), k
    key = next(k for k in sd if k.startswith("color_net."))
    with pytest.raises(KeyError, match=key):
        ck.load_net_state(dst, {k: v for k, v in sd.items() if k != key})
    with pytest.raises(KeyError, match="extra"):
        ck.load_net_state(dst, dict(sd, extra=torch.zeros(1)))


def test_rotation_and_resume_precedence(tmp_path):
    base = str(tmp_path / "run")
    for i in (100, 20, 300):
        os.makedirs(os.path.join(base, f"batch_{i}"))
    os.makedirs(os.path.join(base, "batch_x"))
    ck.rotate_checkpoints(base)
    assert sorted(os.listdir(base)) == ["batch_300", "batch_x"]

    assert ck.resolve_resume_dir(base) == (None, False)
    sibling = str(tmp_path / "pretrained")
    os.makedirs(sibling)
    assert ck.resolve_resume_dir(base) == (sibling, False)
    explicit = str(tmp_path / "pre2")
    os.makedirs(explicit)
    assert ck.resolve_resume_dir(base, pretrained_dir=explicit) == (
        explicit, False)
    latest = os.path.join(base, "epoch_latest")
    os.makedirs(latest)
    assert ck.resolve_resume_dir(base, pretrained_dir=explicit) == (
        latest, True)
    assert ck.resolve_resume_dir(base, prev_ckpt="/some/ckpt",
                                 pretrained_dir=explicit) == (
        "/some/ckpt", True)


def test_resolve_lpips_params(tmp_path, monkeypatch):
    monkeypatch.delenv("AGT_LPIPS_WEIGHTS", raising=False)
    with_lpips = {"train": {"loss_weight": {"l1": 1.0, "lpips": 0.1}}}
    with pytest.raises(RuntimeError, match="lpips_weights: random"):
        tlp.resolve_lpips_params(with_lpips)
    assert tlp.resolve_lpips_params(
        {"train": {"loss_weight": {"l1": 1.0}}}) is None
    random = tlp.resolve_lpips_params(
        {"train": dict(with_lpips["train"], lpips_weights="random")})
    want = tlp.init_random(0)
    assert random.keys() == want.keys()
    for k in want:
        assert torch.equal(random[k], want[k]), k
    # $AGT_LPIPS_WEIGHTS with torchvision / LPIPS-layout files
    vgg, lin, t_idx = {}, {}, 0
    for c in tlp.VGG16_CFG:
        if c == "M":
            t_idx += 1
            continue
        vgg[f"features.{t_idx}.weight"] = torch.zeros(1)
        vgg[f"features.{t_idx}.bias"] = torch.zeros(1)
        t_idx += 2
    for i, c in enumerate(tlp.LIN_CHANNELS):
        lin[f"lin{i}.model.1.weight"] = torch.full((1, c, 1, 1), float(i))
    torch.save(vgg, tmp_path / "vgg16.pth")
    torch.save(lin, tmp_path / "lin.pth")
    monkeypatch.setenv("AGT_LPIPS_WEIGHTS", str(tmp_path))
    found = tlp.resolve_lpips_params(with_lpips)
    assert torch.equal(found["lins.3"], torch.full((512,), 3.0))


# ---------------------------------------------------------------------------
# the driver end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("capture"))
    return d, cf.write_capture(d)


def _make_opt(data_dir, smpl_path, ckpt_dir):
    """tests/test_driver.py's config (eval and batch checkpoints every few
    steps, no LPIPS)."""
    return dict(
        train=dict(
            dataset="MvRgbDatasetAvatarReX",
            data=dict(data_dir=data_dir, frame_range=[0, 3],
                      used_cam_ids=[0, 1], load_smpl_pos_map=True,
                      smpl_model_path=smpl_path),
            net_ckpt_dir=ckpt_dir,
            ckpt_interval=dict(epoch=1, batch=2),
            eval_interval=3,
            eval_training_ids=[0, 0],
            lr_init=5e-4,
            loss_weight=dict(l1=1.0, offset=0.005),
            finetune_color=False,
            batch_size=1, num_workers=2, random_bg_color=True),
        model=dict(with_viewdirs=True, channel_max=32),
    )


def test_avatar_trainer_end_to_end(capture, tmp_path, monkeypatch):
    """main_avatar_torch -m train with nothing to resume: TF32 off, 3
    pretrain iterations, one epoch of 6 steps with snapshots, logs and
    rotating checkpoints; a second trainer resumed from epoch_latest equals
    the first bit for bit; the CLI again resumes from it; -m test renders
    novel poses with epoch_latest's weights."""
    data_dir, smpl_path = capture
    opt = _make_opt(data_dir, smpl_path, str(tmp_path / "ckpt"))
    cfg = str(tmp_path / "avatar.yaml")
    with open(cfg, "w") as fp:
        yaml.safe_dump(opt, fp)
    monkeypatch.setattr(AvatarTrainer, "PRETRAIN_ITERS", 3)
    monkeypatch.setattr(AvatarTrainer, "log_interval", 3)
    torch.backends.cudnn.allow_tf32 = True
    trainer = main_avatar_torch.main(["-c", cfg], num_epochs=1,
                                     device="cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert trainer.avatar_net.n_points > 100
    assert (trainer.img_w, trainer.img_h) == (96, 96)
    assert len(trainer.dataset) == 6
    assert trainer.iter_idx == trainer.state.iter_idx == 6
    assert len(trainer.iter_ms) == 6 and len(trainer.loader_waits) == 6
    base = trainer.net_ckpt_dir
    for name in ("pretrained/net.pt", "epoch_latest/net.pt",
                 "epoch_latest/optm.pt", "loss.txt", "config_bk.yaml",
                 "eval/training_3.jpg", "eval/training_6.jpg"):
        assert os.path.exists(os.path.join(base, name)), name
    # the pretrain phase moved the heads it trains
    pre = torch.load(os.path.join(base, "pretrained", "net.pt"),
                     weights_only=True)["avatar_net"]
    init = AvatarTrainer(opt, device="cpu").avatar_net.state_dict()
    assert any(not torch.equal(pre[k], init[k]) for k in init
               if k.startswith("position_net."))
    # batch_2, batch_4, batch_6 were written; rotation keeps the newest
    assert sorted(d for d in os.listdir(base) if d.startswith("batch_")) \
        == ["batch_6"]
    lines = open(os.path.join(base, "loss.txt")).read().splitlines()
    assert [ln.split()[1] for ln in lines] == ["3", "6"]
    assert all("l1_loss" in ln and "total_loss" in ln for ln in lines)
    with open(os.path.join(base, "config_bk.yaml")) as fp:
        assert yaml.safe_load(fp) == dict(opt, mode="train")

    # resume: the step count, weights, Adam and the schedule, bit for bit
    trainer2 = AvatarTrainer(opt, device="cpu")
    d, with_opt = ck.resolve_resume_dir(base)
    assert d == os.path.join(base, "epoch_latest") and with_opt
    trainer2.load_ckpt(d, load_optm=with_opt)
    assert trainer2.iter_idx == 6 and trainer2.epoch_idx == 1
    _state_equal(trainer.state, trainer2.state)
    with pytest.raises(FileNotFoundError):
        trainer2.load_ckpt(str(tmp_path / "no_such_dir"), load_optm=False)
    # the CLI resumes from epoch_latest (no epoch to train here)
    resumed = main_avatar_torch.main(["-c", cfg, "-m", "train"],
                                     num_epochs=0, device="cpu")
    assert resumed.iter_idx == resumed.state.iter_idx == 6
    assert resumed.epoch_idx == 1
    # -m test animates two novel poses with the trained weights
    opt["test"] = dict(
        pose_data=dict(data_path=cf.write_pose_sequence(
            str(tmp_path / "thuman4_pose_00.npz"), 2),
            smpl_model_path=smpl_path),
        view_setting="front", img_scale=0.125, n_pca=-1, save_ply=True,
        prev_ckpt=os.path.join(base, "epoch_latest"),
        output_dir=str(tmp_path / "animation"))
    with open(cfg, "w") as fp:
        yaml.safe_dump(opt, fp)
    tested = main_avatar_torch.main(["-c", cfg, "-m", "test"], device="cpu")
    assert tested.iter_idx == 6
    for k, v in tested.avatar_net.state_dict().items():
        assert torch.equal(v, trainer.avatar_net.state_dict()[k]), k
    for folder, ext in (("rgb_map", "jpg"), ("mask_map", "png"),
                        ("posed_gaussians", "ply")):
        assert sorted(os.listdir(tmp_path / "animation" / folder)) == [
            f"{i:08d}.{ext}" for i in range(2)], folder
