"""The port's animation entry point (``testing/animate.py::run_test``,
``main_avatar_torch.py -m test``) against the JAX package on the CPU.

One JAX ``run_test`` (module-scoped) renders five THuman4-style novel
poses of a small synthetic capture (tests/test_driver.py::full_capture's
sizes, written by tools/capture_fixture.py) with the free orbit camera,
``global_orient``, ``img_scale`` 0.125 (128x128), a 2-component PCA
projection, the mean hands (``fix_hand``), and the texture-map, skeleton
and PLY exports (so one render a frame). The port runs the same config
with the JAX weights carried across by ``utils/convert.params_from_jax``:
in batches of ``seq_frames`` 2 (2 + 2 + 1 frames, through
``render_sequence``), and one frame at a time with the exports. Frames are
collected in memory through ``_write_frame`` in both packages and compared
at tests/test_torch_avatar.py's ATOL (2e-4), but for the few pixels where a
Gaussian's alpha sits within float32 rounding of the blend's 1/255 cutoff
(``tools/frame_compare.py``'s rule); the file names must be equal.

Marked ``gpu`` (skipped without a CUDA device): ``main_avatar_torch -m
test`` as a user runs it on a full-width capture (on_card.write_capture)
with the position and other heads' outputs zeroed, in three runs. A: 12
THuman4-style poses, the free orbit with global_orient at 1024x1024, 4
frames a render_sequence call, PCA with 2 components. B: 2 poses, the
front view, fix_hand with a MANO directory at SMPL-X's 10,475 vertices,
save_ply, save_tex_map and render_skeleton. C: run A at the default
seq_frames, 8. Each run: the kernels' launches, the files' names by the
JAX package's rule, each frame against the plain path's same call and
against a render of the frame alone (the flip rule), the frames'
coverage, the PLYs' positions bit for bit, transform_pca on the card
against its float64 CPU version.
"""

import dataclasses
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
import yaml

from animatablegaussians_tpu.models import styleunet as jsu
from animatablegaussians_tpu.ops.rasterize import RasterizeConfig
from animatablegaussians_tpu.testing import animate as janimate
from animatablegaussians_tpu.training.driver import \
    AvatarTrainer as JAvatarTrainer
from animatablegaussians_torch.models import gaussian_model as tgm
from animatablegaussians_torch.testing import animate as tanimate
from animatablegaussians_torch.tools import capture_fixture as cf
from animatablegaussians_torch.tools import frame_compare as fc
from animatablegaussians_torch.training import checkpoint as ck
from animatablegaussians_torch.training.driver import AvatarTrainer
from animatablegaussians_torch.utils import visualize as tviz
from animatablegaussians_torch.utils.convert import params_from_jax
from test_torch_driver import _make_opt
from on_card import (ANIM_COVER_MIN, ATOL_BLEND, ATOL_FIR_IMG,  # noqa
                     card, fir_count, kernels, launches, render_checkpoint,
                     reset_launches, write_capture, write_config)

import main_avatar_torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

ATOL = 2e-4
# The two packages' float32 CNNs and SMPL-X forwards differ by ~1e-7
# relative, so a Gaussian whose alpha sits within that of the 1/255 cutoff
# is blended on one side and skipped on the other: frame_compare's flip
# rule, with ATOL in every channel.
ATOLS = dict.fromkeys(("color", "depth", "alpha"), ATOL)
N_POSES = 5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOLDERS = ("rgb_map", "mask_map", "cano_tex_map", "live_skeleton",
           "posed_gaussians")


# ---------------------------------------------------------------------------
# compute_view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("view", ["camera", "free", "free_bird", "front",
                                  "front_bird", "back", "back_bird",
                                  "moving", "moving_bird", "cano"])
def test_compute_view_matches_jax(view):
    """Every view setting, at two frame indices, with and without
    global_orient and img_scale, bit for bit."""
    rng = np.random.default_rng(0)
    ds = types.SimpleNamespace(
        intr_mats=[np.array([[500, 0, 250], [0, 510, 260], [0, 0, 1]],
                            np.float32)] * 2,
        extr_mats=[tviz._t(tviz._rodrigues(rng.standard_normal(3)),
                           rng.standard_normal(3))] * 2,
        img_widths=[500, 600], img_heights=[520, 640])
    go = tviz._rodrigues(0.3 * rng.standard_normal(3).astype(np.float32))
    for opt_test in (dict(render_view_idx=1),
                     dict(render_view_idx=1, img_scale=0.5,
                          global_orient=True)):
        for idx in (0, 137):
            center = rng.standard_normal(3).astype(np.float32)
            got = tanimate.compute_view(view, idx, center.copy(), go, ds,
                                        opt_test)
            want = janimate.compute_view(view, idx, center.copy(), go, ds,
                                         opt_test)
            assert got[2:] == want[2:]
            for g, w in zip(got[:2], want[:2]):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tanimate.compute_view("side", 0, np.zeros(3), go, ds, {})


# ---------------------------------------------------------------------------
# run_test, both packages
# ---------------------------------------------------------------------------

def _params_np(params):
    p = dict(params)
    p["cano_gaussian"] = dataclasses.asdict(params["cano_gaussian"])
    return jax.tree_util.tree_map(np.asarray, p)


def _host(v):
    return np.asarray(v.cpu() if torch.is_tensor(v) else v)


def _collect(module, frames, valid=None):
    """Wrap ``module._write_frame`` to record each frame's outputs on the
    host before writing it, and with ``valid`` (the net's valid points)
    the span of one contribution (``frame_compare.contribution_span``)
    from the frame's posed Gaussians; returns the original."""
    inner = module._write_frame

    def write(item, items, extr, intr, img_w, img_h, output, *rest):
        frame = dict(data_idx=item["data_idx"], size=(img_w, img_h),
                     **{k: _host(output[k])
                        for k in ("rgb_map", "mask_map", "depth_map",
                                  "cano_tex_map", "n_overflow")
                        if k in output})
        if valid is not None:
            g = output["posed_gaussians"]
            frame["span"] = fc.contribution_span(
                _host(g["positions"])[valid], _host(g["colors"])[valid],
                _host(extr), (1.0, 1.0, 1.0))
        frames.append(frame)
        return inner(item, items, extr, intr, img_w, img_h, output, *rest)

    module._write_frame = write
    return inner


def _files(out_dir):
    return {f: sorted(os.listdir(os.path.join(out_dir, f)))
            for f in FOLDERS if os.path.isdir(os.path.join(out_dir, f))}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("animate")
    data_dir = str(d / "capture")
    smpl = cf.write_capture(data_dir, pose_map_jitter=0.02)
    mano = cf.write_mano(str(d / "mano"))
    poses = cf.write_pose_sequence(str(d / "thuman4" / "pose_00.npz"),
                                   N_POSES, seed=1)
    opt = _make_opt(data_dir, smpl, str(d / "ckpt"))
    opt["model"]["autosize_raster"] = False    # caps set below instead
    opt["test"] = dict(
        pose_data=dict(data_path=poses, smpl_model_path=smpl,
                       mano_dir=mano),
        view_setting="free", global_orient=True, img_scale=0.125,
        n_pca=2, sigma_pca=2.0, fix_hand=True, fix_hand_id=1,
        save_ply=True, save_tex_map=True, render_skeleton=True,
        output_dir=str(d / "jax_out"))
    prev = jsu.CONV_PRECISION
    jsu.set_conv_precision("highest")
    frames = []
    trainer = JAvatarTrainer(opt)
    inner = _collect(janimate, frames, np.asarray(trainer.avatar_net.valid))
    try:
        # caps that drop nothing at the test camera (n_overflow is checked)
        trainer.avatar_net.raster_config = RasterizeConfig(
            backend="ref", k_max=4096, max_dup=64, max_active_tiles=0)
        # run_test calls it eagerly, op by op (~10 s on the CPU); jitted
        # it computes the same
        trainer.avatar_net.generate_mean_hands = jax.jit(
            trainer.avatar_net.generate_mean_hands)
        out_dir = janimate.run_test(trainer, opt)
    finally:
        janimate._write_frame = inner
        jsu.set_conv_precision(prev)
    assert all(int(f["n_overflow"]) == 0 for f in frames)
    return dict(opt=opt, dir=d, frames=frames, files=_files(out_dir),
                out_dir=out_dir, params=_params_np(trainer.state.params),
                n_valid=trainer.avatar_net.n_valid)


def _port_trainer(jax_run, opt):
    trainer = AvatarTrainer(opt, device="cpu")
    trainer.avatar_net.load_state_dict(params_from_jax(jax_run["params"]))
    return trainer


def _port_run(jax_run, name, **test):
    opt = dict(jax_run["opt"])
    opt["test"] = dict(opt["test"], output_dir=str(jax_run["dir"] / name),
                       **test)
    frames = []
    inner = _collect(tanimate, frames)
    try:
        trainer = _port_trainer(jax_run, opt)
        out_dir = tanimate.run_test(trainer, opt)
    finally:
        tanimate._write_frame = inner
    return frames, out_dir, trainer


def _compare_frames(got, want, tex_map=False):
    """The rgb, depth and alpha frames by frame_compare's flip rule; the
    texture map (the colour head's output, no blend) at ATOL."""
    assert [f["data_idx"] for f in got] == [f["data_idx"] for f in want]
    assert len(got) == N_POSES
    diffs = []
    for g, w in zip(got, want):
        assert g["size"] == w["size"] == (128, 128)
        for k in ("rgb_map", "mask_map", "depth_map"):
            assert g[k].shape == w[k].shape, k
        diffs.append(fc.flip_diff(g, w, ATOLS, w["span"]))
        if tex_map:
            np.testing.assert_allclose(g["cano_tex_map"], w["cano_tex_map"],
                                       rtol=0, atol=ATOL)
    assert fc.flips_ok(diffs, ATOLS), (fc.flip_summary(diffs, ATOLS), diffs)
    assert min(d["in_view"] for d in diffs) > 0


@pytest.mark.parametrize("seq_frames", [2, 1])
def test_run_test_frames_match_jax(jax_run, seq_frames):
    """The rgb and mask frames, with the PCA and the mean hands, through
    render_sequence in batches of 2, 2 and 1 frames, or one render a
    frame."""
    frames, out_dir, _ = _port_run(
        jax_run, f"seq{seq_frames}", seq_frames=seq_frames, save_ply=False,
        save_tex_map=False, render_skeleton=False)
    _compare_frames(frames, jax_run["frames"])
    assert _files(out_dir) == {k: jax_run["files"][k]
                               for k in ("rgb_map", "mask_map")}


def test_run_test_exports_match_jax(jax_run):
    """With the texture map, the skeleton and the PLY asked for: the same
    frames and texture maps, the same file names in every folder, and PLYs
    of the valid points only, whose positions agree with the JAX package's
    PLYs."""
    frames, out_dir, trainer = _port_run(jax_run, "exports")
    _compare_frames(frames, jax_run["frames"], tex_map=True)
    files = _files(out_dir)
    assert files == jax_run["files"] and set(files) == set(FOLDERS)
    assert files["posed_gaussians"] == ["%08d.ply" % i
                                        for i in range(N_POSES)]
    n_valid = trainer.avatar_net.n_valid
    assert n_valid == jax_run["n_valid"] < trainer.avatar_net.n_points
    for name in files["posed_gaussians"]:
        got = tgm.load_gaussians_from_ply(os.path.join(
            out_dir, "posed_gaussians", name))
        want = tgm.load_gaussians_from_ply(os.path.join(
            jax_run["out_dir"], "posed_gaussians", name))
        assert got["positions"].shape == (n_valid, 3)
        np.testing.assert_allclose(got["positions"], want["positions"],
                                   rtol=0, atol=1e-4)


def test_cli_test_mode_matches_jax(jax_run, tmp_path, monkeypatch):
    """main_avatar_torch -m test on the CPU: the weights from the config's
    test.prev_ckpt (a port checkpoint of the JAX weights at step 7), the
    default output directory under the working directory, named by the JAX
    package's rule, and the same frames."""
    opt = dict(jax_run["opt"])
    ckpt = str(tmp_path / "batch_7")
    ck.save_checkpoint(ckpt, _port_trainer(jax_run, opt).avatar_net,
                       iter_idx=7)
    opt["test"] = {k: v for k, v in opt["test"].items()
                   if k not in ("output_dir", "save_ply", "save_tex_map",
                                "render_skeleton")}
    opt["test"].update(prev_ckpt=ckpt, seq_frames=3)
    cfg = str(tmp_path / "avatar.yaml")
    with open(cfg, "w") as fp:
        yaml.safe_dump(opt, fp)
    monkeypatch.chdir(tmp_path)
    frames = []
    inner = _collect(tanimate, frames)
    try:
        trainer = main_avatar_torch.main(["-c", cfg, "-m", "test"],
                                         device="cpu")
    finally:
        tanimate._write_frame = inner
    assert trainer.iter_idx == 7 and trainer.device == torch.device("cpu")
    subject = os.path.basename(opt["train"]["data"]["data_dir"])
    out_dir = os.path.join("test_results", subject,
                           "thuman4_pose_00_free_view", "batch_000007",
                           "pca_2_sigma_2.00")
    assert _files(out_dir) == {k: jax_run["files"][k]
                               for k in ("rgb_map", "mask_map")}
    _compare_frames(frames, jax_run["frames"])


def test_port_animates_without_jax(tmp_path):
    """The animation route imports no jax, no module of the JAX package,
    no sklearn and no joblib: a fresh interpreter runs -m test on a tiny
    capture (PCA and mean hands on) and then lists its modules."""
    code = f"""
import os, sys, yaml
from animatablegaussians_torch.tools import capture_fixture as cf
from animatablegaussians_torch.tools import frame_compare as fc
import main_avatar_torch
d = {str(tmp_path)!r}
smpl = cf.write_capture(os.path.join(d, "cap"), n_frames=3, map_h=64,
                        pose_map_jitter=0.02)
opt = dict(
    train=dict(dataset="MvRgbDatasetAvatarReX",
               data=dict(data_dir=os.path.join(d, "cap"),
                         frame_range=[0, 3], used_cam_ids=[0],
                         load_smpl_pos_map=True, smpl_model_path=smpl),
               net_ckpt_dir=os.path.join(d, "ckpt"),
               loss_weight=dict(l1=1.0)),
    test=dict(pose_data=dict(
        data_path=cf.write_pose_sequence(
            os.path.join(d, "thuman4_pose_00.npz"), 2),
        smpl_model_path=smpl,
        mano_dir=cf.write_mano(os.path.join(d, "mano"))),
        view_setting="front", img_scale=0.0625, n_pca=1, fix_hand=True,
        save_ply=True, output_dir=os.path.join(d, "out")),
    model=dict(with_viewdirs=True, channel_max=8))
cfg = os.path.join(d, "a.yaml")
yaml.safe_dump(opt, open(cfg, "w"))
main_avatar_torch.main(["-c", cfg, "-m", "test"], device="cpu")
assert len(os.listdir(os.path.join(d, "out", "posed_gaussians"))) == 2
mods = [m for m in sys.modules if m in ("jax", "sklearn", "joblib")
        or m.startswith(("jax.", "sklearn.", "animatablegaussians_tpu"))]
assert not mods, mods
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


# ---------------------------------------------------------------------------
# on the card, at full width
# ---------------------------------------------------------------------------

# run A's novel poses, frames a render_sequence call and PCA components
# (the capture's 3 training frames allow at most 3; the shipped configs'
# 20 wait for a real capture); run B's frames
ANIM_FRAMES, ANIM_SEQ, ANIM_PCA, ANIM_B_FRAMES = 12, 4, 2, 2
# transform_pca on the card against its float64 CPU version, relative to
# the largest entry: the same float64 arithmetic on two devices
RTOL_PCA = 1e-5


@pytest.fixture(scope="module")
def card_runs(card, tmp_path_factory):
    """The capture, its render checkpoint and the three runs' tests."""
    tmp = str(tmp_path_factory.mktemp("animate"))
    opt = write_capture(tmp)
    ckpt = render_checkpoint(opt, os.path.join(tmp, "animate_ckpt"), card)
    pose_data = dict(data_path=cf.write_pose_sequence(
        os.path.join(tmp, "thuman4", "pose_00.npz"), ANIM_FRAMES, seed=16),
        smpl_model_path=opt["train"]["data"]["smpl_model_path"])
    mano = cf.write_mano(os.path.join(tmp, "mano"),
                         n_verts_total=cf.FULL["n_verts"])
    free = dict(pose_data=pose_data, view_setting="free", global_orient=True,
                img_scale=1.0, n_pca=ANIM_PCA, sigma_pca=2.0)
    runs = {
        "A": dict(free, seq_frames=ANIM_SEQ),
        "B": dict(pose_data=dict(pose_data, frame_range=[0, ANIM_B_FRAMES],
                                 mano_dir=mano),
                  view_setting="front", img_scale=1.0, n_pca=-1,
                  fix_hand=True, fix_hand_id=1, save_ply=True,
                  save_tex_map=True, render_skeleton=True),
        "C": free}
    return tmp, opt, {k: dict(v, prev_ckpt=ckpt, output_dir=os.path.join(
        tmp, f"animate_{k}")) for k, v in runs.items()}


def _jax_file_indices(pose_list) -> list:
    """The frame file indices the JAX package's PoseDataset gives in
    run_test's call order (getitem_fast(0), then every index): a pose
    not past the last index takes the last + 1, pose 0 stays 0
    (animatablegaussians_tpu/data/pose_dataset.py:295-321)."""
    last, out = 0, []
    for i in [0] + list(range(len(pose_list))):
        p = pose_list[i]
        last = p if (p == 0 or p > last) else last + 1
        out.append(last)
    return out[1:]


@pytest.mark.gpu
@pytest.mark.parametrize("run", ["A", "B", "C"])
def test_animation_entry_point_on_a_full_width_capture(card, card_runs,
                                                       monkeypatch, run):
    from animatablegaussians_torch.utils import exr
    tmp, opt, runs = card_runs
    test = runs[run]
    cfg = write_config(dict(opt, test=test),
                       os.path.join(tmp, f"animate_{run}.yaml"))
    frames = []
    inner_write = tanimate._write_frame

    def write(item, items, extr, intr, img_w, img_h, output, *rest):
        inner_write(item, items, extr, intr, img_w, img_h, output, *rest)
        frames.append(dict(item=item, items=items, size=(img_w, img_h),
                           output=output))

    monkeypatch.setattr(tanimate, "_write_frame", write)
    reset_launches(*kernels())
    trainer = main_avatar_torch.main(["-c", cfg, "-m", "test"],
                                     device=str(card))
    n_launch = launches(*kernels())
    net = trainer.avatar_net
    poses = trainer.test_datasets["poses"]
    n = len(frames)
    # calls to the heads: one a render_sequence batch (one a frame with
    # the exports), and the mean hands'
    per = 1 if (test.get("save_ply") or test.get("save_tex_map")) else int(
        test.get("seq_frames", 8))
    calls = -(-n // per) + bool(test.get("fix_hand"))
    assert n == len(poses)
    assert n_launch == {"expand_pairs": n, "blend_tiles": n,
                        "blend_backward": 0,
                        "upfirdn2d_fir": calls * fir_count(net)[0]}

    # the file names and counts: the JAX package's rule, one per frame
    names = ["%08d" % i for i in _jax_file_indices(poses.pose_list)]
    folders = {"rgb_map": ".jpg", "mask_map": ".png"}
    if test.get("save_tex_map"):
        folders["cano_tex_map"] = ".jpg"
    if test.get("render_skeleton"):
        folders["live_skeleton"] = ".jpg"
    if test.get("save_ply"):
        folders["posed_gaussians"] = ".ply"
    out_dir = test["output_dir"]
    assert {f: sorted(os.listdir(os.path.join(out_dir, f)))
            for f in sorted(os.listdir(out_dir))} == {
        f: [x + e for x in names] for f, e in sorted(folders.items())}
    assert [f["item"]["data_idx"] for f in frames] == [int(x) for x in names]

    # the mean hands of the plain path, from the same fixed frame
    hand_vals = None
    if test.get("fix_hand"):
        m = exr.read_exr(os.path.join(opt["train"]["data"]["data_dir"],
                                      "smpl_pos_map",
                                      "%08d.exr" % test["fix_hand_id"]))
        half = m.shape[1] // 2
        hand_vals = net.generate_mean_hands(torch.as_tensor(
            np.concatenate([m[:, :half], m[:, half:]], axis=2)[..., :3],
            device=net.lbs.device), plain=True)
    # each frame against the plain path on the same items: the same call
    # (a render_sequence batch, or a render) at ATOL_BLEND, and a render of
    # the frame alone, whose batch-1 convs sum in another order than the
    # batch's, at ATOL_FIR_IMG; in both, but for the pixels where an alpha
    # decision flips (tools/frame_compare.py's rule, with the span of one
    # contribution from the frame's posed Gaussians)
    kw = dict(bg_color=(1.0, 1.0, 1.0), img_w=frames[0]["size"][0],
              img_h=frames[0]["size"][1], use_pca=test["n_pca"] >= 1,
              hand_vals=hand_vals, plain=True)
    atol_alone = dict.fromkeys(ATOL_BLEND, ATOL_FIR_IMG)
    same, alone = [], []
    for b in range(0, n, per):
        batch = frames[b:b + per]
        assert all(f["size"] == frames[0]["size"] for f in batch)
        if len(batch) > 1:
            out = net.render_sequence({k: torch.stack(
                [f["items"][k] for f in batch]) for k in batch[0]["items"]},
                **kw)
            refs = [{k: v[i] for k, v in out.items()}
                    for i in range(len(batch))]
        else:
            refs = [net.render(batch[0]["items"], **kw)]
        for f, ref in zip(batch, refs):
            o = f["output"]
            for k in ("rgb_map", "depth_map", "mask_map"):
                assert torch.isfinite(o[k]).all(), k
            one = ref if len(batch) == 1 else net.render(f["items"], **kw)
            g = one["posed_gaussians"]
            span = fc.contribution_span(
                g["positions"][net.valid], g["colors"][net.valid],
                f["items"]["extr"], kw["bg_color"])
            same.append(fc.flip_diff(o, ref, ATOL_BLEND, span))
            if len(batch) > 1:
                alone.append(fc.flip_diff(o, one, atol_alone, span))
            if test.get("save_ply"):
                ply = tgm.load_gaussians_from_ply(os.path.join(
                    out_dir, "posed_gaussians",
                    "%08d.ply" % f["item"]["data_idx"]))
                pos = o["posed_gaussians"]["positions"][net.valid].cpu()
                assert ply["positions"].shape == (net.n_valid, 3)
                assert torch.equal(torch.from_numpy(ply["positions"]), pos)
            del one, g
        del refs
    print(f"run {run}, against the plain path's same call: "
          + fc.flip_summary(same, ATOL_BLEND)
          + (f"; against the frame alone: "
             + fc.flip_summary(alone, atol_alone) if alone else ""))
    assert fc.flips_ok(same, ATOL_BLEND) and fc.flips_ok(alone, atol_alone)
    assert min(d["in_view"] for d in same) >= ANIM_COVER_MIN

    if test["n_pca"] >= 1:
        # transform_pca on the card against its float64 CPU version, on
        # the last frame's regenerated pose map
        fit = trainer.test_datasets["training"]
        pm = frames[-1]["items"]["smpl_pos_map"][..., :3]
        rows = pm[torch.as_tensor(fit.pos_map_mask, device=pm.device)]
        dev_out = fit.transform_pca(rows, sigma_pca=2.0).cpu().double()
        cpu_out = fit.transform_pca(rows.cpu().double(), sigma_pca=2.0)
        rel = float((dev_out - cpu_out).abs().max() / cpu_out.abs().max())
        assert rel <= RTOL_PCA, rel
