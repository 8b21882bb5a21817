"""The template stack's data path, tools and CLI against the JAX package
on the CPU: the multi-view dataset's nerf mode, ``gen_weight_volume``,
``gen_pos_maps`` and ``main_template_torch.py`` on a small capture that
``tools/capture_fixture.py`` writes (96x96 JPEGs, 120 SMPL-X vertices
scaled by 0.3 so the body stays in front of the cameras, the MANO maps);
and that the port imports nothing of JAX.

Tolerances: the dataset's items and the rays exact (the same files, the
same numpy draw); the weight volumes 1e-5 absolute (KNN and nearest-face
distances summed in another order) except where a grid point's two
nearest SMPL faces tie within float32 rounding, where the "ori" weights
may come from either face (1e-4, measured below 4e-5); the pose maps and
texel weights 1e-5 absolute (the trilinear gather; float32 skinning
einsums).

Marked ``gpu`` (skipped without a CUDA device): the template stack in the
user's order on a full-width capture of its own (2 cameras x 2 frames of
1500x2048, SMPL-X's real shapes scaled by 0.3, the MANO maps) and the
shipped template.yaml (with_hand, use_root_finding, 1024 rays x 64
samples): gen_weight_volume at TPL_RES^3 (and at 16^3 on the card against
the CPU), main_template_torch for TPL_ITERS iterations (no splat or FIR
kernel launches, every nearest-face search through its kernel, finite
losses, an exported mesh), one step at 64 rays on the card against the
CPU, and gen_pos_maps on the exported template."""

import ast
import functools
import glob
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from animatablegaussians_tpu.data import MvRgbDatasetAvatarReX as JDataset
from animatablegaussians_tpu.tools import gen_pos_maps as jgpm
from animatablegaussians_tpu.tools import gen_weight_volume as jgwv
from animatablegaussians_tpu.utils import nerf as jnerf
from animatablegaussians_torch.data import mv_rgb_dataset as tmv
from animatablegaussians_torch.tools import capture_fixture as cf
from animatablegaussians_torch.tools import gen_pos_maps as tgpm
from animatablegaussians_torch.tools import gen_weight_volume as tgwv
from animatablegaussians_torch.training import template_trainer as tt
from animatablegaussians_torch.utils import exr
from animatablegaussians_torch.utils import nerf as tnerf
from animatablegaussians_torch.utils.ply import write_ply
from test_template import _uv_sphere
from on_card import card, kernels, launches, reset_launches  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
ATOL_TIE = 1e-4
BODY_SCALE = 0.3


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tcap"))
    smpl = cf.write_capture(os.path.join(d, "cap"), n_frames=2,
                            body_scale=BODY_SCALE)
    mano = cf.write_mano(os.path.join(d, "mano"))
    kw = dict(frame_range=[0, 2], used_cam_ids=[0, 1], mode="nerf",
              smpl_model_path=smpl, mano_dir=mano)
    return dict(dir=d, data_dir=os.path.join(d, "cap"), smpl=smpl,
                mano=mano, kw=kw)


def _config(capture, path, **data):
    """The shipped template.yaml with its data pointed at the capture."""
    with open(os.path.join(REPO, "configs", "avatarrex_zzr",
                           "template.yaml")) as fp:
        opt = yaml.safe_load(fp)
    opt["train"]["data"].update(
        data_dir=capture["data_dir"], used_cam_ids=[0, 1],
        frame_range=[0, 2], smpl_model_path=capture["smpl"],
        mano_dir=capture["mano"], **data)
    opt["train"]["net_ckpt_dir"] = os.path.join(os.path.dirname(path),
                                                "ckpt")
    with open(path, "w") as fp:
        yaml.safe_dump(opt, fp)
    return path


def test_nerf_item_matches_jax(capture):
    """A nerf-mode training item: the pose, camera and MANO keys equal the
    JAX dataset's, and the rays equal JAX's sample_rays_for_training on
    the same view with one seeded generator."""
    tds = tmv.MvRgbDatasetAvatarReX(capture["data_dir"], ray_seed=7,
                                    **capture["kw"])
    jds = JDataset(capture["data_dir"], **capture["kw"])
    got, want = tds[1], jds[1]
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "nerf_random":
            continue
        if isinstance(v, np.ndarray):
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        else:
            assert got[k] == v, k
    pose_idx, view_idx = jds.data_list[1]
    color, mask = jds.load_color_mask_images(pose_idx, view_idx)
    boundary, mask_bin = jds.get_boundary_mask(mask)
    rays = jnerf.sample_rays_for_training(
        (color / 255.0).astype(np.float32), mask_bin,
        jds.extr_mats[view_idx], jds.intr_mats[view_idx],
        want["live_bounds"], unsample_region_mask=boundary,
        rng=np.random.default_rng(7))
    assert set(got["nerf_random"]) == set(rays)
    for k, v in rays.items():
        np.testing.assert_allclose(got["nerf_random"][k], v, rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert len(rays["ray_o"]) == 1024
    assert 0 < got["nerf_random"]["mask_gt"].mean() < 1
    items = tt.template_items(got, tds.smpl_model.data.lbs_weights, "cpu")
    assert set(tt.MANO_KEYS) <= set(items)
    assert items["mano_face_closed"].dtype == torch.int64


def test_build_weight_volume_matches_jax():
    """The three volumes at 10^3 on a sphere template with random weights
    (as tests/test_tools.py's case), SMPL = template."""
    verts, faces = _uv_sphere(n_theta=8, n_phi=10, r=0.4)
    rng = np.random.default_rng(0)
    lbs = rng.random((len(verts), 6)).astype(np.float32)
    lbs /= lbs.sum(1, keepdims=True)
    got = tgwv.build_weight_volume(verts, faces, verts, faces, lbs, res=10,
                                   n_surface=2000, device="cpu")
    want = jgwv.build_weight_volume(verts, faces, verts, faces, lbs,
                                    res=10, n_surface=2000)
    assert set(got) == set(want)
    for k in ("diff_weight_volume", "sdf_volume", "volume_bounds",
              "center", "smpl_bounds"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, err_msg=k)
    np.testing.assert_allclose(got["ori_weight_volume"],
                               want["ori_weight_volume"], atol=ATOL_TIE)
    np.testing.assert_allclose(got["diff_weight_volume"].sum(-1), 1.0,
                               atol=1e-5)
    assert got["sdf_volume"][5, 5, 5] < 0 < got["sdf_volume"][0, 0, 0]


@pytest.mark.parametrize("template", [False, True])
def test_gen_pos_maps_matches_jax(capture, tmp_path, template):
    """The bake at map size 48, per-texel weights and per-frame pose maps:
    from the canonical SMPL-X (barycentric weights), or from a template
    mesh with a weight volume (the volume's weights)."""
    outs = {}
    for pkg in ("jax", "port"):
        d = str(tmp_path / pkg)
        shutil.copytree(capture["data_dir"], d)
        shutil.rmtree(os.path.join(d, "smpl_pos_map"))
        kw = dict(capture["kw"], mode="3dgs")
        if template:
            v, f = _uv_sphere(n_theta=10, n_phi=14, r=0.35)
            write_ply(os.path.join(d, "template.ply"),
                      dict(x=v[:, 0], y=v[:, 1], z=v[:, 2]), faces=f)
            ds = tmv.MvRgbDatasetAvatarReX(d, **kw)
            np.savez(os.path.join(d, "cano_weight_volume.npz"),
                     **tgwv.build_weight_volume(
                         v, f.astype(np.int64), ds.cano_smpl["vertices"],
                         np.asarray(ds.smpl_model.faces, np.int64),
                         ds.smpl_model.data.lbs_weights.numpy(), res=8,
                         n_surface=500, device="cpu"))
        if pkg == "jax":
            ds = JDataset(d, **kw)
            jgpm.generate(d, ds, ds.smpl_model, map_size=48)
        else:
            ds = tmv.MvRgbDatasetAvatarReX(d, **kw)
            tgpm.generate(d, ds, ds.smpl_model, map_size=48, device="cpu")
        outs[pkg] = os.path.join(d, "smpl_pos_map")
    names = sorted(os.listdir(outs["port"]))
    assert names == sorted(os.listdir(outs["jax"])) == [
        "00000000.exr", "00000001.exr", "cano_smpl_nml_map.exr",
        "cano_smpl_pos_map.exr", "init_pts_lbs.npy"]
    for n in names:
        read = np.load if n.endswith(".npy") else exr.read_exr
        a, b = (read(os.path.join(outs[p], n)) for p in ("port", "jax"))
        assert a.shape == b.shape, n
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=n)
    pos = exr.read_exr(os.path.join(outs["port"], "cano_smpl_pos_map.exr"))
    assert pos.shape == (48, 96, 3) and (np.abs(pos).sum(-1) > 0).any()


def _fewer_rays(monkeypatch, n=64):
    """The dataset's ray draw at ``n`` rays instead of 1024 (speed)."""
    monkeypatch.setattr(tnerf, "sample_rays_for_training", functools.partial(
        tnerf.sample_rays_for_training, sample_num=n))


def test_template_cli_on_cpu(capture, tmp_path, monkeypatch):
    """The user's order on the CPU: gen_weight_volume, then
    main_template_torch on the shipped template.yaml (train.data.mode:
    nerf, with_hand and use_root_finding on) for 2 iterations with a
    checkpoint, writing a readable template.ply; then gen_pos_maps on it.
    """
    import main_template_torch
    from animatablegaussians_torch.models.template import TemplateNet
    from animatablegaussians_torch.models.volume import \
        CanoBlendWeightVolume
    from animatablegaussians_torch.utils.ply import read_ply

    d = str(tmp_path / "cap")
    shutil.copytree(capture["data_dir"], d)
    cfg = _config(dict(capture, data_dir=d), str(tmp_path / "t.yaml"))
    tgwv.main(["-c", cfg, "--res", "8", "--device", "cpu"])
    _fewer_rays(monkeypatch)
    monkeypatch.setattr(main_template_torch, "CKPT_EVERY", 2)
    terms = []
    run = main_template_torch.main(
        ["-c", cfg, "--max_iters", "2"], device="cpu",
        testing_res=(16, 16, 8),
        on_step=lambda it, t: terms.append({k: float(v)
                                            for k, v in t.items()}))
    assert run.iters == 2 and len(terms) == 2
    assert all(np.isfinite(list(t.values())).all() for t in terms)
    assert set(terms[0]) == {"color_loss_random", "mask_loss_random",
                             "eikonal_loss", "total_loss"}
    props, faces = read_ply(run.template_path)
    assert len(faces) == run.n_faces > 0 and len(props["x"]) == run.n_verts

    ckpt = os.path.join(run.net_ckpt_dir, "epoch_latest")
    net = torch.load(os.path.join(ckpt, "net.pt"), weights_only=True)
    optm = torch.load(os.path.join(ckpt, "optm.pt"), weights_only=True)
    assert net["iter_idx"] == 2 and optm["lr_scheduler"]["last_epoch"] == 2
    fresh = TemplateNet(run.net.opt, CanoBlendWeightVolume(
        os.path.join(d, "cano_weight_volume.npz"), device="cpu"),
        device="cpu", seed=1)
    fresh.load_state_dict(net["template_net"])
    for k, v in run.net.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k

    # the bake at 32^2 instead of 1024^2 (speed: the numpy rasterizer)
    monkeypatch.setattr(tgpm, "generate", functools.partial(
        tgpm.generate, map_size=32))
    tgpm.main(["-c", cfg, "--device", "cpu"])
    maps = sorted(glob.glob(os.path.join(d, "smpl_pos_map", "0*.exr")))
    assert len(maps) == 2
    lbs = np.load(os.path.join(d, "smpl_pos_map", "init_pts_lbs.npy"))
    np.testing.assert_allclose(lbs.sum(1), 1.0, atol=1e-4)


def test_template_cli_modes_and_device(capture, tmp_path):
    """The CLI takes the config's train.data.mode (the shipped configs set
    nerf; the JAX CLI passes mode a second time) and refuses another; the
    entry points run on the card unless told otherwise, and without one
    they raise instead of running on the CPU."""
    import main_template_torch
    cfg = _config(capture, str(tmp_path / "t.yaml"), mode="3dgs")
    with pytest.raises(ValueError, match="nerf"):
        main_template_torch.main(["-c", cfg], device="cpu")
    if torch.cuda.is_available():
        return
    cfg = _config(capture, str(tmp_path / "n.yaml"))
    for entry in (main_template_torch.main, tgwv.main, tgpm.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(["-c", cfg])


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_nothing_of_jax():
    """No module of animatablegaussians_torch/, no port CLI and not
    chip_smoke.py imports jax or the JAX package (import statements at any
    depth, functions included)."""
    files = glob.glob(os.path.join(REPO, "animatablegaussians_torch", "**",
                                   "*.py"), recursive=True)
    files += [os.path.join(REPO, n) for n in (
        "main_avatar_torch.py", "main_template_torch.py", "chip_smoke.py")]
    assert len(files) > 40
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "optax", "flax",
                                  "animatablegaussians_tpu")]
    assert not bad, bad


# ---------------------------------------------------------------------------
# on the card, at full width
# ---------------------------------------------------------------------------

# the capture's frames, the weight volume's grid and the template CLI's
# iterations
TPL_FRAMES, TPL_RES, TPL_ITERS = 2, 128, 12
# the card against the CPU path on the same inputs: the weight volume at
# 16^3 from 8,192 surface samples (the CPU's nearest-face search takes ~1 s
# per 1,024 points against SMPL-X's 20,908 faces, so 32^3 and the full
# 100,000 samples would take minutes), and one template step at 64 rays
TPL_CHECK_RES, TPL_CHECK_SURFACE, TPL_CHECK_RAYS = 16, 8192, 64
# per volume, entries off by more than TPL_VOL_ATOL (the two devices' sums
# over 3 coordinates round differently) may be at most this share: where a
# grid point's two nearest faces tie within float32 rounding, either face
# may win, and its weights or its normal's sign come with it
TPL_VOL_ATOL, TPL_VOL_TIE_SHARE = 1e-5, 5e-3
# the template step, card against CPU: loss terms relative, each parameter
# group's gradient relative L2. The gradients are sensitive to rounding
# (the eikonal term's double backward through softplus(beta = 100), the
# SMPL-sphere near/far's cancellation b +- sqrt(b^2 - c)): on the CPU the
# same step in float32 against float64 differs by 2.2e-3 in geo_mlp and
# 2.0e-3 in density on a small capture; the card against the CPU read
# <= 5.44e-5 (H100, with the hands at the body's x extremes)
TPL_RTOL_LOSS, TPL_RTOL_GRAD = 1e-4, 1e-2


@pytest.fixture(scope="module")
def card_stack(card, tmp_path_factory):
    """The capture and config, then gen_weight_volume at TPL_RES^3 and
    main_template_torch for TPL_ITERS iterations, as a user runs them,
    with the kernels' launches in the CLI's run and its loss terms."""
    from animatablegaussians_torch.ops import geometry3d as g3d
    from animatablegaussians_torch.utils import profiling

    import main_template_torch
    tmp = str(tmp_path_factory.mktemp("template"))
    data_dir = os.path.join(tmp, "capture")
    smpl_path = cf.write_capture(data_dir, n_frames=TPL_FRAMES,
                                 body_scale=BODY_SCALE, **cf.FULL)
    # the hands at the canonical body's x extremes (write_mano)
    ds = tmv.MvRgbDatasetAvatarReX(data_dir, frame_range=[0, 1],
                                   smpl_model_path=smpl_path)
    body = (ds.cano_smpl["vertices"],
            np.asarray(ds.smpl_model.faces, np.int64),
            ds.smpl_model.data.lbs_weights.cpu().numpy())
    mano_dir = cf.write_mano(os.path.join(tmp, "mano"),
                             n_verts_total=cf.FULL["n_verts"],
                             cano_verts=body[0])
    del ds
    with open(os.path.join(REPO, "configs", "avatarrex_zzr",
                           "template.yaml")) as fp:
        opt = yaml.safe_load(fp)
    opt["train"]["data"].update(
        data_dir=data_dir, used_cam_ids=[0, 1], frame_range=[0, TPL_FRAMES],
        smpl_model_path=smpl_path, mano_dir=mano_dir)
    opt["train"]["net_ckpt_dir"] = os.path.join(tmp, "ckpt")
    cfg = os.path.join(tmp, "template.yaml")
    with open(cfg, "w") as fp:
        yaml.safe_dump(opt, fp)
    dev = str(card)
    vol_path = tgwv.main(["-c", cfg, "--res", str(TPL_RES)], device=dev)
    reset_launches(*kernels(), g3d.nearest_face)
    profiling.reset_counters("nearest_face.calls")
    terms = []
    run = main_template_torch.main(
        ["-c", cfg, "--max_iters", str(TPL_ITERS)], device=dev,
        on_step=lambda it, t: terms.append({k: float(v)
                                            for k, v in t.items()}))
    n = launches(*kernels(), g3d.nearest_face)
    n["nearest_face.calls"] = profiling.counters().get(
        "nearest_face.calls", 0)
    return dict(cfg=cfg, data_dir=data_dir, vol_path=vol_path, body=body,
                run=run, terms=terms, launches=n)


@pytest.mark.gpu
def test_weight_volume_on_the_card(card, card_stack):
    with np.load(card_stack["vol_path"]) as f:
        vol = {k: f[k] for k in f.files}
    assert all(np.isfinite(v).all() for v in vol.values())
    assert vol["diff_weight_volume"].shape == (TPL_RES,) * 3 + (55,)
    assert np.abs(vol["diff_weight_volume"].sum(-1) - 1).max() < 1e-4
    sv, sf, sl = card_stack["body"]
    small = {str(d): tgwv.build_weight_volume(
        sv, sf, sv, sf, sl, res=TPL_CHECK_RES, n_surface=TPL_CHECK_SURFACE,
        device=d) for d in (card, "cpu")}
    for k in ("diff_weight_volume", "ori_weight_volume", "sdf_volume"):
        e = np.abs(small[str(card)][k] - small["cpu"][k])
        e = e.reshape(TPL_CHECK_RES ** 3, -1).max(1)
        share = float((e > TPL_VOL_ATOL).mean())
        print(f"{k}: max {e.max():.2e}, share over {TPL_VOL_ATOL:g} "
              f"{share:.4f}")
        assert share <= TPL_VOL_TIE_SHARE, (k, share)


@pytest.mark.gpu
def test_template_cli_on_the_card(card_stack):
    """No splat or FIR kernel launches on the template path; every
    nearest-face search goes through its kernel; the losses are finite and
    the export writes a mesh."""
    n, run = card_stack["launches"], card_stack["run"]
    assert n.pop("nearest_face") == n.pop("nearest_face.calls") > 0
    assert not any(n.values()), n
    assert len(card_stack["terms"]) == TPL_ITERS
    assert all(np.isfinite(list(t.values())).all()
               for t in card_stack["terms"])
    assert run.n_faces > 0


@pytest.mark.gpu
def test_template_step_on_the_card_against_the_cpu(card, card_stack):
    """One template step's loss terms and gradients on the card against
    the same step on the CPU: TPL_CHECK_RAYS rays of the first item, three
    quarters those that the card's render of all the rays accumulates
    most, a quarter those it accumulates least (so that the body and its
    colour have gradients to compare), the run's parameters, draws made on
    the host."""
    import copy

    from animatablegaussians_torch.models.template import TemplateNet
    from animatablegaussians_torch.models.volume import \
        CanoBlendWeightVolume

    run = card_stack["run"]
    smpl_lbs = run.dataset.smpl_model.data.lbs_weights.cpu().numpy()
    items = tt.template_items(run.dataset[0], smpl_lbs, card)
    net_cpu = TemplateNet(run.net.opt, CanoBlendWeightVolume(
        card_stack["vol_path"], device="cpu"), device="cpu")
    net_cpu.load_state_dict({k: v.cpu() for k, v in
                             run.net.state_dict().items()})
    n, S = TPL_CHECK_RAYS, run.step.n_samples
    with torch.no_grad():
        acc = run.net.render_rays(items, items["ray_o"], items["ray_d"],
                                  items["near"], items["far"],
                                  n_samples=S)["acc_map"]
    order = torch.argsort(acc, descending=True, stable=True)
    pick = torch.sort(torch.cat([order[:n - n // 4],
                                 order[-(n // 4):]])).values
    sub = {k: v[pick] if k in tt.RAY_KEYS else v for k, v in items.items()}
    gen = torch.Generator().manual_seed(5)
    draws = dict(t_rand=torch.rand((n, S), generator=gen),
                 view_noise=torch.randn((n * S, 3), generator=gen))
    res = {}
    for name, net in (("card", run.net), ("cpu", net_cpu)):
        d = next(net.parameters()).device
        st = copy.copy(run.step)
        st.net = net
        net.zero_grad(set_to_none=True)
        total, terms = st.loss({k: v.to(d) for k, v in sub.items()},
                               draws={k: v.to(d) for k, v in draws.items()})
        total.backward()
        groups = {}
        for pn, p in net.named_parameters():
            groups.setdefault(pn.split(".")[0], []).append(
                p.grad.detach().reshape(-1).cpu().double())
        res[name] = ({k: float(v.detach()) for k, v in terms.items()},
                     {g: torch.cat(v) for g, v in groups.items()})
        net.zero_grad(set_to_none=True)
    (t_card, g_card), (t_cpu, g_cpu) = res["card"], res["cpu"]
    loss_err = {k: abs(t_card[k] - v) / max(abs(v), 1e-30)
                for k, v in t_cpu.items()}
    grad_err = {g: float((g_card[g] - v).norm() / v.norm().clamp(min=1e-30))
                for g, v in g_cpu.items()}
    norms = {g: float(v.norm()) for g, v in g_cpu.items()}
    print(f"loss terms {loss_err}, gradients {grad_err}, norms {norms}")
    assert all(np.isfinite(v) for v in t_card.values())
    assert all(bool(torch.isfinite(v).all()) for v in g_card.values())
    # the body's groups must have gradients to compare; the hands' only
    # where a ray reaches them
    assert all(norms[g] > 0 for g in ("geo_mlp", "tex_mlp", "density"))
    assert max(loss_err.values()) <= TPL_RTOL_LOSS, loss_err
    assert max(grad_err.values()) <= TPL_RTOL_GRAD, grad_err


@pytest.mark.gpu
def test_pose_maps_from_the_exported_template_on_the_card(card, card_stack):
    out_dir = tgpm.main(["-c", card_stack["cfg"]], device=str(card))
    pos = exr.read_exr(os.path.join(out_dir, "cano_smpl_pos_map.exr"))
    lbs = np.load(os.path.join(out_dir, "init_pts_lbs.npy"))
    maps = sorted(glob.glob(os.path.join(out_dir, "0*.exr")))
    covered = np.linalg.norm(pos, axis=-1) > 0
    assert pos.shape == (1024, 2048, 3) and covered.any()
    assert lbs.shape == (int(covered.sum()), 55)
    assert np.abs(lbs.sum(1) - 1).max() < 1e-4
    assert len(maps) == TPL_FRAMES
    assert exr.read_exr(maps[0]).shape == (512, 1024, 3)
