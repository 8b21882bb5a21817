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
einsums)."""

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
from tests.test_template import _uv_sphere

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
    timings = {}
    got = tgwv.build_weight_volume(verts, faces, verts, faces, lbs, res=10,
                                   n_surface=2000, device="cpu",
                                   timings=timings)
    want = jgwv.build_weight_volume(verts, faces, verts, faces, lbs,
                                    res=10, n_surface=2000)
    assert set(timings) == {"surface", "knn", "jacobi", "ori", "sdf"}
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
            timings = {}
            tgpm.generate(d, ds, ds.smpl_model, map_size=48, device="cpu",
                          timings=timings)
            assert set(timings) == {"bake", "lbs", "pose_maps"}
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
    assert set(run.timings) == {"sdf_s", "mcubes_s", "write_s"}

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
