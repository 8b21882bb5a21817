"""The animation slice's host-side pieces of the port against the JAX
package on the CPU: the view cameras (``utils/visualize``, bit for bit),
``utils/cameras`` (1e-6), the PLY I/O both ways (bit for bit),
``PoseDataset`` over its archive formats, hand modes and options, the
multi-view dataset's testing route, and the PCA pose projection.

Tolerances: numpy code copied from the JAX package is held bit for bit;
the SMPL-X outputs and the keys derived from them to 1e-5 relative with an
absolute floor of 1e-6 (tests/test_torch_data.py's item tolerances);
``transform_pca``'s output to 1e-4 relative to its largest entry, against
sklearn's full SVD solver and against the JAX package's ``compute_pca``
where sklearn picks that solver (the port fits in float64, sklearn in
float32)."""

import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatablegaussians_tpu.data import MvRgbDatasetAvatarReX as JDataset
from animatablegaussians_tpu.data import mv_rgb_dataset as jmv
from animatablegaussians_tpu.data.pose_dataset import PoseDataset as JPose
from animatablegaussians_tpu.models import gaussian_model as jgm
from animatablegaussians_tpu.utils import cameras as jcam
from animatablegaussians_tpu.utils import ply as jply
from animatablegaussians_tpu.utils import visualize as jviz
from animatablegaussians_torch.data import PoseDataset
from animatablegaussians_torch.data import mv_rgb_dataset as tmv
from animatablegaussians_torch.data import pose_dataset as tpd
from animatablegaussians_torch.models import gaussian_model as tgm
from animatablegaussians_torch.tools import capture_fixture as cf
from animatablegaussians_torch.utils import cameras as tcam
from animatablegaussians_torch.utils import exr
from animatablegaussians_torch.utils import ply as tply
from animatablegaussians_torch.utils import visualize as tviz
from test_torch_data import _compare_items

PCA_RTOL = 1e-4


# ---------------------------------------------------------------------------
# utils: visualize, cameras, PLY
# ---------------------------------------------------------------------------

def test_visualize_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(3):
        c = rng.standard_normal(3).astype(np.float32)
        go = jviz._rodrigues(rng.standard_normal(3).astype(np.float32))
        rv = rng.standard_normal(3).astype(np.float32)
        tar = np.array([0, 0, 2.5])
        pairs = [
            (tviz._rodrigues(rv), jviz._rodrigues(rv)),
            (tviz._rodrigues(np.zeros(3, np.float32)),
             jviz._rodrigues(np.zeros(3, np.float32))),
            (tviz._t(go, c), jviz._t(go, c)),
            (tviz.calc_front_mv(c, tar), jviz.calc_front_mv(c, tar)),
            (tviz.calc_back_mv(c), jviz.calc_back_mv(c)),
            (tviz.calc_free_mv(c, tar, 0.7, 0.3),
             jviz.calc_free_mv(c, tar, 0.7, 0.3)),
            (tviz.calc_free_mv(c, tar, 1.1, 0.0, global_orient=go),
             jviz.calc_free_mv(c, tar, 1.1, 0.0, global_orient=go)),
            (tviz.calc_cano_front_mv(c), jviz.calc_cano_front_mv(c)),
            (tviz.calc_cano_back_mv(c), jviz.calc_cano_back_mv(c)),
        ]
        for i, (got, want) in enumerate(pairs):
            assert got.dtype == want.dtype, i
            np.testing.assert_array_equal(got, want, err_msg=str(i))
    heat = np.linspace(-0.1, 1.1, 101)
    np.testing.assert_array_equal(tviz.to_hsv(heat), jviz.to_hsv(heat))


def test_cameras_match_jax():
    rng = np.random.default_rng(1)
    assert tcam.focal_to_fov(1100.0, 1024) == jcam.focal_to_fov(1100.0, 1024)
    assert tcam.fov_to_focal(0.8, 1024) == jcam.fov_to_focal(0.8, 1024)
    K = np.array([[550, 0, 250], [0, 560, 270], [0, 0, 1]], np.float32)
    np.testing.assert_array_equal(
        tcam.projection_matrix(0.1, 100, K, 500, 540),
        jcam.projection_matrix(0.1, 100, K, 500, 540))
    R = jviz._rodrigues(rng.standard_normal(3).astype(np.float32))
    t = rng.standard_normal(3).astype(np.float32)
    extr = tcam.world_to_view(R, t)
    np.testing.assert_array_equal(extr, jcam.world_to_view(R, t))
    v, full = tcam.full_projection(torch.as_tensor(extr), K, 500, 540)
    jv, jfull = jcam.full_projection(jnp.asarray(extr), K, 500, 540)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tcam.camera_center(v).numpy(),
                               np.asarray(jcam.camera_center(jv)), rtol=0,
                               atol=1e-6)


def _gaussians(n, seed=2):
    rng = np.random.default_rng(seed)
    rots = rng.standard_normal((n, 4)).astype(np.float32)
    return dict(
        positions=rng.standard_normal((n, 3)).astype(np.float32),
        opacity=rng.random((n, 1)).astype(np.float32),
        scales=np.exp(rng.standard_normal((n, 3)) - 4).astype(np.float32),
        rotations=rots / np.linalg.norm(rots, axis=1, keepdims=True),
        colors=rng.random((n, 3)).astype(np.float32))


def test_gaussian_ply_both_ways(tmp_path):
    """save_gaussians_as_ply writes the JAX package's bytes (from arrays
    and from tensors); each package loads the other's file to the same
    arrays."""
    g = _gaussians(37)
    a, b, c = (str(tmp_path / f"{n}.ply") for n in "abc")
    jgm.save_gaussians_as_ply(a, g)
    tgm.save_gaussians_as_ply(b, g)
    tgm.save_gaussians_as_ply(c, {k: torch.as_tensor(v) for k, v in g.items()})
    assert open(a, "rb").read() == open(b, "rb").read() == \
        open(c, "rb").read()
    got, want = tgm.load_gaussians_from_ply(a), jgm.load_gaussians_from_ply(b)
    assert got.keys() == want.keys()
    for k in got:
        assert isinstance(got[k], (np.ndarray, int)), k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["positions"], g["positions"])
    np.testing.assert_array_equal(tgm.sh_to_rgb(tgm.rgb_to_sh(g["colors"])),
                                  np.asarray(jgm.sh_to_rgb(
                                      jgm.rgb_to_sh(g["colors"]))))


@pytest.mark.parametrize("body", ["binary", "ascii"])
def test_ply_io_both_ways(tmp_path, body):
    """Vertex properties of several types and a face list: a file the JAX
    writer writes reads back in the port and the reverse (binary), and an
    ASCII body reads the same in both."""
    rng = np.random.default_rng(3)
    props = {"x": rng.standard_normal(9).astype(np.float32),
             "d": rng.standard_normal(9),
             "red": rng.integers(0, 256, 9).astype(np.uint8),
             "i": rng.integers(-5, 5, 9).astype(np.int32)}
    faces = rng.integers(0, 9, (4, 3))
    if body == "binary":
        a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
        jply.write_ply(a, props, faces)
        tply.write_ply(b, props, faces)
        assert open(a, "rb").read() == open(b, "rb").read()
        files = (a, b)
    else:
        a = str(tmp_path / "a.ply")
        rows = [" ".join(str(v) for v in r) for r in
                zip(props["x"], props["d"], props["red"], props["i"])]
        with open(a, "w") as fp:
            fp.write("\n".join(
                ["ply", "format ascii 1.0", "element vertex 9",
                 "property float x", "property double d",
                 "property uchar red", "property int i", "element face 4",
                 "property list uchar int vertex_indices", "end_header"]
                + rows + [f"3 {f[0]} {f[1]} {f[2]}" for f in faces]) + "\n")
        files = (a,)
    for path in files:
        (gv, gf), (wv, wf) = tply.read_ply(path), jply.read_ply(path)
        assert gv.keys() == wv.keys() == props.keys()
        for k in gv:
            assert gv[k].dtype == wv[k].dtype, k
            np.testing.assert_array_equal(gv[k], wv[k], err_msg=k)
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gf, faces)


# ---------------------------------------------------------------------------
# PoseDataset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smpl_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("smpl")
    smpl = str(d / "smplx.npz")
    cf.write_smplx(smpl)
    return smpl, cf.write_mano(str(d / "mano"))


def _write_archive(d, case):
    """(archive path, PoseDataset kwargs) for a case."""
    rng = np.random.default_rng(4)
    n = 9
    if case == "aist":
        path = str(d / "gBR_sBM_c01_d04.pkl")
        with open(path, "wb") as fp:
            pickle.dump({"smpl_poses": 0.1 * rng.standard_normal((n, 72)),
                         "smpl_trans": 100 * rng.standard_normal((n, 3))},
                        fp)
        return path, dict(hand_pose_type="zero", frame_range=[1, 8, 2])
    if case == "amass":
        path = cf.write_pose_sequence(str(d / "CMU_01_poses.npz"), n,
                                      style="amass", seed=5, scale=0.2)
        return path, dict(hand_pose_type="normal", constrain_leg_pose=True,
                          frame_interval=2)
    if case == "thuman4_fist_denoise":
        path = cf.write_pose_sequence(str(d / "thuman4" / "pose_01.npz"), n,
                                      seed=6, scale=0.2)
        return path, dict(hand_pose_type="fist", denoise=True,
                          frame_range=[0, 9])
    if case == "actor01_calibration":
        path = cf.write_pose_sequence(
            str(d / "actorshq" / "pose_actor01.npz"), n, seed=7, scale=0.2)
        cams = {f"Cam{i:03d}": dict(
            R=np.eye(3).reshape(-1).tolist(), T=[0.1 * i, 0.0, 3.0],
            K=[500.0, 0, 200, 0, 510.0, 300, 0, 0, 1], imgSize=[400, 600])
            for i in range(2)}
        with open(str(d / "actorshq" / "calibration_actor01.json"),
                  "w") as fp:
            json.dump(cams, fp)
        # nested ranges, the last repeated twice; indices go back to 0
        return path, dict(hand_pose_type="ori",
                          frame_range=[[0, 3], [5, 9, 2], [2, 4, 1, 2]])
    raise ValueError(case)


@pytest.mark.parametrize("case", ["aist", "amass", "thuman4_fist_denoise",
                                  "actor01_calibration"])
def test_pose_dataset_matches_jax(tmp_path, smpl_files, case):
    """Each archive format and option set: the surgery on the poses, the
    pose list, the calibration, the canonical body, and getitem_fast (the
    default camera and a caller's), getitem_a_pose and __getitem__ with
    the MANO items, in one call order (data_idx depends on it)."""
    smpl, mano = smpl_files
    path, kw = _write_archive(tmp_path, case)
    shape = np.linspace(-0.5, 0.5, 10).astype(np.float32)
    kw = dict(kw, smpl_shape=shape, smpl_model_path=smpl, mano_dir=mano)
    want, got = JPose(path, **kw), PoseDataset(path, **kw)
    assert (got.dataset_name, got.seq_name) == (want.dataset_name,
                                                want.seq_name)
    assert got.pose_list == want.pose_list and len(got) == len(want)
    for k in ("body_poses", "transl", "left_hand_pose", "right_hand_pose"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    if case == "actor01_calibration":
        assert got.cam_names == want.cam_names
        for k in ("extr_mats", "intr_mats", "img_widths", "img_heights"):
            np.testing.assert_array_equal(getattr(got, k),
                                          getattr(want, k), err_msg=k)
    else:
        assert got.extr_mats is want.extr_mats is None
    _compare_items({k: getattr(got, k) for k in ("cano_smpl_center",
                                                 "cano_bounds",
                                                 "inv_cano_jnt_mats")},
                   {k: getattr(want, k) for k in ("cano_smpl_center",
                                                  "cano_bounds",
                                                  "inv_cano_jnt_mats")})
    cam = dict(extr=jviz.calc_back_mv(np.zeros(3)), img_w=64, img_h=48,
               intr=np.array([[60, 0, 32], [0, 60, 24], [0, 0, 1]],
                             np.float32))
    order = [0, len(got) - 1, 1, 1, 0, len(got) // 2]
    for j, i in enumerate(order):
        ckw = cam if j % 2 else {}
        _compare_items(got.getitem_fast(i, **ckw),
                       want.getitem_fast(i, **ckw))
    _compare_items(got[2], want[2])
    _compare_items(got.getitem_a_pose(), want.getitem_a_pose())
    assert "left_cano_mano_v" in got.getitem_fast(0)


def test_pose_dataset_data_idx_call_order(tmp_path, smpl_files):
    """Nested frame ranges that revisit poses: the file-name index follows
    the JAX package's rule (a revisited pose takes the last index + 1,
    pose 0 stays 0) in run_test's call order (getitem_fast(0) once, then
    every index); getitem (the NeRF rays) against JAX's."""
    smpl, _ = smpl_files
    path = cf.write_pose_sequence(str(tmp_path / "thuman4_pose_00.npz"), 6)
    kw = dict(frame_range=[[0, 4], [1, 3], [0, 6, 2, 2]],
              smpl_model_path=smpl)
    want, got = JPose(path, **kw), PoseDataset(path, **kw)
    calls = [0] + list(range(len(got)))
    a = [got.getitem_fast(i)["data_idx"] for i in calls]
    b = [want.getitem_fast(i)["data_idx"] for i in calls]
    assert a == b
    assert a != [got.pose_list[i] for i in calls]     # the rule acted
    _compare_items(got.getitem(0), want.getitem(0))


# ---------------------------------------------------------------------------
# the multi-view dataset's testing route and the PCA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("capture"))
    smpl = cf.write_capture(d, n_frames=5, pose_map_jitter=0.02)
    mano = cf.write_mano(os.path.join(d, "mano"))
    return d, smpl, mano


def test_mv_rgb_testing_route_matches_jax(capture):
    """training=False: the length over the pose list, the default 512^2
    front camera, a caller's camera, and the canonical and live MANO items
    on testing items only."""
    d, smpl, mano = capture
    kw = dict(frame_range=[1, 4], load_smpl_pos_map=True,
              smpl_model_path=smpl, mano_dir=mano)
    want = JDataset(d, training=False, **kw)
    got = tmv.MvRgbDatasetAvatarReX(d, training=False, **kw)
    assert len(got) == len(want) == 3
    assert not hasattr(got, "data_list")
    cam = dict(extr=jviz.calc_front_mv(np.ones(3)), img_w=40, img_h=30,
               intr=np.array([[50, 0, 20], [0, 50, 15], [0, 0, 1]],
                             np.float32))
    for i in range(3):
        for ckw in ({}, cam):
            g = got.getitem(i, training=False, **ckw)
            _compare_items(g, want.getitem(i, training=False, **ckw))
            assert g["data_idx"] == got.pose_list[i]
            assert "right_live_mano_n" in g
    train = tmv.MvRgbDatasetAvatarReX(d, used_cam_ids=[0], **kw)
    assert "left_cano_mano_v" not in train.getitem(0)


def _sklearn_transform(x, n, sigma, rows):
    from sklearn.decomposition import PCA
    pca = PCA(n_components=n, svd_solver="full").fit(x)
    low = pca.transform(rows)
    std = np.sqrt(pca.explained_variance_)
    return pca.inverse_transform(np.clip(low, -sigma * std, sigma * std))


def _write_pose_maps(d, n_frames, h, seed):
    """Pose-map EXRs (h, 2h, 3) of n_frames correlated random frames, a
    masked-out border in the front half."""
    os.makedirs(os.path.join(d, "smpl_pos_map"), exist_ok=True)
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((h, 2 * h, 3)).astype(np.float32)
    modes = rng.standard_normal((4, h, 2 * h, 3)).astype(np.float32)
    for i in range(n_frames):
        m = base + np.tensordot(rng.standard_normal(4) * [2, 1, .5, .2],
                                modes, 1) + 0.01 * rng.standard_normal(
                                    base.shape)
        m[:2] = 0.0
        exr.write_exr(os.path.join(d, "smpl_pos_map", "%08d.exr" % i),
                      m.astype(np.float32))


def _pca_dataset(d, n_frames):
    ds = object.__new__(tmv.MvRgbDatasetBase)
    ds.data_dir, ds.pose_list = d, list(range(n_frames))
    return ds


@pytest.mark.parametrize("n_frames,h,n_comp", [(6, 6, 2), (12, 8, 5),
                                               (30, 5, 20)])
def test_pca_matches_sklearn_full(tmp_path, n_frames, h, n_comp):
    """transform_pca against sklearn's full SVD solver on the same rows
    (fitted in float64, so the comparison reads the port's float64 fit):
    a training frame, a novel row and a far row that the clamp cuts."""
    d = str(tmp_path)
    _write_pose_maps(d, n_frames, h, seed=n_frames)
    ds = _pca_dataset(d, n_frames)
    ds.compute_pca(n_components=n_comp)
    mask = ds.pos_map_mask
    assert mask.shape == (h, h) and not mask[:2].any() and mask[2:].all()
    x = np.stack([exr.read_exr(os.path.join(
        d, "smpl_pos_map", "%08d.exr" % i))[:, :h][mask].reshape(-1)
        for i in range(n_frames)]).astype(np.float64)
    rng = np.random.default_rng(0)
    rows = np.stack([x[1], x.mean(0) + 0.1 * rng.standard_normal(
        x.shape[1]), x[0] + 10 * (x[2] - x[0])])
    for sigma in (2.0, 0.5):
        want = _sklearn_transform(x, n_comp, sigma, rows)
        for r, w in zip(rows, want):
            got = ds.transform_pca(r.reshape(-1, 3).astype(np.float32),
                                   sigma_pca=sigma)
            assert got.dtype == np.float32 and got.shape == (len(r) // 3, 3)
            np.testing.assert_allclose(got.reshape(-1), w, rtol=0,
                                       atol=PCA_RTOL * np.abs(w).max())


def test_pca_matches_jax_compute_pca(tmp_path):
    """At a shape where sklearn's "auto" solver picks the full SVD
    (n_components >= 0.8 poses), JAX's compute_pca / transform_pca; then
    the port's cache round trip: pca_<n>.npz is written (never the JAX
    .ckpt name), a second dataset loads it with the same mask and the same
    output bit for bit, on arrays and on tensors."""
    d = str(tmp_path)
    n_frames, h, n_comp = 5, 6, 4
    _write_pose_maps(d, n_frames, h, seed=9)
    want = object.__new__(jmv.MvRgbDatasetBase)
    want.data_dir, want.pose_list = d, list(range(n_frames))
    want.compute_pca(n_components=n_comp)
    assert want.pca._fit_svd_solver == "full"
    os.remove(os.path.join(d, "smpl_pos_map", "pca_%d.ckpt" % n_comp))
    got = _pca_dataset(d, n_frames)
    got.compute_pca(n_components=n_comp)
    np.testing.assert_array_equal(got.pos_map_mask, want.pos_map_mask)
    assert sorted(f for f in os.listdir(os.path.join(d, "smpl_pos_map"))
                  if f.startswith("pca")) == ["pca_4.npz"]
    again = _pca_dataset(d, n_frames)
    again.compute_pca(n_components=n_comp)
    np.testing.assert_array_equal(again.pos_map_mask, got.pos_map_mask)
    rng = np.random.default_rng(1)
    m = exr.read_exr(os.path.join(d, "smpl_pos_map", "00000003.exr"))
    front = m[:, :h][got.pos_map_mask]
    for row in (front, front + 0.3 * rng.standard_normal(front.shape).astype(
            np.float32)):
        w = want.transform_pca(row, sigma_pca=2.0)
        g = got.transform_pca(row, sigma_pca=2.0)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=PCA_RTOL * np.abs(w).max())
        np.testing.assert_array_equal(again.transform_pca(row, 2.0), g)
        t = got.transform_pca(torch.as_tensor(row), 2.0)
        assert torch.is_tensor(t) and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), g)


@pytest.mark.parametrize("cols", [1, 7])
def test_pca_column_blocks_match_one_block(tmp_path, cols):
    """The fit over blocks of ``cols`` columns (a ragged last block with 7)
    gives the one-block fit: the same mean bit for bit, and transform_pca
    within 1e-10 of its largest entry (the Gram matrix sums the blocks in
    another order)."""
    d = str(tmp_path)
    n_frames, h, n_comp = 9, 5, 3
    _write_pose_maps(d, n_frames, h, seed=3)
    front = _pca_dataset(d, n_frames)._front_pose_map
    fits = [tmv._fit_pca(front, list(range(n_frames)), n_comp,
                         torch.device("cpu"), block_bytes=b)
            for b in (8 * n_frames * cols, 2 ** 28)]
    np.testing.assert_array_equal(fits[0]["mean"], fits[1]["mean"])
    np.testing.assert_array_equal(fits[0]["mask"], fits[1]["mask"])
    row = front(4)[fits[0]["mask"]] + 0.5
    outs = []
    for f in fits:
        ds = _pca_dataset(d, n_frames)
        ds.pca = {k: v for k, v in f.items() if k != "mask"}
        ds._pca_on = {}
        outs.append(ds.transform_pca(row.astype(np.float64), 2.0))
    np.testing.assert_allclose(outs[0], outs[1], rtol=0,
                               atol=1e-10 * np.abs(outs[1]).max())


def test_pca_fit_bench_runs_on_the_cpu():
    """tools/pca_fit_bench.py at a tiny size on the CPU: X's shape, a fit
    with finite, descending variances."""
    from animatablegaussians_torch.tools import pca_fit_bench
    res = pca_fit_bench.main(["--poses", "6", "--texels", "40", "--map",
                              "8", "--components", "3"], device="cpu")
    assert res["ok"] and res["values"] == 120 and res["poses"] == 6
    assert res["peak_gib"] is None


def test_pose_dataset_module_has_the_hand_constants():
    from animatablegaussians_tpu.data import pose_dataset as jpd
    np.testing.assert_array_equal(tpd.NORMAL_LEFT_HAND_POSE,
                                  jpd.NORMAL_LEFT_HAND_POSE)
    np.testing.assert_array_equal(tpd.NORMAL_RIGHT_HAND_POSE,
                                  jpd.NORMAL_RIGHT_HAND_POSE)
