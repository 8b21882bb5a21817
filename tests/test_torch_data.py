"""The port's data path against the JAX package on the CPU: axis_angle_to_mat,
LBS and the SMPL-X forward, the EXR codec, JPEG I/O and the boundary mask,
the multi-view dataset's items (training, eval and skip_images routes) on
one on-disk capture, and the loader's batch order.

Tolerances: the image-derived item keys and the EXR pose maps are exact
(both packages read the same files with the same decoder); the SMPL-X
outputs and the keys derived from them agree to 1e-5 relative (float32 on
both sides, einsums summed in another order), with an absolute floor of
1e-6 for entries near 0."""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatablegaussians_tpu.data import MvRgbDatasetAvatarReX as JDataset
from animatablegaussians_tpu.data import mv_rgb_dataset as jmv
from animatablegaussians_tpu.data.loader import PrefetchLoader as JLoader
from animatablegaussians_tpu.models.smplx import SMPLX as JSMPLX
from animatablegaussians_tpu.models.smplx import lbs as jlbs
from animatablegaussians_tpu.ops import quat as jquat
from animatablegaussians_tpu.utils import exr as jexr
from animatablegaussians_torch.data import image_io
from animatablegaussians_torch.data import mv_rgb_dataset as tmv
from animatablegaussians_torch.data.loader import PrefetchLoader
from animatablegaussians_torch.models.smplx import SMPLX, lbs
from animatablegaussians_torch.ops import quat as tquat
from animatablegaussians_torch.tools import capture_fixture as cf
from animatablegaussians_torch.utils import exr
from test_datasets import write_synthetic_mano, write_synthetic_smplx
from test_smplx import make_synthetic_model

RTOL, ATOL = 1e-5, 1e-6
IMAGE_KEYS = ("color_img", "mask_img", "boundary_mask_img", "smpl_pos_map")


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=err_msg)


def test_axis_angle_to_mat_matches_jax():
    """Random axes at angles from 0 (exactly) through 1e-9 and 1e-4 to
    pi, batched over two leading axes."""
    rng = np.random.default_rng(0)
    axes = rng.standard_normal((7, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.array([0.0, 1e-9, 1e-6, 1e-4, 0.3, 2.0, np.pi])
    aa = np.stack([axes * a for a in angles]).astype(np.float32)  # (7, 7, 3)
    got = tquat.axis_angle_to_mat(torch.as_tensor(aa)).numpy()
    want = np.asarray(jquat.axis_angle_to_mat(jnp.asarray(aa)))
    assert got.shape == (7, 7, 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[0], np.broadcast_to(np.eye(3),
                                                          (7, 3, 3)))


def test_lbs_matches_jax():
    """lbs on tests/test_smplx.py's synthetic model (6 joints)."""
    data = make_synthetic_model()
    rng = np.random.default_rng(1)
    betas = (0.5 * rng.standard_normal((3, 4))).astype(np.float32)
    pose = (0.3 * rng.standard_normal((3, 18))).astype(np.float32)
    want = jlbs(jnp.asarray(betas), jnp.asarray(pose), data.v_template,
                data.shapedirs, data.posedirs, data.J_regressor,
                data.parents, data.lbs_weights)
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    got = lbs(t(betas), t(pose), t(data.v_template), t(data.shapedirs),
              t(data.posedirs), t(data.J_regressor), data.parents,
              t(data.lbs_weights))
    for name, g, w in zip(("verts", "joints", "A"), got, want):
        _close(g.numpy(), w, name)


def _write_landmark_smplx(path):
    """write_synthetic_smplx's layout with more vertices than the largest
    SMPL-X landmark vertex id (9929), so the extra joints append, and the
    face landmark embedding; 20 shape directions keep it small (without
    the 300 + 100 layout the expression directions are zeros)."""
    cf.write_smplx(path, n_verts=9930, n_faces=200, seed=4)
    raw = dict(np.load(path))
    raw["shapedirs"] = raw["shapedirs"][..., :20]
    rng = np.random.default_rng(5)
    bary = rng.random((51, 3)).astype(np.float32)
    dyn_bary = rng.random((79, 17, 3)).astype(np.float32)
    np.savez(path, **raw,
             lmk_faces_idx=rng.integers(0, 200, 51).astype(np.int32),
             lmk_bary_coords=bary / bary.sum(-1, keepdims=True),
             dynamic_lmk_faces_idx=rng.integers(0, 200, (79, 17)).astype(
                 np.int32),
             dynamic_lmk_bary_coords=dyn_bary / dyn_bary.sum(
                 -1, keepdims=True))


@pytest.mark.parametrize("case", ["pca", "full_hands_flat", "landmarks"])
def test_smplx_forward_matches_jax(tmp_path, case):
    """SMPLX.from_npz and its forward against the JAX package's on one
    npz: vertices, joints (with the extra and landmark joints in the
    landmarks case, the dynamic face contour on) and the per-joint A."""
    path = str(tmp_path / "smplx.npz")
    kw = {}
    if case == "landmarks":
        _write_landmark_smplx(path)
        kw = dict(use_pca=False, use_face_contour=True)
    else:
        write_synthetic_smplx(path)
        kw = (dict(use_pca=True) if case == "pca"
              else dict(use_pca=False, flat_hand_mean=True))
    jm = JSMPLX.from_npz(path, **kw)
    tm = SMPLX.from_npz(path, device="cpu", **kw)
    rng = np.random.default_rng(2)
    B, hand = 3, (6 if case == "pca" else 45)
    args = dict(
        betas=rng.standard_normal((B, 10)),
        global_orient=0.5 * rng.standard_normal((B, 3)),
        body_pose=0.3 * rng.standard_normal((B, 63)),
        left_hand_pose=0.3 * rng.standard_normal((B, hand)),
        right_hand_pose=0.3 * rng.standard_normal((B, hand)),
        transl=rng.standard_normal((B, 3)),
        expression=rng.standard_normal((B, 10)),
        jaw_pose=0.2 * rng.standard_normal((B, 3)))
    args = {k: v.astype(np.float32) for k, v in args.items()}
    want = jm(**{k: jnp.asarray(v) for k, v in args.items()})
    with torch.no_grad():
        got = tm(**{k: torch.as_tensor(v) for k, v in args.items()})
    n_joints = {"landmarks": 55 + 21 + 51 + 17}.get(case, 55)
    assert got["joints"].shape == (B, n_joints, 3)
    for k in ("vertices", "joints", "A", "v_shaped", "full_pose"):
        _close(got[k].numpy(), want[k], k)


def test_capture_smplx_equals_test_writer(tmp_path):
    """tools/capture_fixture.write_smplx at its default size writes
    tests/test_datasets.write_synthetic_smplx's arrays."""
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    cf.write_smplx(a)
    write_synthetic_smplx(b)
    ra, rb = np.load(a), np.load(b)
    assert sorted(ra.files) == sorted(rb.files)
    for k in ra.files:
        np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)


def test_exr_copy_matches_jax(tmp_path):
    """The port's EXR codec reads the JAX codec's files and writes files
    the JAX codec reads, bit for bit (float and half, ZIP)."""
    rng = np.random.default_rng(3)
    img = rng.standard_normal((37, 20, 3)).astype(np.float32)
    for half in (False, True):
        a, b = str(tmp_path / f"a{half}.exr"), str(tmp_path / f"b{half}.exr")
        jexr.write_exr(a, img, half=half)
        exr.write_exr(b, img, half=half)
        assert open(a, "rb").read() == open(b, "rb").read()
        np.testing.assert_array_equal(exr.read_exr(a), jexr.read_exr(a))


def test_jpeg_io(tmp_path):
    """The chosen codec is named; its writes read back with the shapes of
    cv2's IMREAD_UNCHANGED (a one-channel file stays 2-D), close to the
    image written (quality 95), and decode exactly as the JAX package's
    reader decodes them."""
    assert image_io.CODEC in ("libjpeg", "cv2")
    yy, xx = np.mgrid[0:48, 0:64]
    color = np.stack([xx * 3, yy * 4, (xx + yy) * 2], -1).astype(np.uint8)
    gray = np.zeros((48, 64), np.uint8)
    gray[10:30, 20:50] = 255
    for name, img in (("c.jpg", color), ("g.jpg", gray)):
        path = str(tmp_path / name)
        image_io.write_jpeg(path, img)
        got = image_io.imread(path)
        assert got.shape == img.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - img).mean() < 3
        np.testing.assert_array_equal(got, jmv._imread(path))
    with pytest.raises(FileNotFoundError):
        image_io.imread(str(tmp_path / "missing.jpg"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_boundary_mask_matches_cv2(seed):
    """The max-pool erode / dilate against the JAX package's cv2 branch,
    on mattes with soft edges and regions touching the image border (where
    the scipy fallback of the JAX package would erode)."""
    cv = pytest.importorskip("cv2")
    assert jmv.cv is cv
    rng = np.random.default_rng(seed)
    mask = np.zeros((40, 52), np.uint8)
    for _ in range(4):
        y, x = rng.integers(0, 40), rng.integers(0, 52)
        mask[max(y - 8, 0):y + 8, max(x - 10, 0):x + 10] = 255
    mask[0:6, :] = 255                                   # the top border
    soft = rng.random(mask.shape) < 0.05
    mask[soft] = rng.integers(0, 256, int(soft.sum()))
    got_b, got_m = image_io.boundary_mask(mask)
    want_b, want_m = jmv.MvRgbDatasetBase.get_boundary_mask(mask)
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_array_equal(got_b, want_b)
    assert not got_b[0, 10:40].all()      # no erosion at the image border


# ---------------------------------------------------------------------------
# the dataset and the loader on one capture
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("capture"))
    smpl = cf.write_capture(d)
    mano = write_synthetic_mano(os.path.join(d, "mano"))
    kw = dict(frame_range=[0, 3], used_cam_ids=[0, 1],
              load_smpl_pos_map=True, smpl_model_path=smpl, mano_dir=mano)
    return (JDataset(d, **kw), tmv.MvRgbDatasetAvatarReX(d, **kw))


def _compare_items(got, want):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, (int, tuple)):
            assert g == w, k
        elif k in IMAGE_KEYS:
            assert np.asarray(g).dtype == np.asarray(w).dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert np.shape(g) == np.shape(w), k
            _close(g, w, k)


@pytest.mark.parametrize("route", ["training", "eval", "skip_images"])
def test_dataset_items_match_jax(capture, route):
    jds, tds = capture
    assert len(tds) == len(jds) == 6
    kw = {"training": {}, "eval": dict(pose_idx=2, view_idx=1, eval=True),
          "skip_images": dict(skip_images=True)}[route]
    for i in (0, 3, 5):
        got = tds.getitem(i, training=True, **kw)
        want = jds.getitem(i, training=True, **kw)
        _compare_items(got, want)
        assert ("color_img" in got) == (route != "skip_images")
    for k in ("cano_smpl_center", "cano_bounds", "inv_cano_jnt_mats"):
        _close(getattr(tds, k), getattr(jds, k), k)
    for g, w in zip(tds._cano_mano, jds._cano_mano):
        _close(g, w, "cano mano")


def test_dataset_unported_routes_raise(capture, tmp_path):
    """A dataset mode other than 3dgs and nerf is refused (the nerf mode
    is ported and held in tests/test_torch_template_tools.py), and
    PoseDataset.getitem, refused until its NeRF item was ported, returns
    rays inside the image that hit the live bounds (held against JAX in
    tests/test_torch_animate_data.py and
    tests/test_torch_template_leftovers.py)."""
    from animatablegaussians_torch.data import PoseDataset
    _, tds = capture
    with pytest.raises(ValueError, match="mode"):
        tmv.MvRgbDatasetAvatarReX(tds.data_dir, mode="sdf")
    path = cf.write_pose_sequence(str(tmp_path / "thuman4_pose_00.npz"), 2)
    poses = PoseDataset(path, smpl_model_path=os.path.join(
        tds.data_dir, "SMPLX_SYNTH.npz"))
    item = poses.getitem(0)
    n = item["uv"].shape[0]
    assert 0 < n <= item["img_w"] * item["img_h"]
    assert item["ray_o"].shape == item["ray_d"].shape == (n, 3)
    assert item["near"].shape == item["far"].shape == (n,)
    assert (item["near"] < item["far"]).all()


def test_actorshq_cameras_match_jax(tmp_path):
    """ActorsHQ's Rodrigues extrinsics through axis_angle_to_mat against the
    JAX dataset's cv2.Rodrigues."""
    pytest.importorskip("cv2")
    os.makedirs(tmp_path / "4x")
    rng = np.random.default_rng(6)
    fields = ["name", "w", "h", "rx", "ry", "rz", "tx", "ty", "tz", "fx",
              "fy", "px", "py"]
    with open(tmp_path / "4x" / "calibration.csv", "w", newline="") as fp:
        w = csv.writer(fp)
        w.writerow(fields)
        for i in range(3):
            r = rng.standard_normal(3) * (1e-9 if i == 0 else 1.0)
            w.writerow([f"Cam{i:03d}", 1022, 1198, *r,
                        *rng.standard_normal(3), 1.1, 0.9, 0.5, 0.48])
    got = object.__new__(tmv.MvRgbDatasetActorsHQ)
    want = object.__new__(jmv.MvRgbDatasetActorsHQ)
    got.data_dir = want.data_dir = str(tmp_path)
    got.load_cam_data()
    want.load_cam_data()
    assert got.cam_names == want.cam_names
    for g, w in zip(got.extr_mats, want.extr_mats):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-6)
    for g, w in zip(got.intr_mats, want.intr_mats):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("batch_size,drop_last", [(1, True), (4, True),
                                                  (4, False)])
def test_loader_order_matches_jax(capture, batch_size, drop_last):
    """The batches' item indices over three epochs equal the JAX loader's,
    and a loaded batch holds the dataset's items stacked."""
    jds, tds = capture
    jl = JLoader(jds, batch_size=batch_size, drop_last=drop_last, seed=3)
    tl = PrefetchLoader(tds, batch_size=batch_size, drop_last=drop_last,
                        seed=3, device="cpu", num_threads=2)
    assert len(tl) == len(jl)
    for epoch in (1, 2, 3):
        jl._epoch = epoch
        want = [b.tolist() for b in jl._index_batches()]
        assert [b.tolist() for b in tl.index_batches(epoch)] == want
    keys = ("color_img", "cano2live_jnt_mats", "item_idx")
    tl.select_keys = keys
    batches = list(tl)
    assert len(batches) == len(tl) and len(tl.waits) == len(tl)
    first = tl.index_batches(1)[0]
    for j, i in enumerate(first):
        item = tds[int(i)]
        for k in keys:
            np.testing.assert_array_equal(batches[0][k][j].numpy(), item[k])
