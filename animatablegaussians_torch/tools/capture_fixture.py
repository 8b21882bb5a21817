"""A synthetic multi-view capture on disk, in the AvatarReX layout that
``data.MvRgbDatasetAvatarReX`` reads, for driving the training entry point
(``main_avatar_torch.py``) without a real capture:

  * ``calibration_full.json``: R = I, T = (0.05 i, 0, 2), fx = fy =
    1.25 img_w, the principal point at the image centre;
  * per camera, ``%08d.jpg`` frames of uniform noise and
    ``mask/pha/%08d.jpg`` mattes (a box), written by ``data.image_io``'s
    codec;
  * ``smpl_params.npz``: 0.05 N(0, 1) global orients, translations and
    body poses, zero hands, jaw and expression;
  * an SMPL-X npz with random model tensors (``write_smplx``);
  * ``smpl_pos_map/``: the canonical position and normal EXRs and
    ``init_pts_lbs.npy`` from ``utils.synthetic.make_cano_map``, and one
    pose-map EXR per frame (the same map each frame, or with
    ``pose_map_jitter`` each frame's masked texels moved by that times
    N(0, 1), so that the frames span a PCA basis).

``write_body_model`` writes an archive of one of the other body-model
families (SMPL, SMPL+H, MANO, FLAME) in its real shapes (``FAMILIES``)
with random tensors, for ``models/smplx``'s ``from_npz``.

For the animation entry point (``-m test``) it also writes a driving-pose
archive (``write_pose_sequence``: THuman4-style or AMASS-style ``.npz``)
and the MANO index maps (``write_mano``: a numpy copy of
``tests/test_datasets.py::write_synthetic_mano`` with the SMPL-X vertex
count as a parameter).

A numpy copy of ``tests/test_driver.py::full_capture`` and
``tests/test_datasets.py::write_synthetic_smplx``, parametrised by size:
the defaults are those tests' sizes (96x96 images, map_h 64, 120 SMPL-X
vertices); ``FULL`` is the full-width workload of ``tools/render_fixture``
(1500x2048 images, map_h 1024, i.e. 531,520 Gaussians) with SMPL-X's real
shapes (10,475 vertices, 55 joints, 400 shape and expression directions).
"""

from __future__ import annotations

import json
import os

import numpy as np

from animatablegaussians_torch.data import image_io
from animatablegaussians_torch.utils import exr, synthetic

N_JOINTS = 55
FULL = dict(img_w=1500, img_h=2048, map_h=1024, n_verts=10475,
            n_faces=20908)


def write_smplx(path: str, n_verts: int = 120, n_faces: int = 50,
                seed: int = 0, body_scale: float = 1.0) -> None:
    """An SMPL-X npz with random tensors of the archive's layout: 55
    joints on a shallow random tree, 400 shape and expression directions,
    posedirs (V, 3, 486), normalized regressor and skinning weights; the
    template's vertices are ``body_scale`` N(0, 1) metres."""
    J, V = N_JOINTS, n_verts
    rng = np.random.default_rng(seed)
    parents = np.zeros(J, np.int64)
    parents[1:] = rng.integers(0, 3, J - 1)
    for j in range(1, J):
        parents[j] = min(parents[j], j - 1)
    np.savez(
        path,
        v_template=body_scale * rng.standard_normal((V, 3)).astype(
            np.float32),
        shapedirs=0.03 * rng.standard_normal((V, 3, 400)).astype(np.float32),
        posedirs=0.01 * rng.standard_normal(
            (V, 3, (J - 1) * 9)).astype(np.float32),
        J_regressor=(lambda w: w / w.sum(1, keepdims=True))(
            rng.random((J, V)).astype(np.float32)),
        weights=(lambda w: w / w.sum(1, keepdims=True))(
            rng.random((V, J)).astype(np.float32)),
        hands_componentsl=rng.standard_normal((6, 45)).astype(np.float32),
        hands_componentsr=rng.standard_normal((6, 45)).astype(np.float32),
        hands_meanl=np.zeros(45, np.float32),
        hands_meanr=np.zeros(45, np.float32),
        kintree_table=np.stack([parents, np.arange(J)]),
        f=rng.integers(0, V, (n_faces, 3)).astype(np.int64),
    )


# the real archives' shapes: vertices, LBS joints, faces, shape directions
# (FLAME's 300 shape then 100 expression), hand PCA components (SMPL+H's
# per hand, MANO's) and face landmarks (static, contour rows x columns)
FAMILIES = {
    "smpl": dict(n_verts=6890, n_joints=24, n_faces=13776, n_shape=10),
    "smplh": dict(n_verts=6890, n_joints=52, n_faces=13776, n_shape=16,
                  n_hand=45),
    "mano": dict(n_verts=778, n_joints=16, n_faces=1538, n_shape=10,
                 n_hand=45),
    "flame": dict(n_verts=5023, n_joints=5, n_faces=9976, n_shape=400,
                  landmarks=(51, 79, 17)),
}


def write_body_model(path: str, family: str, n_verts: int = None,
                     n_faces: int = None, seed: int = 0) -> str:
    """An archive of ``family`` (a ``FAMILIES`` key) with random tensors of
    the real archive's layout: its joints on a shallow random tree, shape
    directions, posedirs (V, 3, (J-1) 9), normalized regressor and skinning
    weights, the hand PCA basis and a non-zero hand mean, FLAME's landmark
    embedding (barycentric coordinates that sum to 1). ``n_verts`` and
    ``n_faces`` override the real counts. Returns ``path``."""
    spec = FAMILIES[family]
    V = n_verts or spec["n_verts"]
    n_f = n_faces or spec["n_faces"]
    J = spec["n_joints"]
    rng = np.random.default_rng(seed)
    parents = np.zeros(J, np.int64)
    parents[1:] = rng.integers(0, 3, J - 1)
    for j in range(1, J):
        parents[j] = min(parents[j], j - 1)
    norm = lambda w: w / w.sum(-1, keepdims=True)  # noqa: E731
    arrays = dict(
        v_template=rng.standard_normal((V, 3)).astype(np.float32),
        shapedirs=0.03 * rng.standard_normal(
            (V, 3, spec["n_shape"])).astype(np.float32),
        posedirs=0.01 * rng.standard_normal(
            (V, 3, (J - 1) * 9)).astype(np.float32),
        J_regressor=norm(rng.random((J, V)).astype(np.float32)),
        weights=norm(rng.random((V, J)).astype(np.float32)),
        kintree_table=np.stack([parents, np.arange(J)]),
        f=rng.integers(0, V, (n_f, 3)).astype(np.int64))
    n_hand = spec.get("n_hand")
    if family == "smplh":
        for side in "lr":
            arrays[f"hands_components{side}"] = rng.standard_normal(
                (n_hand, 45)).astype(np.float32)
            arrays[f"hands_mean{side}"] = 0.1 * rng.standard_normal(
                45).astype(np.float32)
    elif family == "mano":
        arrays["hands_components"] = rng.standard_normal(
            (n_hand, 45)).astype(np.float32)
        arrays["hands_mean"] = 0.1 * rng.standard_normal(45).astype(
            np.float32)
    if "landmarks" in spec:
        n_lmk, rows, cols = spec["landmarks"]
        arrays.update(
            lmk_faces_idx=rng.integers(0, n_f, n_lmk).astype(np.int32),
            lmk_bary_coords=norm(rng.random((n_lmk, 3)).astype(np.float32)),
            dynamic_lmk_faces_idx=rng.integers(0, n_f, (rows, cols)).astype(
                np.int32),
            dynamic_lmk_bary_coords=norm(rng.random(
                (rows, cols, 3)).astype(np.float32)))
    np.savez(path, **arrays)
    return path


def write_pose_sequence(path: str, n_frames: int, style: str = "thuman4",
                        seed: int = 0, scale: float = 0.05) -> str:
    """A driving-pose archive of ``n_frames`` frames whose poses and
    translations are ``scale`` N(0, 1): THuman4-style (global_orient,
    transl, body_pose (63) and both hands' poses (45)) or AMASS-style
    (``poses`` (52 x 3) and ``trans``). ``PoseDataset`` tells them apart
    by the path: a THuman4 path names ``thuman4``, an AMASS path none of
    thuman4, actorshq and avatarrex. Returns ``path``."""
    rng = np.random.default_rng(seed)

    def draw(dim):
        return scale * rng.standard_normal((n_frames, dim)).astype(np.float32)

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if style == "thuman4":
        np.savez(path, global_orient=draw(3), transl=draw(3),
                 body_pose=draw(63), left_hand_pose=draw(45),
                 right_hand_pose=draw(45))
    elif style == "amass":
        np.savez(path, poses=draw(52 * 3), trans=draw(3))
    else:
        raise ValueError(f"unknown pose archive style {style!r}")
    return path


def write_mano(mano_dir: str, n_verts_total: int = 120, n_hand: int = 12,
               seed: int = 3, cano_verts=None) -> str:
    """SMPL-X-hand -> MANO vertex index maps and closed-fan faces in the
    reference layout (ref: dataset/commons.py:8-19): ``n_hand`` random
    vertices of ``n_verts_total`` per hand and 20 random faces. With
    ``cano_verts`` (the canonical SMPL-X vertices, (V, 3)) each hand takes
    instead the ``n_hand`` vertices nearest the body's extreme in x, the
    left hand +x and the right -x, where a real hand sits: the template's
    hand blend then weighs the body's colour 0 away from the hands, as it
    does on a real subject (with random vertices the hands' boxes span the
    body). Returns ``mano_dir``."""
    os.makedirs(mano_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    if cano_verts is None:
        lid = rng.choice(n_verts_total, n_hand, replace=False)
        rid = rng.choice(n_verts_total, n_hand, replace=False)
    else:
        v = np.asarray(cano_verts)
        lid, rid = (np.argsort(np.linalg.norm(v - v[i], axis=1))[:n_hand]
                    for i in (np.argmax(v[:, 0]), np.argmin(v[:, 0])))
    np.savez(os.path.join(mano_dir, "smplx_lhand_to_mano_rhand.npz"),
             smpl_vert_id_to_mano=lid.astype(np.int64))
    np.savez(os.path.join(mano_dir, "smplx_rhand_to_mano_rhand.npz"),
             smpl_vert_id_to_mano=rid.astype(np.int64))
    faces = rng.integers(0, n_hand, (20, 3)).astype(np.int64)
    np.savetxt(os.path.join(mano_dir, "mano_face_close.txt"), faces,
               fmt="%d")
    return mano_dir


def write_capture(data_dir: str, n_frames: int = 4,
                  cams=("cam00", "cam01"), img_w: int = 96, img_h: int = 96,
                  map_h: int = 64, n_verts: int = 120, n_faces: int = 50,
                  seed: int = 0, pose_map_jitter: float = 0.0,
                  body_scale: float = 1.0) -> str:
    """Write the capture under ``data_dir``; returns the SMPL-X npz's
    path. ``body_scale`` scales the SMPL-X template (``write_smplx``): at
    1.0 the body's box reaches behind the cameras 2 m away, at 0.3 it
    stays in front of them, as a real subject does (the nerf-mode ray
    draw's projected-box mask then takes ~1 ms instead of ~7 s in cv2)."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    f = 1.25 * img_w
    calib = {cn: dict(R=np.eye(3).reshape(-1).tolist(),
                      T=[0.05 * i, 0.0, 2.0],
                      K=[f, 0, img_w / 2, 0, f, img_h / 2, 0, 0, 1],
                      imgSize=[img_w, img_h])
             for i, cn in enumerate(cams)}
    with open(os.path.join(data_dir, "calibration_full.json"), "w") as fp:
        json.dump(calib, fp)

    mask = np.zeros((img_h, img_w), np.uint8)
    mask[img_h * 20 // 96:img_h * 80 // 96,
         img_w * 30 // 96:img_w * 70 // 96] = 255
    for cn in cams:
        os.makedirs(os.path.join(data_dir, cn, "mask", "pha"),
                    exist_ok=True)
        for fr in range(n_frames):
            img = (rng.random((img_h, img_w, 3)) * 255).astype(np.uint8)
            image_io.write_jpeg(os.path.join(data_dir, cn, "%08d.jpg" % fr),
                                img)
            image_io.write_jpeg(os.path.join(data_dir, cn, "mask", "pha",
                                             "%08d.jpg" % fr), mask)

    def pose(dim):
        return 0.05 * rng.standard_normal((n_frames, dim)).astype(np.float32)

    np.savez(os.path.join(data_dir, "smpl_params.npz"),
             betas=np.zeros((1, 10), np.float32),
             global_orient=pose(3), transl=pose(3), body_pose=pose(63),
             jaw_pose=np.zeros((n_frames, 3), np.float32),
             expression=np.zeros((n_frames, 10), np.float32),
             left_hand_pose=np.zeros((n_frames, 45), np.float32),
             right_hand_pose=np.zeros((n_frames, 45), np.float32))
    smpl_path = os.path.join(data_dir, "SMPLX_SYNTH.npz")
    write_smplx(smpl_path, n_verts=n_verts, n_faces=n_faces,
                body_scale=body_scale)

    pm_dir = os.path.join(data_dir, "smpl_pos_map")
    os.makedirs(pm_dir, exist_ok=True)
    pos, nml, lbs = synthetic.make_cano_map(map_h=map_h)
    exr.write_exr(os.path.join(pm_dir, "cano_smpl_pos_map.exr"), pos)
    exr.write_exr(os.path.join(pm_dir, "cano_smpl_nml_map.exr"), nml)
    np.save(os.path.join(pm_dir, "init_pts_lbs.npy"), lbs)
    half_pose = synthetic.pose_map_from_cano(pos)        # (S/2, S/2, 6)
    flat = np.concatenate([half_pose[..., :3], half_pose[..., 3:]], axis=1)
    texels = np.linalg.norm(flat, axis=-1, keepdims=True) > 1e-6
    for fr in range(n_frames):
        m = flat
        if pose_map_jitter:
            m = flat + texels * (pose_map_jitter * rng.standard_normal(
                flat.shape)).astype(np.float32)
        exr.write_exr(os.path.join(pm_dir, "%08d.exr" % fr), m)
    return smpl_path
