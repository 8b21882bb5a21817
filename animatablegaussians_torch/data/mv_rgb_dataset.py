"""Multi-view RGB video datasets (AvatarReX / THuman4 / ActorsHQ formats).

Port of ``animatablegaussians_tpu/data/mv_rgb_dataset.py`` (ref:
dataset/dataset_mv_rgb.py:15-500): the same item contract, on-disk formats
and conventions. SMPL-X runs once at init, one batched forward of every pose
(live, canonical and without the root) on ``precompute_device``, and its
results are cached as numpy; ``getitem`` is then array indexing and image
reads. Images stay BGR; masks binarize at 128 with a 5x5 boundary band;
position maps are front|back side-by-side EXRs reshaped to (H, W, 6).

Routes, in the ``3dgs`` mode: training items, ``eval=True`` items (a fixed
pose and view), ``skip_images=True`` items (pose maps and cameras only, for
the pretrain phase) and, with ``training=False``, testing items over the
pose list (a caller's camera or the 512^2 default front camera, with the
canonical and live MANO items). In the ``nerf`` mode (the template stack)
a training item carries ``nerf_random``, ``sample_rays_for_training``'s
1024 random rays of the view, drawn from the dataset's own
``numpy.random.Generator`` seeded with ``ray_seed`` (the JAX dataset draws
from an unseeded one), the camera and the MANO items.

The PCA pose projection of the animation path (``compute_pca`` /
``transform_pca``, ref: dataset_mv_rgb.py:287-321) is the exact PCA in
float64, with sklearn's conventions (``mean_`` centring, explained variance
S^2 / (n - 1)) but without sklearn: the eigendecomposition of the
(poses x poses) Gram matrix of the centred front pose maps. It is cached at
``smpl_pos_map/pca_%d.npz``.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from animatablegaussians_torch import config as agt_config
from animatablegaussians_torch.data import commons, image_io
from animatablegaussians_torch.ops.quat import axis_angle_to_mat
from animatablegaussians_torch.utils import visualize as viz

class MvRgbDatasetBase:
    """Items are (pose_idx, view_idx) pairs over frame_range x used_cam_ids
    (ref: dataset_mv_rgb.py:62-74)."""

    def __init__(self, data_dir: str, frame_range=None,
                 used_cam_ids: Optional[Sequence[int]] = None,
                 training: bool = True, subject_name: Optional[str] = None,
                 load_smpl_pos_map: bool = False,
                 load_smpl_nml_map: bool = False, mode: str = "3dgs",
                 smpl_model_path: Optional[str] = None,
                 precompute_device: str = "cpu",
                 mano_dir: Optional[str] = None, ray_seed: int = 0):
        if mode not in ("3dgs", "nerf"):
            raise ValueError(f"Invalid dataset mode {mode!r}")
        self.data_dir = data_dir
        self.training = training
        self.subject_name = subject_name or os.path.basename(data_dir)
        self.load_smpl_pos_map = load_smpl_pos_map
        self.load_smpl_nml_map = load_smpl_nml_map
        self.mode = mode
        self.ray_rng = np.random.default_rng(ray_seed)

        self.load_cam_data()
        self.load_smpl_data()

        # pose list (ref: dataset_mv_rgb.py:44-61)
        n_frames = self.smpl_data["body_pose"].shape[0]
        if frame_range is None:
            self.pose_list = list(range(n_frames))
        elif isinstance(frame_range, (list, tuple)):
            self.pose_list = list(range(*frame_range))
        elif isinstance(frame_range, str):
            self.pose_list = np.loadtxt(
                os.path.join(data_dir, frame_range)).astype(int).tolist()
        else:
            raise TypeError("Invalid frame_range")

        if training:
            self.used_cam_ids = (list(range(self.view_num))
                                 if used_cam_ids is None
                                 else list(used_cam_ids))
            self.data_list = [(p, v) for p in self.pose_list
                              for v in self.used_cam_ids]
            self.filter_missing_files()

        t0 = time.perf_counter()
        self._precompute_smpl(smpl_model_path, precompute_device)
        self.smplx_s = time.perf_counter() - t0       # read by chip_smoke.py

        # canonical MANO hand crops, when the index maps exist
        # (ref: dataset_mv_rgb.py:94)
        self.mano = commons.try_load_mano(mano_dir)
        if self.mano is not None:
            self._cano_mano = commons.generate_two_manos(
                self.mano, self.cano_smpl["vertices"])

    def _attach_mano(self, item: dict, live_verts: np.ndarray):
        """Canonical and live MANO items, on nerf and testing items
        (ref: dataset_mv_rgb.py:231-236)."""
        if self.mano is None:
            return
        lv, ln, rv, rn = self._cano_mano
        item.update(left_cano_mano_v=lv, left_cano_mano_n=ln,
                    right_cano_mano_v=rv, right_cano_mano_n=rn,
                    mano_face_closed=self.mano.mano_face_closed)
        lv, ln, rv, rn = commons.generate_two_manos(self.mano, live_verts)
        item.update(left_live_mano_v=lv, left_live_mano_n=ln,
                    right_live_mano_v=rv, right_live_mano_n=rn)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _precompute_smpl(self, smpl_model_path, device: str):
        """One batched SMPL-X forward for all frames; caches numpy results."""
        from animatablegaussians_torch.models.smplx import SMPLX

        path = smpl_model_path or os.path.join(
            agt_config.PROJ_DIR, "smpl_files", "smplx", "SMPLX_NEUTRAL.npz")
        self.smpl_model = SMPLX.from_npz(path, use_pca=False,
                                         flat_hand_mean=True, device=device)
        dev = torch.device(device)
        sd = self.smpl_data
        idx = np.asarray(self.pose_list, np.int64)
        betas = np.broadcast_to(sd["betas"][0:1],
                                (len(idx), sd["betas"].shape[-1]))

        def take(key, dim):
            if key in sd:
                return sd[key][idx]
            return np.zeros((len(idx), dim), np.float32)

        n_expr = int(self.smpl_model.data.expr_dirs.shape[-1])
        kw_live = dict(
            betas=betas,
            global_orient=take("global_orient", 3),
            transl=take("transl", 3),
            body_pose=take("body_pose", 63),
            jaw_pose=take("jaw_pose", 3),
            expression=take("expression", n_expr)[..., :n_expr],
            left_hand_pose=take("left_hand_pose", 45),
            right_hand_pose=take("right_hand_pose", 45),
        )
        kw_cano = dict(
            betas=betas,
            global_orient=np.broadcast_to(
                agt_config.CANO_SMPL_GLOBAL_ORIENT, (len(idx), 3)),
            transl=np.broadcast_to(agt_config.CANO_SMPL_TRANSL,
                                   (len(idx), 3)),
            body_pose=np.broadcast_to(agt_config.CANO_SMPL_BODY_POSE,
                                      (len(idx), 63)),
            jaw_pose=kw_live["jaw_pose"],
            expression=kw_live["expression"],
        )
        kw_woroot = dict(
            betas=betas,
            body_pose=kw_live["body_pose"],
            jaw_pose=kw_live["jaw_pose"],
            expression=kw_live["expression"],
        )

        outs = {"live": [], "cano": [], "woroot": []}
        B = 512      # chunks bound the peak memory of long sequences
        for s in range(0, len(idx), B):
            sl = slice(s, min(s + B, len(idx)))
            for name, kw in (("live", kw_live), ("cano", kw_cano),
                             ("woroot", kw_woroot)):
                out = self.smpl_model(**{
                    k: torch.as_tensor(np.ascontiguousarray(v[sl]),
                                       dtype=torch.float32, device=dev)
                    for k, v in kw.items()})
                outs[name].append({k: out[k].cpu().numpy() for k in
                                   ("A", "vertices", "joints")})

        def cat(name, key):
            return np.concatenate([o[key] for o in outs[name]])

        live_A = cat("live", "A")
        cano_A = cat("cano", "A")
        woroot_A = cat("woroot", "A")
        inv_cano_A = np.linalg.inv(cano_A)
        self._frame_of_pose = {p: i for i, p in enumerate(self.pose_list)}
        self.cano2live_jnt_mats = (live_A @ inv_cano_A).astype(np.float32)
        self.cano2live_jnt_mats_woRoot = (
            woroot_A @ inv_cano_A).astype(np.float32)
        self.live_vertices = cat("live", "vertices").astype(np.float32)
        self.live_joints = cat("live", "joints").astype(np.float32)
        self.cano_vertices_per_frame = cat("cano", "vertices").astype(
            np.float32)
        self.cano_joints_per_frame = cat("cano", "joints").astype(np.float32)
        self.live_vertices_woRoot = cat("woroot", "vertices").astype(
            np.float32)

        # static canonical body (no jaw/expr; ref: dataset_mv_rgb.py:77-92)
        def row(a):
            return torch.tensor(np.asarray(a, np.float32)[None], device=dev)

        ret = self.smpl_model(betas=row(betas[0]),
                              global_orient=row(
                                  agt_config.CANO_SMPL_GLOBAL_ORIENT),
                              transl=row(agt_config.CANO_SMPL_TRANSL),
                              body_pose=row(agt_config.CANO_SMPL_BODY_POSE))
        self.cano_smpl = {k: v[0].cpu().numpy() for k, v in ret.items()}
        self.inv_cano_jnt_mats = np.linalg.inv(self.cano_smpl["A"])
        v = self.cano_smpl["vertices"]
        min_xyz, max_xyz = v.min(0), v.max(0)
        self.cano_smpl_center = 0.5 * (min_xyz + max_xyz)
        min_xyz = min_xyz - np.array([0.05, 0.05, 0.15], np.float32)
        max_xyz = max_xyz + np.array([0.05, 0.05, 0.15], np.float32)
        self.cano_bounds = np.stack([min_xyz, max_xyz]).astype(np.float32)
        self.smpl_faces = np.asarray(self.smpl_model.faces, np.int32)

    # ------------------------------------------------------------------
    def __len__(self):
        return len(self.data_list) if self.training else len(self.pose_list)

    def __getitem__(self, index):
        return self.getitem(index, self.training)

    def getitem(self, index, training=True, **kwargs):
        """A training item (``skip_images=True``: pose maps and camera
        only), with ``eval=True`` the item of ``pose_idx`` / ``view_idx``,
        or with ``training=False`` the testing item of ``pose_list[index]``
        seen by ``extr`` / ``intr`` at ``img_w`` x ``img_h`` (default: the
        512^2 front camera)."""
        if training or kwargs.get("eval", False):
            pose_idx, view_idx = self.data_list[index]
            pose_idx = kwargs.get("pose_idx", pose_idx)
            view_idx = kwargs.get("view_idx", view_idx)
            data_idx = (pose_idx, view_idx)
        else:
            pose_idx, view_idx = self.pose_list[index], None
            data_idx = pose_idx

        f = self._frame_of_pose[pose_idx]
        item = dict(
            item_idx=index,
            data_idx=data_idx,
            time_stamp=np.float32(pose_idx),
            joints=self.live_joints[f, :22],
            kin_parent=np.asarray(
                self.smpl_model.data.parents[:22], np.int64),
            global_orient=self.smpl_data["global_orient"][pose_idx],
            transl=self.smpl_data["transl"][pose_idx],
            live_smpl_v=self.live_vertices[f],
            live_smpl_v_woRoot=self.live_vertices_woRoot[f],
            cano_smpl_v=self.cano_vertices_per_frame[f],
            cano_jnts=self.cano_joints_per_frame[f],
            cano2live_jnt_mats=self.cano2live_jnt_mats[f],
            cano2live_jnt_mats_woRoot=self.cano2live_jnt_mats_woRoot[f],
            cano_smpl_center=self.cano_smpl_center,
            cano_bounds=self.cano_bounds,
            smpl_faces=self.smpl_faces,
        )
        lv = self.live_vertices[f]
        item["live_bounds"] = np.stack([lv.min(0) - 0.15,
                                        lv.max(0) + 0.15]).astype(np.float32)

        if self.load_smpl_pos_map:
            m = image_io.imread(os.path.join(self.data_dir, "smpl_pos_map",
                                             "%08d.exr" % pose_idx))
            half = m.shape[1] // 2
            item["smpl_pos_map"] = np.concatenate(
                [m[:, :half], m[:, half:]], axis=2).astype(np.float32)
        if self.load_smpl_nml_map:
            m = image_io.imread(os.path.join(self.data_dir, "smpl_nml_map",
                                             "%08d.jpg" % pose_idx))
            m = (m / 255.0).astype(np.float32)
            half = m.shape[1] // 2
            item["smpl_nml_map"] = np.concatenate(
                [m[:, :half], m[:, half:]], axis=2)

        if training and kwargs.get("skip_images", False):
            # pose-map-only item: the pretrain phase reads no camera image
            item.update(img_h=int(self.img_heights[view_idx]),
                        img_w=int(self.img_widths[view_idx]),
                        extr=self.extr_mats[view_idx],
                        intr=self.intr_mats[view_idx])
        elif training:
            color, mask = self.load_color_mask_images(pose_idx, view_idx)
            color = (color / 255.0).astype(np.float32)
            boundary, mask_bin = self.get_boundary_mask(mask)
            if self.mode == "3dgs":
                item.update(
                    img_h=color.shape[0], img_w=color.shape[1],
                    extr=self.extr_mats[view_idx],
                    intr=self.intr_mats[view_idx],
                    color_img=color,
                    mask_img=mask_bin.astype(np.float32),
                    boundary_mask_img=boundary.astype(np.float32))
            else:
                from animatablegaussians_torch.utils import nerf as nerf_util
                rays = nerf_util.sample_rays_for_training(
                    color, mask_bin, self.extr_mats[view_idx],
                    self.intr_mats[view_idx], item["live_bounds"],
                    unsample_region_mask=boundary, rng=self.ray_rng)
                item.update(nerf_random=rays,
                            extr=self.extr_mats[view_idx],
                            intr=self.intr_mats[view_idx])
        else:
            item.update(
                img_h=kwargs.get("img_h", 512),
                img_w=kwargs.get("img_w", 512),
                intr=kwargs.get("intr", np.array(
                    [[550, 0, 256], [0, 550, 256], [0, 0, 1]], np.float32)),
                extr=kwargs.get("extr", self._default_front_extr(item)))
        if self.mode == "nerf" or not training:
            self._attach_mano(item, self.live_vertices[f])
        return item

    @staticmethod
    def _default_front_extr(item):
        return viz.calc_front_mv(item["live_bounds"].mean(0),
                                 tar_pos=np.array([0, 0, 2.5], np.float32))

    # -- subclass hooks -------------------------------------------------
    def load_cam_data(self):
        raise NotImplementedError

    def load_smpl_data(self):
        """smpl_params.npz with body_pose/global_orient/transl/betas/...
        (ref: dataset_mv_rgb.py:255-259)."""
        raw = np.load(os.path.join(self.data_dir, "smpl_params.npz"),
                      allow_pickle=True)
        self.smpl_data = {k: np.asarray(v, np.float32)
                          for k, v in dict(raw).items()}

    def filter_missing_files(self):
        pass

    def load_color_mask_images(self, pose_idx, view_idx):
        raise NotImplementedError

    # ------------------------------------------------------------------
    @staticmethod
    def get_boundary_mask(mask: np.ndarray, kernel_size: int = 5):
        """Binarize at 128; boundary band = dilate - erode plus soft-matte
        pixels in (5, 250) (ref: dataset_mv_rgb.py:263-285)."""
        return image_io.boundary_mask(mask, kernel_size)

    # -- PCA pose-space projection (ref: dataset_mv_rgb.py:287-321) ------
    def _front_pose_map(self, pose_idx: int) -> np.ndarray:
        m = image_io.imread(os.path.join(self.data_dir, "smpl_pos_map",
                                         "%08d.exr" % pose_idx))
        return m[:, : m.shape[1] // 2]

    def compute_pca(self, n_components: int = 10, device="cpu"):
        """Fit the PCA of the front pose maps' masked texels over the pose
        list, or load it from ``smpl_pos_map/pca_<n>.npz``. The fit stacks
        X (poses x 3 masked texels) on ``device`` in float32, the EXRs'
        own precision (2001 poses of the shipped configs' ~797k values:
        6.4 GB), and takes the top eigenpairs of the centred Gram matrix
        X X^T in float64; the components are V^T = S^-1 U^T X. The Gram
        matrix needs every pair of frames, so X is stacked rather than
        streamed (streaming would read every EXR twice).
        ``pca_fit_s`` holds the seconds of the fit or the load."""
        t0 = time.perf_counter()
        path = os.path.join(self.data_dir, "smpl_pos_map",
                            "pca_%d.npz" % n_components)
        if os.path.exists(path):
            with np.load(path) as f:
                pca = {k: f[k] for k in f.files}
        else:
            pca = _fit_pca(self._front_pose_map, self.pose_list,
                           n_components, torch.device(device))
            np.savez(path, **pca)
        self.pos_map_mask = pca.pop("mask")
        self.pca = pca
        self._pca_on = {}
        self.pca_fit_s = time.perf_counter() - t0

    def transform_pca(self, pose_conds, sigma_pca: float = 2.0):
        """Project (M, 3) masked texels (an array, or a tensor on any
        device) onto the components, clamp each coordinate to +-sigma_pca
        standard deviations, and map back; float64 arithmetic, the input's
        type and dtype out."""
        x = torch.as_tensor(pose_conds)
        dev = x.device
        if dev not in self._pca_on:
            self._pca_on[dev] = {k: torch.as_tensor(v, dtype=torch.float64,
                                                    device=dev)
                                 for k, v in self.pca.items()}
        p = self._pca_on[dev]
        low = (x.reshape(1, -1).double() - p["mean"]) @ p["components"].T
        lim = sigma_pca * torch.sqrt(p["explained_variance"])
        low = torch.maximum(torch.minimum(low, lim), -lim)
        out = (low @ p["components"] + p["mean"]).reshape(-1, 3).to(x.dtype)
        return out if torch.is_tensor(pose_conds) else out.numpy()


@torch.no_grad()
def _fit_pca(front_pose_map, pose_list, n_components: int,
             device: torch.device, block_bytes: int = 2 ** 28) -> dict:
    """mean (D,), components (k, D), explained_variance (k,) in float64 and
    the texel mask (H, W) of the first frame; D = 3 masked texels. X is
    held in float32; the centring, the Gram matrix and the components are
    computed in float64 over blocks of columns of at most ``block_bytes``
    in float64."""
    first = front_pose_map(pose_list[0])
    mask = np.linalg.norm(first, axis=-1) > 1e-6
    n = len(pose_list)
    x = torch.empty((n, 3 * int(mask.sum())), dtype=torch.float32,
                    device=device)
    for i, pose_idx in enumerate(pose_list):
        m = first if i == 0 else front_pose_map(pose_idx)
        x[i] = torch.as_tensor(m[mask].reshape(-1), device=device)
    step = max(1, block_bytes // (8 * n))
    cols = [slice(j, j + step) for j in range(0, x.shape[1], step)]
    mean = torch.cat([x[:, c].double().mean(0) for c in cols])
    gram = torch.zeros((n, n), dtype=torch.float64, device=device)
    for c in cols:
        xc = x[:, c].double() - mean[c]
        gram += xc @ xc.T
    evals, evecs = torch.linalg.eigh(gram)              # ascending
    evals = evals.flip(0)[:n_components].clamp(min=0)
    evecs = evecs.flip(1)[:, :n_components]
    s = torch.sqrt(evals)
    # a direction of zero variance gets a zero component: its clamped
    # coordinate is 0 whatever the direction
    inv_s = torch.where(s > 1e-12 * max(float(s[0]), 1e-300), 1.0 / s,
                        torch.zeros_like(s))
    proj = (evecs * inv_s).T
    comps = torch.cat([proj @ (x[:, c].double() - mean[c]) for c in cols],
                      dim=1)
    return dict(mean=mean.cpu().numpy(), components=comps.cpu().numpy(),
                explained_variance=(evals / max(n - 1, 1)).cpu().numpy(),
                mask=mask)


# ---------------------------------------------------------------------------
# Dataset-format subclasses (ref: dataset_mv_rgb.py:324-500)
# ---------------------------------------------------------------------------

def _calibration(cams: dict, names) -> tuple:
    """(extr, intr, widths, heights) from R/T/K/imgSize camera entries."""
    extr, intr, widths, heights = [], [], [], []
    for name in names:
        e = np.identity(4, np.float32)
        e[:3, :3] = np.array(cams[name]["R"], np.float32).reshape(3, 3)
        e[:3, 3] = np.array(cams[name]["T"], np.float32)
        extr.append(e)
        intr.append(np.array(cams[name]["K"], np.float32).reshape(3, 3))
        widths.append(cams[name]["imgSize"][0])
        heights.append(cams[name]["imgSize"][1])
    return extr, intr, widths, heights


def _missing(data_dir: str, view_of_dir) -> set:
    """(frame, view) pairs listed in missing_img_files.txt, if any."""
    path = os.path.join(data_dir, "missing_img_files.txt")
    if not os.path.exists(path):
        return set()
    missing = set()
    for line in open(path):
        line = line.replace("\\", "/")
        frame = int(os.path.basename(line).replace(".jpg", ""))
        missing.add((frame, view_of_dir(os.path.basename(
            os.path.dirname(line)))))
    return missing


class MvRgbDatasetTHuman4(MvRgbDatasetBase):
    """calibration.json with cam%02d keys (ref: dataset_mv_rgb.py:347-360)."""

    def load_cam_data(self):
        with open(os.path.join(self.data_dir, "calibration.json")) as fp:
            cams = json.load(fp)
        self.view_num = len(cams)
        self.cam_names = ["cam%02d" % i for i in range(self.view_num)]
        (self.extr_mats, self.intr_mats, self.img_widths,
         self.img_heights) = _calibration(cams, self.cam_names)

    def filter_missing_files(self):
        missing = _missing(self.data_dir,
                           lambda d: int(d.replace("cam", "")))
        self.data_list = [d for d in self.data_list if d not in missing]

    def load_color_mask_images(self, pose_idx, view_idx):
        name = "cam%02d" % view_idx
        color = image_io.imread(os.path.join(
            self.data_dir, "images", name, "%08d.jpg" % pose_idx))
        mask = image_io.imread(os.path.join(
            self.data_dir, "masks", name, "%08d.jpg" % pose_idx))
        return color, mask


class MvRgbDatasetAvatarReX(MvRgbDatasetBase):
    """calibration_full.json keyed by camera name
    (ref: dataset_mv_rgb.py:404-417)."""

    def load_cam_data(self):
        with open(os.path.join(self.data_dir,
                               "calibration_full.json")) as fp:
            cams = json.load(fp)
        self.cam_names = list(cams.keys())
        self.view_num = len(self.cam_names)
        (self.extr_mats, self.intr_mats, self.img_widths,
         self.img_heights) = _calibration(cams, self.cam_names)

    def filter_missing_files(self):
        missing = _missing(self.data_dir, self.cam_names.index)
        self.data_list = [d for d in self.data_list if d not in missing]

    def load_color_mask_images(self, pose_idx, view_idx):
        name = self.cam_names[view_idx]
        color = image_io.imread(os.path.join(self.data_dir, name,
                                             "%08d.jpg" % pose_idx))
        mask = image_io.imread(os.path.join(self.data_dir, name, "mask",
                                            "pha", "%08d.jpg" % pose_idx))
        return color, mask


class MvRgbDatasetActorsHQ(MvRgbDatasetBase):
    """4x/calibration.csv; extrinsics are cam->world and get inverted
    (ref: dataset_mv_rgb.py:466-494)."""

    def __init__(self, data_dir, **kw):
        super().__init__(data_dir, **kw)
        if kw.get("subject_name") is None:
            self.subject_name = os.path.basename(os.path.dirname(data_dir))

    def load_cam_data(self):
        self.cam_names, self.extr_mats, self.intr_mats = [], [], []
        self.img_widths, self.img_heights = [], []
        with open(os.path.join(self.data_dir, "4x", "calibration.csv"),
                  newline="", encoding="utf-8") as fp:
            for row in csv.DictReader(fp):
                self.cam_names.append(row["name"])
                w, h = int(row["w"]), int(row["h"])
                self.img_widths.append(w)
                self.img_heights.append(h)
                e = np.identity(4, np.float32)
                rvec = torch.tensor([float(row["rx"]), float(row["ry"]),
                                     float(row["rz"])], dtype=torch.float32)
                e[:3, :3] = axis_angle_to_mat(rvec).numpy()   # Rodrigues
                e[:3, 3] = [float(row["tx"]), float(row["ty"]),
                            float(row["tz"])]
                self.extr_mats.append(np.linalg.inv(e))
                k = np.identity(3, np.float32)
                k[0, 0] = float(row["fx"]) * w
                k[0, 2] = float(row["px"]) * w
                k[1, 1] = float(row["fy"]) * h
                k[1, 2] = float(row["py"]) * h
                self.intr_mats.append(k)
        self.view_num = len(self.cam_names)

    def load_color_mask_images(self, pose_idx, view_idx):
        name = self.cam_names[view_idx]
        color = image_io.imread(os.path.join(
            self.data_dir, "4x", "rgbs", name,
            "%s_rgb%06d.jpg" % (name, pose_idx)))
        mask = image_io.imread(os.path.join(
            self.data_dir, "4x", "masks", name,
            "%s_mask%06d.png" % (name, pose_idx)))
        return color, mask


_DATASETS = {
    "MvRgbDatasetAvatarReX": MvRgbDatasetAvatarReX,
    "MvRgbDatasetTHuman4": MvRgbDatasetTHuman4,
    "MvRgbDatasetActorsHQ": MvRgbDatasetActorsHQ,
}


def get_dataset_class(name: str):
    """String -> class, replacing the reference's importlib hook
    (ref: main_avatar.py:267-268)."""
    return _DATASETS[name]
