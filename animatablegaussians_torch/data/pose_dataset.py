"""Driving-pose dataset for novel-pose animation.

Port of ``animatablegaussians_tpu/data/pose_dataset.py`` (ref:
dataset/dataset_pose.py:19-548) with the same pose archives and surgery:
AMASS .npz (arm and collar zeroing), aist++ .pkl (translation in mm),
THuman4 / ActorsHQ / AvatarReX .npz (with a calibration JSON placed next to
the archive); hand-pose modes fist / normal / zero / ori; a 3-frame
denoise window; leg clipping; flat and nested frame ranges; the canonical
A-pose item.

All per-frame SMPL-X forwards (live, without the root, and the canonical
body) run as batched calls of the port's ``models/smplx`` on the CPU at
init; ``getitem_fast`` (the 3DGS path, ref:
dataset_pose.py:361-457) is then array indexing. ``getitem`` is the NeRF
item of a template render (ref: dataset_pose.py:254-360): the full image's
rays clipped to the live bounds (``utils/nerf``), and the body pose with
the head and hand joints zeroed under ``fix_head_pose`` / ``fix_hand_pose``.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Optional

import numpy as np
import torch

from animatablegaussians_torch import config as agt_config
from animatablegaussians_torch.data import commons
from animatablegaussians_torch.utils import nerf as nerf_util
from animatablegaussians_torch.utils import visualize as viz

# relaxed "normal" hand poses used by hand_pose_type='normal'
# (ref: dataset_pose.py:233-238; values are the reference's constants)
NORMAL_LEFT_HAND_POSE = np.array([
    0.10859203338623047, 0.10181399434804916, -0.2822268009185791,
    0.10211331397294998, -0.09689036756753922, -0.4484838545322418,
    -0.11360692232847214, -0.023141659796237946, 0.10571160167455673,
    -0.08793719857931137, -0.026760095730423927, -0.41390693187713623,
    -0.0923849567770958, 0.10266668349504471, -0.36039748787879944,
    0.02140655182301998, -0.07156527787446976, -0.04903153330087662,
    -0.22358819842338562, -0.3716682195663452, -0.2683027982711792,
    -0.1506909281015396, 0.07079305499792099, -0.34404537081718445,
    -0.168443500995636, -0.014021224342286587, 0.09489774703979492,
    -0.050323735922575, -0.18992969393730164, -0.43895423412323,
    -0.1806418001651764, 0.0198075994849205, -0.25444355607032776,
    -0.10171788930892944, -0.10680688172578812, -0.09953738003969193,
    0.8094075918197632, 0.5156061053276062, -0.07900168001651764,
    -0.45094889402389526, 0.24947893619537354, 0.23369410634040833,
    0.45277315378189087, -0.17375235259532928, -0.3077943027019501,
], np.float32)
NORMAL_RIGHT_HAND_POSE = np.array([
    0.06415501981973648, -0.06942438334226608, 0.282951682806015,
    0.09073827415704727, 0.0775153785943985, 0.2961004376411438,
    -0.07659692317247391, 0.004730052314698696, -0.12084470689296722,
    0.007974660955369473, 0.05222926288843155, 0.32775357365608215,
    -0.10166633129119873, -0.06862349808216095, 0.174485981464386,
    -0.0023323255591094494, 0.04998664930462837, -0.03490559384226799,
    0.12949667870998383, 0.26883721351623535, 0.06881044059991837,
    -0.18259745836257935, -0.08183271437883377, 0.17669665813446045,
    -0.08099694550037384, 0.04115655645728111, -0.17928685247898102,
    0.07734024524688721, 0.13419172167778015, 0.2600148022174835,
    -0.151871919631958, -0.01772170141339302, 0.1267814189195633,
    -0.08800505846738815, 0.09480107575654984, 0.0016392067773267627,
    0.6149336695671082, -0.32634419202804565, 0.02278662845492363,
    -0.39148610830307007, -0.22757330536842346, -0.07884717732667923,
    0.38199105858802795, 0.13064607977867126, 0.20154500007629395,
], np.float32)


class PoseDataset:
    def __init__(self, data_path: str, frame_range=None,
                 frame_interval: int = 1, smpl_shape=None,
                 gender: str = "neutral", frame_win: int = 0,
                 fix_head_pose: bool = True, fix_hand_pose: bool = True,
                 denoise: bool = False, hand_pose_type: str = "ori",
                 constrain_leg_pose: bool = False,
                 smpl_model_path: Optional[str] = None,
                 mano_dir: Optional[str] = None):
        self.data_path = data_path
        self.training = False
        self.gender = gender
        self.frame_win = int(frame_win)
        self.fix_head_pose = fix_head_pose
        self.fix_hand_pose = fix_hand_pose
        self.hand_pose_type = hand_pose_type
        self.last_data_idx = 0

        self._load_poses(data_path)

        if denoise:  # 3-frame box filter (ref: dataset_pose.py:180-192)
            w = 1
            bp, tr = self.body_poses.copy(), self.transl.copy()
            n = bp.shape[0]
            acc_b = np.zeros_like(bp[w:n - w])
            acc_t = np.zeros_like(tr[w:n - w])
            for i in range(-w, w + 1):
                acc_b += bp[w + i: n - w + i]
                acc_t += tr[w + i: n - w + i]
            self.body_poses[w:n - w] = acc_b / (2 * w + 1)
            self.transl[w:n - w] = acc_t / (2 * w + 1)

        if constrain_leg_pose:  # (ref: dataset_pose.py:203-214)
            self.body_poses[:, 3 + 4 * 3] = np.clip(
                self.body_poses[:, 3 + 4 * 3], -0.3, 0.3)
            self.body_poses[:, 3 + 5 * 3] = np.clip(
                self.body_poses[:, 3 + 5 * 3], -0.3, 0.3)

        # pose list (ref: dataset_pose.py:133-155, incl. nested ranges)
        if frame_range is None:
            self.pose_list = list(range(0, self.body_poses.shape[0],
                                        frame_interval))
        elif isinstance(frame_range[0], (list, tuple)):
            self.pose_list = []
            for interval in frame_range:
                if len(interval) in (2, 3):
                    self.pose_list += list(range(*interval))
                else:
                    for _ in range(interval[3]):
                        self.pose_list += list(range(*interval[:3]))
        else:
            self.pose_list = list(range(*frame_range))

        self.smpl_shape = (np.zeros(10, np.float32) if smpl_shape is None
                           else np.asarray(smpl_shape, np.float32))
        self._precompute_smpl(smpl_model_path)

        # canonical MANO hand crops, attached to every item: the mean-hand
        # blend reads them (ref: dataset_pose.py:199-201,436-437,529)
        self.mano = commons.try_load_mano(mano_dir)
        if self.mano is not None:
            (self.left_cano_mano_v, self.left_cano_mano_n,
             self.right_cano_mano_v, self.right_cano_mano_n) = \
                commons.generate_two_manos(self.mano,
                                           self.cano_smpl["vertices"])

    # ------------------------------------------------------------------
    def _load_poses(self, data_path: str):
        name, ext = os.path.splitext(os.path.basename(data_path))
        self.extr_mats = None
        if ext == ".pkl":  # aist++ (ref: dataset_pose.py:44-51)
            raw = pickle.load(open(data_path, "rb"))
            self.body_poses = np.asarray(raw["smpl_poses"],
                                         np.float32)[:, :72]
            self.transl = np.asarray(raw["smpl_trans"], np.float32) * 1e-3
            self.dataset_name, self.seq_name = "aist++", name
            self.left_hand_pose = self.right_hand_pose = None
        elif ext == ".npz":
            candidates = ["thuman4", "actorshq", "avatarrex", "AMASS"]
            self.dataset_name = next(
                (c for c in candidates if c in data_path), "AMASS")
            self.seq_name = name
            if self.dataset_name == "AMASS":
                raw = np.load(data_path)
                poses = np.asarray(raw["poses"], np.float32)
                smpl = dict(
                    global_orient=poses[:, :3],
                    transl=np.asarray(raw["trans"], np.float32),
                    body_pose=poses[:, 3: 22 * 3].copy(),
                    left_hand_pose=poses[:, 22 * 3: 37 * 3],
                    right_hand_pose=poses[:, 37 * 3:52 * 3],
                )
                # AMASS arm/collar surgery (ref: dataset_pose.py:79-86)
                smpl["body_pose"][:, 13 * 3 + 2] -= 0.3
                smpl["body_pose"][:, 12 * 3 + 2] += 0.3
                smpl["body_pose"][:, 19 * 3: 20 * 3] = 0.0
                smpl["body_pose"][:, 20 * 3: 21 * 3] = 0.0
                smpl["body_pose"][:, 14 * 3] = 0.0
            else:
                smpl = {k: np.asarray(v, np.float32)
                        for k, v in dict(np.load(data_path)).items()}
            if self.seq_name.endswith("actor01"):  # ref: dataset_pose.py:88-90
                smpl["body_pose"][:, 6 * 3: 8 * 3] = 0.0

            n = smpl["body_pose"].shape[0]
            self.body_poses = np.zeros((n, 72), np.float32)
            self.body_poses[:, :3] = smpl["global_orient"]
            self.body_poses[:, 3:3 + 21 * 3] = smpl["body_pose"][:, :63]
            self.transl = smpl["transl"]
            self.left_hand_pose = smpl.get("left_hand_pose")
            self.right_hand_pose = smpl.get("right_hand_pose")

            # optional co-located calibration (ref: dataset_pose.py:99-114)
            calib = os.path.join(
                os.path.dirname(data_path),
                os.path.basename(data_path).replace(".npz", ".json").replace(
                    "pose", "calibration"))
            if os.path.exists(calib):
                cams = json.load(open(calib))
                self.cam_names = list(cams.keys())
                self.view_num = len(self.cam_names)
                self.extr_mats, self.intr_mats = [], []
                self.img_widths, self.img_heights = [], []
                for cn in self.cam_names:
                    e = np.identity(4, np.float32)
                    e[:3, :3] = np.array(cams[cn]["R"],
                                         np.float32).reshape(3, 3)
                    e[:3, 3] = np.array(cams[cn]["T"], np.float32)
                    self.extr_mats.append(e)
                    self.intr_mats.append(np.array(cams[cn]["K"],
                                                   np.float32).reshape(3, 3))
                    self.img_widths.append(cams[cn]["imgSize"][0])
                    self.img_heights.append(cams[cn]["imgSize"][1])
        else:
            raise ValueError("Invalid data_path (want .pkl or .npz)")

        if self.left_hand_pose is None:
            self.left_hand_pose = np.broadcast_to(
                agt_config.LEFT_HAND_FIST_POSE,
                (self.body_poses.shape[0], 45)).copy()
        if self.right_hand_pose is None:
            self.right_hand_pose = np.broadcast_to(
                agt_config.RIGHT_HAND_FIST_POSE,
                (self.body_poses.shape[0], 45)).copy()

    # ------------------------------------------------------------------
    def _hand_poses_for_frame(self, idx: np.ndarray):
        """Per-frame (45,) left/right hand poses by mode
        (ref: dataset_pose.py:231-246, 369-385)."""
        n = len(idx)
        t = self.hand_pose_type
        if t == "fist":
            l = np.broadcast_to(agt_config.LEFT_HAND_FIST_POSE, (n, 45))
            r = np.broadcast_to(agt_config.RIGHT_HAND_FIST_POSE, (n, 45))
        elif t == "normal":
            l = np.broadcast_to(NORMAL_LEFT_HAND_POSE, (n, 45))
            r = np.broadcast_to(NORMAL_RIGHT_HAND_POSE, (n, 45))
        elif t == "zero":
            l = np.zeros((n, 45), np.float32)
            r = np.zeros((n, 45), np.float32)
        elif t == "ori":
            l = self.left_hand_pose[idx]
            r = self.right_hand_pose[idx]
        else:
            raise ValueError("Invalid hand_pose_type")
        return np.asarray(l, np.float32), np.asarray(r, np.float32)

    @torch.no_grad()
    def _precompute_smpl(self, smpl_model_path):
        from animatablegaussians_torch.models.smplx import SMPLX

        path = smpl_model_path or os.path.join(
            agt_config.PROJ_DIR, "smpl_files", "smplx", "SMPLX_NEUTRAL.npz")
        self.smpl_model = SMPLX.from_npz(path, use_pca=False,
                                         flat_hand_mean=True, device="cpu")

        def t(a):
            return torch.tensor(np.asarray(a, np.float32))

        def host(out):
            return {k: v.cpu().numpy() for k, v in out.items()
                    if k in ("A", "vertices", "joints")}

        idx = np.asarray(self.pose_list, np.int64)
        B = len(idx)
        betas = np.broadcast_to(self.smpl_shape[:10][None], (B, 10))
        lh, rh = self._hand_poses_for_frame(idx)
        live = host(self.smpl_model(
            betas=t(betas), global_orient=t(self.body_poses[idx, :3]),
            transl=t(self.transl[idx]),
            body_pose=t(self.body_poses[idx, 3:66]),
            left_hand_pose=t(lh), right_hand_pose=t(rh)))
        woroot = host(self.smpl_model(
            betas=t(betas), body_pose=t(self.body_poses[idx, 3:66])))
        cano = host(self.smpl_model(
            betas=t(betas[:1]),
            global_orient=t(agt_config.CANO_SMPL_GLOBAL_ORIENT[None]),
            transl=t(agt_config.CANO_SMPL_TRANSL[None]),
            body_pose=t(agt_config.CANO_SMPL_BODY_POSE[None])))

        self.cano_smpl = {k: np.asarray(v[0]) for k, v in cano.items()}
        self.inv_cano_jnt_mats = np.linalg.inv(self.cano_smpl["A"])
        v = self.cano_smpl["vertices"]
        mn, mx = v.min(0), v.max(0)
        self.cano_smpl_center = 0.5 * (mn + mx)
        mn = mn - np.array([0.05, 0.05, 0.15], np.float32)
        mx = mx + np.array([0.05, 0.05, 0.15], np.float32)
        self.cano_bounds = np.stack([mn, mx]).astype(np.float32)
        self.smpl_faces = np.asarray(self.smpl_model.faces, np.int32)

        self.live_vertices = np.asarray(live["vertices"])
        self.live_joints = np.asarray(live["joints"])
        self.live_vertices_woRoot = np.asarray(woroot["vertices"])
        self.cano2live_jnt_mats = np.asarray(
            live["A"]) @ self.inv_cano_jnt_mats
        self.cano2live_jnt_mats_woRoot = np.asarray(
            woroot["A"]) @ self.inv_cano_jnt_mats

    # ------------------------------------------------------------------
    def __len__(self):
        return len(self.pose_list)

    def __getitem__(self, index):
        return self.getitem_fast(index)

    def _base_item(self, index: int) -> dict:
        pose_idx = self.pose_list[index]
        data_idx = pose_idx if (pose_idx == 0 or pose_idx >
                                self.last_data_idx) else self.last_data_idx + 1
        lv = self.live_vertices[index]
        item = dict(
            item_idx=index, data_idx=data_idx,
            time_stamp=np.float32(pose_idx),
            global_orient=self.body_poses[pose_idx, :3],
            transl=self.transl[pose_idx],
            joints=self.live_joints[index, :22],
            kin_parent=np.asarray(self.smpl_model.data.parents[:22],
                                  np.int64),
            live_smpl_v=lv,
            live_smpl_v_woRoot=self.live_vertices_woRoot[index],
            cano_smpl_v=self.cano_smpl["vertices"],
            cano_jnts=self.cano_smpl["joints"],
            cano2live_jnt_mats=self.cano2live_jnt_mats[index],
            cano2live_jnt_mats_woRoot=self.cano2live_jnt_mats_woRoot[index],
            cano_smpl_center=self.cano_smpl_center,
            cano_bounds=self.cano_bounds,
            smpl_faces=self.smpl_faces,
            live_bounds=np.stack([lv.min(0) - 0.15,
                                  lv.max(0) + 0.15]).astype(np.float32),
        )
        self._attach_mano(item)
        self.last_data_idx = data_idx
        return item

    def _attach_mano(self, item: dict):
        """Canonical MANO items (ref: dataset_pose.py:436-437,529)."""
        if self.mano is None:
            return
        item.update(left_cano_mano_v=self.left_cano_mano_v,
                    left_cano_mano_n=self.left_cano_mano_n,
                    right_cano_mano_v=self.right_cano_mano_v,
                    right_cano_mano_n=self.right_cano_mano_n,
                    mano_face_closed=self.mano.mano_face_closed)

    def _camera(self, item, **kwargs):
        img_h = kwargs.get("img_h", 512)
        img_w = kwargs.get("img_w", 512)
        intr = kwargs.get("intr", np.array(
            [[550, 0, 256], [0, 550, 256], [0, 0, 1]], np.float32))
        extr = kwargs.get("extr")
        if extr is None:
            extr = viz.calc_front_mv(item["live_bounds"].mean(0),
                                     tar_pos=np.array([0, 0, 2.5]))
        return dict(img_h=img_h, img_w=img_w, extr=extr, intr=intr)

    def getitem_fast(self, index, **kwargs) -> dict:
        """3DGS animation item (ref: dataset_pose.py:361-457)."""
        item = self._base_item(index)
        item.update(self._camera(item, **kwargs))
        return item

    def getitem(self, index, **kwargs) -> dict:
        """NeRF item: full-image rays clipped to live bounds, plus the
        (optionally fixed) pose vector (ref: dataset_pose.py:254-360)."""
        item = self._base_item(index)
        pose_idx = self.pose_list[index]

        pose = self.body_poses[pose_idx, 3:66].copy()
        if self.fix_head_pose:
            pose[3 * 11: 3 * 11 + 3] = 0.0
            pose[3 * 14: 3 * 14 + 3] = 0.0
        if self.fix_hand_pose:
            pose[3 * 19: 3 * 19 + 3] = 0.0
            pose[3 * 20: 3 * 20 + 3] = 0.0
        item["pose"] = pose
        item["pose_1st"] = self.body_poses[0, 3:66]
        item["lhand_pose"] = np.zeros(45, np.float32)
        item["rhand_pose"] = np.zeros(45, np.float32)

        cam = self._camera(item, **kwargs)
        uv = nerf_util.gen_uv(cam["img_w"], cam["img_h"]).reshape(-1, 2)
        ray_d, ray_o = nerf_util.get_rays(uv, cam["extr"], cam["intr"])
        near, far, ok = nerf_util.get_near_far(item["live_bounds"],
                                               ray_o, ray_d)
        item.update(uv=uv[ok], ray_o=ray_o[ok], ray_d=ray_d[ok],
                    near=near.astype(np.float32),
                    far=far.astype(np.float32),
                    dist=np.zeros_like(near, np.float32), **cam)
        return item

    def getitem_a_pose(self, **kwargs) -> dict:
        """Canonical A-pose item (ref: dataset_pose.py:459-548): identity
        cano->live transforms, fist hands."""
        item = dict(
            item_idx=0, data_idx=0, time_stamp=np.float32(0),
            global_orient=np.zeros(3, np.float32),
            transl=np.zeros(3, np.float32),
            joints=self.cano_smpl["joints"][:22],
            kin_parent=np.asarray(self.smpl_model.data.parents[:22],
                                  np.int64),
            live_smpl_v=self.cano_smpl["vertices"],
            live_smpl_v_woRoot=self.cano_smpl["vertices"],
            cano_smpl_v=self.cano_smpl["vertices"],
            cano_jnts=self.cano_smpl["joints"],
            cano2live_jnt_mats=np.tile(np.eye(4, dtype=np.float32),
                                       (self.cano_smpl["A"].shape[0], 1, 1)),
            cano2live_jnt_mats_woRoot=np.tile(
                np.eye(4, dtype=np.float32),
                (self.cano_smpl["A"].shape[0], 1, 1)),
            cano_smpl_center=self.cano_smpl_center,
            cano_bounds=self.cano_bounds,
            smpl_faces=self.smpl_faces,
        )
        v = self.cano_smpl["vertices"]
        item["live_bounds"] = np.stack([v.min(0) - 0.15,
                                        v.max(0) + 0.15]).astype(np.float32)
        self._attach_mano(item)
        item.update(self._camera(item, **kwargs))
        return item
