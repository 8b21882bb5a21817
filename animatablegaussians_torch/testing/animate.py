"""Novel-pose animation: the ``-m test`` route of ``main_avatar_torch.py``.

Port of ``animatablegaussians_tpu/testing/animate.py`` (ref:
main_avatar.py:525-776): the view settings camera / free / front / back /
moving / cano (a 216-frame orbit, the 1100-focal 1024^2 synthesis camera),
pose-map regeneration for novel poses, the PCA projection of the front pose
map with +-sigma clamping, mean-hand freezing, and the rgb / mask /
texture-map / skeleton / PLY export, with the same options, file names
and call order.

Every frame renders under ``torch.no_grad()`` on the trainer's device:
``seq_frames`` frames that share an image size go through one
``AvatarNet.render_sequence`` call (the three heads as one batch), or one
``render`` a frame when the texture map or the PLY is asked for. The PCA
projection runs on the device too; the host does the camera math, the
dataset items and the file writes.
"""

from __future__ import annotations

import os
import time
from functools import partial

import numpy as np
import torch

from animatablegaussians_torch.utils import visualize as viz
from animatablegaussians_torch.utils.profiling import count, span

# the item keys the render, render_sequence, get_pose_map and the mean-hand
# blend read, moved to the device once a frame
DEVICE_KEYS = ("smpl_pos_map", "cano2live_jnt_mats",
               "cano2live_jnt_mats_woRoot", "extr", "intr",
               "left_cano_mano_v", "right_cano_mano_v", "cano_smpl_center")


def _rodrigues(v):
    return viz._rodrigues(np.asarray(v, np.float32))


def compute_view(view_setting: str, idx: int, object_center, global_orient,
                 dataset, opt_test: dict):
    """extr / intr / image size of one frame (ref: main_avatar.py:593-672)."""
    img_scale = float(opt_test.get("img_scale", 1.0))
    use_go = opt_test.get("global_orient", False)
    go = global_orient if use_go else None

    if view_setting == "camera":
        cam_id = opt_test["render_view_idx"]
        intr = dataset.intr_mats[cam_id].copy()
        intr[:2] *= img_scale
        extr = dataset.extr_mats[cam_id].copy()
        img_h = int(dataset.img_heights[cam_id] * img_scale)
        img_w = int(dataset.img_widths[cam_id] * img_scale)
        return extr, intr, img_w, img_h

    bird = view_setting.endswith("bird")
    if view_setting.startswith("free"):
        rot_y = (idx % 216) / 216.0 * 2 * np.pi
        rot_x = 0.3 if bird else 0.0
    elif view_setting.startswith("front"):
        rot_y, rot_x = 0.0, (0.3 if bird else 0.0)
    elif view_setting.startswith("back"):
        rot_y, rot_x = np.pi, (0.5 * np.pi / 4.0 if bird else 0.0)
    elif view_setting.startswith("moving"):
        rot_y, rot_x = 0.0, (0.3 if bird else 0.0)
    elif view_setting.startswith("cano"):
        extr = np.identity(4, np.float32)
        extr[:3, 3] = -np.asarray(object_center)
        rx = np.identity(4, np.float32)
        rx[:3, :3] = _rodrigues([np.pi, 0, 0])
        extr = rx @ extr
        f_len = 5000.0
        extr[2, 3] += f_len / 512
        intr = np.array([[f_len, 0, 512], [0, f_len, 512], [0, 0, 1]],
                        np.float32)
        return extr, intr, 1024, 1024
    else:
        raise ValueError(f"Invalid view setting: {view_setting}")

    extr = viz.calc_free_mv(object_center, tar_pos=np.array([0, 0, 2.5]),
                            rot_Y=rot_y, rot_X=rot_x, global_orient=go)
    intr = np.array([[1100, 0, 512], [0, 1100, 512], [0, 0, 1]], np.float32)
    intr[:2] *= img_scale
    s = int(1024 * img_scale)
    return extr, intr, s, s


@torch.no_grad()
def run_test(trainer, opt: dict) -> str:
    """Render ``opt["test"]``'s poses with the trainer's AvatarNet and write
    the frames; returns the output directory. Sets ``trainer.test_datasets``
    (the training dataset, which holds the PCA, and the pose dataset) and
    ``trainer.test_loop_t0`` (``time.perf_counter()`` at the frame loop's
    start)."""
    from animatablegaussians_torch.data import get_dataset_class
    from animatablegaussians_torch.data.pose_dataset import PoseDataset
    from animatablegaussians_torch.utils import exr

    opt_test = opt["test"]
    avatar_net = trainer.avatar_net
    device = trainer.device

    ds_cls = get_dataset_class(opt["train"].get(
        "dataset", "MvRgbDatasetAvatarReX"))
    training_dataset = ds_cls(**opt["train"]["data"], training=False)
    n_pca = int(opt_test.get("n_pca", -1))
    use_pca = n_pca >= 1
    if use_pca:
        training_dataset.compute_pca(n_components=n_pca, device=device)

    if "pose_data" in opt_test:
        dataset = PoseDataset(**opt_test["pose_data"],
                              smpl_shape=training_dataset.smpl_data[
                                  "betas"][0])
        dataset_name, seq_name = dataset.dataset_name, dataset.seq_name
    else:
        dataset = ds_cls(**opt_test["data"], training=False)
        dataset_name, seq_name = "training", ""
        use_pca = False

    # the two datasets, for a caller that reads their timings or PCA
    trainer.test_datasets = dict(training=training_dataset, poses=dataset)
    if opt_test.get("prev_ckpt"):
        trainer.load_ckpt(opt_test["prev_ckpt"], load_optm=False)

    view_setting = opt_test.get("view_setting", "free")
    view_folder = ("cam_%03d" % opt_test["render_view_idx"]
                   if view_setting == "camera" else view_setting + "_view")
    output_dir = opt_test.get("output_dir") or os.path.join(
        "test_results", training_dataset.subject_name,
        f"{dataset_name}_{seq_name}_{view_folder}",
        "batch_%06d" % trainer.iter_idx,
        ("pca_%d_sigma_%.2f" % (n_pca, float(opt_test.get("sigma_pca", 1.0)))
         if use_pca else "vanilla"))
    os.makedirs(os.path.join(output_dir, "rgb_map"), exist_ok=True)
    os.makedirs(os.path.join(output_dir, "mask_map"), exist_ok=True)
    print(f"# Output dir: {output_dir}")

    getitem = (dataset.getitem_fast if hasattr(dataset, "getitem_fast")
               else partial(dataset.getitem, training=False))
    item0 = getitem(0)
    object_center = item0["live_bounds"].mean(0)
    global_orient = _rodrigues(np.asarray(item0["global_orient"]))

    hand_vals = None
    if opt_test.get("fix_hand", False):
        # hand Gaussians frozen to a fixed training frame's pose map
        # (ref: network/avatar.py:52-82, config key test.fix_hand_id)
        fid = int(opt_test.get("fix_hand_id", 0))
        m = exr.read_exr(os.path.join(opt["train"]["data"]["data_dir"],
                                      "smpl_pos_map", "%08d.exr" % fid))
        half = m.shape[1] // 2
        fix_pose_map = np.concatenate([m[:, :half], m[:, half:]],
                                      axis=2)[..., :3]
        hand_vals = avatar_net.generate_mean_hands(torch.as_tensor(
            fix_pose_map, dtype=torch.float32, device=device))

    kw = dict(use_pca=use_pca, hand_vals=hand_vals, bg_color=(1.0, 1.0, 1.0))
    sigma_pca = float(opt_test.get("sigma_pca", 2.0))
    if use_pca:
        mask = torch.as_tensor(training_dataset.pos_map_mask, device=device)

    # Frame-batched dispatch: stage up to seq_frames frames (camera math,
    # item, PCA) and render them in ONE render_sequence call; one render a
    # frame when a consumer needs the outputs the sequence path drops (the
    # texture map, the posed-Gaussian PLY). seq_frames = 1 turns it off.
    seq_frames = int(opt_test.get("seq_frames", 8))
    if opt_test.get("save_tex_map", False) or opt_test.get("save_ply",
                                                           False):
        seq_frames = 1

    def prepare(idx):
        extr, intr, img_w, img_h = compute_view(
            view_setting, idx, object_center, global_orient, dataset,
            opt_test)
        item = getitem(idx, extr=extr, intr=intr, img_w=img_w, img_h=img_h)

        if view_setting.startswith("moving") or view_setting == "free_moving":
            # in place: later calls of compute_view see the new centre
            cur = np.asarray(item["live_bounds"]).mean(0)
            object_center[0] += (cur - object_center)[0]

        items = {k: torch.as_tensor(item[k], dtype=torch.float32,
                                    device=device)
                 for k in DEVICE_KEYS if k in item}
        if "smpl_pos_map" not in items:
            items["smpl_pos_map"] = avatar_net.get_pose_map(items)

        if use_pca:
            front, back = torch.split(items["smpl_pos_map"], [3, 3], dim=2)
            front = front.clone()
            front[mask] = training_dataset.transform_pca(front[mask],
                                                         sigma_pca=sigma_pca)
            items["smpl_pos_map_pca"] = torch.cat([front, back], 2)
        return item, items, extr, intr, img_w, img_h

    idx = 0
    n_frames = len(dataset)
    trainer.test_loop_t0 = time.perf_counter()    # the frame loop's start
    while idx < n_frames:
        # stage up to seq_frames frames that share an image size
        staged = [prepare(idx)]
        size = staged[0][4:6]
        while len(staged) < seq_frames and idx + len(staged) < n_frames:
            nxt = prepare(idx + len(staged))
            if nxt[4:6] != size:
                break
            staged.append(nxt)

        if len(staged) > 1:
            items_seq = {k: torch.stack([s[1][k] for s in staged])
                         for k in staged[0][1]}
            seq_out = avatar_net.render_sequence(
                items_seq, img_w=size[0], img_h=size[1], **kw)
            outputs = [{k: v[f] for k, v in seq_out.items()}
                       for f in range(len(staged))]
        else:
            outputs = [avatar_net.render(staged[0][1], img_w=size[0],
                                         img_h=size[1], **kw)]

        for (item, items, extr, intr, img_w, img_h), output in zip(
                staged, outputs):
            _write_frame(item, items, extr, intr, img_w, img_h, output,
                         output_dir, opt_test, trainer)
        idx += len(staged)

    return output_dir


@span("readback")
def _to_u8(img: torch.Tensor) -> np.ndarray:
    with span("wait.readback"):
        host = img.clamp(0, 1).cpu()
    count("host.waits")
    with span("readback.convert"):
        return (host.numpy() * 255).astype(np.uint8)


def _write_frame(item, items, extr, intr, img_w, img_h, output,
                 output_dir, opt_test, trainer):
    """rgb_map/<idx>.jpg and mask_map/<idx>.png; with the options also
    cano_tex_map/<idx>.jpg, live_skeleton/<idx>.jpg and
    posed_gaussians/<idx>.ply (the valid points only)."""
    import cv2

    from animatablegaussians_torch.data import image_io

    name = "%08d" % item["data_idx"]

    def path(folder, ext):
        os.makedirs(os.path.join(output_dir, folder), exist_ok=True)
        return os.path.join(output_dir, folder, name + ext)

    image_io.write_jpeg(path("rgb_map", ".jpg"), _to_u8(output["rgb_map"]))
    cv2.imwrite(path("mask_map", ".png"), _to_u8(output["mask_map"]))
    if opt_test.get("save_tex_map", False):
        image_io.write_jpeg(path("cano_tex_map", ".jpg"),
                            _to_u8(output["cano_tex_map"]))
    if opt_test.get("render_skeleton", False):
        # ball+cylinder skeleton overlay, phong-shaded on white
        # (ref: main_avatar.py:699-711)
        from animatablegaussians_torch.data.commons import _vertex_normals
        from animatablegaussians_torch.utils.mesh_renderer import Renderer
        from animatablegaussians_torch.utils.visualize_skeletons import \
            construct_skeletons
        skel_v, skel_f = construct_skeletons(
            np.asarray(item["joints"]), np.asarray(item["kin_parent"]))
        normals = _vertex_normals(skel_v, skel_f)
        geo = Renderer(img_w, img_h, shader_name="phong_geometry",
                       bg_color=(1, 1, 1))
        geo.set_camera(extr, intr)
        geo.set_model(skel_v[skel_f.reshape(-1)],
                      normals[skel_f.reshape(-1)])
        skel_img = np.clip(geo.render()[:, :, :3], 0, 1)
        image_io.write_jpeg(path("live_skeleton", ".jpg"),
                            (skel_img * 255).astype(np.uint8))
    if opt_test.get("save_ply", False):
        from animatablegaussians_torch.models.gaussian_model import \
            save_gaussians_as_ply
        # drop the block-packing pad points
        valid = trainer.avatar_net.valid
        save_gaussians_as_ply(path("posed_gaussians", ".ply"), {
            k: v[valid] if v.shape[0] == valid.shape[0] else v
            for k, v in output["posed_gaussians"].items()})
