"""Generate the per-subject avatar/template YAML configs: a copy of
``animatablegaussians_tpu/tools/make_configs.py`` (yaml only), whose YAML
is byte for byte that tool's.

The YAML schema is byte-compatible with the reference's public config API
(ref: configs/avatarrex_zzr/avatar.yaml:1-75, */template.yaml:36-60;
SURVEY.md §5.6). Subject-specific values (frame ranges, camera ids, eval
frames, driving-pose sequences) are captured in SUBJECTS below; paths are
parameterized by --data_root / --pose_root.

Usage:
    python -m animatablegaussians_torch.tools.make_configs \
        --out_dir configs --data_root /data/MultiviewRGB --pose_root /data/Pose
"""

from __future__ import annotations

import os

import yaml

AVATARREX_CAMS = [0, 1, 2, 3, 4, 5, 6, 8, 9, 10, 11, 12, 14, 15]
THUMAN4_CAMS_23 = [i for i in range(24) if i != 7]
ACTORSHQ_CAMS = [4, 5, 6, 7, 20, 21, 22, 23, 36, 37, 38, 39, 52, 53, 54, 55,
                 76, 77, 78, 79, 92, 93, 94, 95, 108, 109, 110, 111,
                 125, 126, 127, 130, 131, 134, 135, 138, 139, 142, 143,
                 146, 147, 150, 151, 154, 155, 158, 159]

# subject table: training split, eval frames, and the animation demo setup
SUBJECTS = {
    "avatarrex_zzr": dict(
        dataset="MvRgbDatasetAvatarReX", rel="avatarrex/zzr",
        frames=[0, 2001, 1], cams=AVATARREX_CAMS,
        eval_train=[190, 7], eval_test=[354, 7],
        pose=dict(path="thuman4/pose_00.npz", frame_range=[2000, 2500]),
        view="free", view_idx=13, test_ckpt_batch=700000),
    "avatarrex_lbn1": dict(
        dataset="MvRgbDatasetAvatarReX", rel="avatarrex/lbn1",
        frames=[0, 1901, 1], cams=AVATARREX_CAMS,
        eval_train=[2, 0], eval_test=[481, 0],
        pose=dict(path="AMASS/CMU/10/10_05_poses.npz", frame_interval=4),
        view="moving", view_idx=18, fix_hand=True, fix_hand_id=55),
    "avatarrex_lbn2": dict(
        dataset="MvRgbDatasetAvatarReX", rel="avatarrex/lbn2",
        frames=[0, 1871, 1], cams=AVATARREX_CAMS,
        eval_train=[2, 0], eval_test=[481, 0],
        pose=dict(path="AMASS/MPI_mosh/00093/irish_dance_poses.npz",
                  frame_interval=4),
        view="front", view_idx=0, fix_hand=True, fix_hand_id=431),
    "subject00": dict(
        dataset="MvRgbDatasetTHuman4", rel="THuman4/subject00",
        frames=[0, 2000, 1], cams=THUMAN4_CAMS_23,
        eval_train=[310, 19], eval_test=[354, 1],
        pose=dict(path="thuman4/pose_00.npz", frame_range=[2000, 2500],
                  hand_pose_type="fist"),
        view="camera", view_idx=18),
    "subject01": dict(
        dataset="MvRgbDatasetTHuman4", rel="THuman4/subject01",
        frames=[0, 2500, 1], cams=THUMAN4_CAMS_23,
        eval_train=[542, 15], eval_test=[542, 18],
        pose=dict(path="thuman4/pose_00.npz", frame_range=[2000, 2500],
                  hand_pose_type="fist"),
        view="free", view_idx=6, global_orient=False),
    "subject02": dict(
        dataset="MvRgbDatasetTHuman4", rel="THuman4/subject02",
        frames=[385, 2500, 1], cams=list(range(24)),
        eval_train=[86, 0], eval_test=[288, 2],
        pose=dict(path="thuman4/pose_01.npz", frame_range=[0, 1000],
                  hand_pose_type="fist"),
        view="free", view_idx=0),
    "actor01": dict(
        dataset="MvRgbDatasetActorsHQ", rel="ActorsHQ/Actor01/Sequence1",
        frames=[48, 2177, 1],
        cams=[c for c in ACTORSHQ_CAMS if c != 127],
        eval_train=[481, 4], eval_test=[710, 126],
        pose=dict(path="AMASS/CMU/131/131_03_poses.npz", frame_interval=4),
        view="moving", view_idx=18),
    "actor02": dict(
        dataset="MvRgbDatasetActorsHQ", rel="ActorsHQ/Actor02/Sequence1",
        frames=[60, 2157, 1], cams=ACTORSHQ_CAMS,
        eval_train=[562, 4], eval_test=[562, 37],
        pose=dict(path="thuman4/pose_00.npz", frame_range=[2000, 2500]),
        view="free", view_idx=13, fix_hand=True, fix_hand_id=60),
    "actor04": dict(
        dataset="MvRgbDatasetActorsHQ", rel="ActorsHQ/Actor04/Sequence1",
        frames=[77, 1378, 1], cams=ACTORSHQ_CAMS,
        eval_train=[256, 126], eval_test=[612, 126],
        pose=dict(path="AMASS/MPI_mosh/00093/irish_dance_poses.npz",
                  frame_interval=4),
        view="front", view_idx=77),
    "actor05": dict(
        dataset="MvRgbDatasetActorsHQ", rel="ActorsHQ/Actor05/Sequence1",
        frames=[100, 1086, 1], cams=ACTORSHQ_CAMS,
        eval_train=[614, 127], eval_test=[663, 127],
        pose=dict(path="AMASS/MPI_mosh/00093/irish_dance_poses.npz",
                  frame_interval=4),
        view="front", view_idx=126),
    "actor06": dict(
        dataset="MvRgbDatasetActorsHQ", rel="ActorsHQ/Actor06/Sequence1",
        frames="frame_ids.txt", cams=ACTORSHQ_CAMS,
        eval_train=[714, 126], eval_test=[854, 38],
        pose=dict(path="AMASS/MPI_mosh/00059/misc_poses.npz",
                  frame_interval=4),
        view="front", view_idx=126, fix_hand=True, fix_hand_id=280),
    "actor07": dict(
        dataset="MvRgbDatasetActorsHQ", rel="ActorsHQ/Actor07/Sequence1",
        frames=[205, 2139, 1], cams=ACTORSHQ_CAMS,
        eval_train=[397, 76], eval_test=[672, 76],
        pose=dict(path="AMASS/CMU/06/06_13_poses.npz", frame_interval=4),
        view="moving", view_idx=0),
    "actor08": dict(
        dataset="MvRgbDatasetActorsHQ", rel="ActorsHQ/Actor08/Sequence1",
        frames=[63, 2374, 1], cams=ACTORSHQ_CAMS,
        eval_train=[710, 127], eval_test=[1459, 127],
        pose=dict(path="AMASS/MPI_mosh/00059/misc_poses.npz",
                  frame_interval=4),
        view="front", view_idx=0,
        loss_weight=dict(l1=1.0, ssim=0.2, lpips=1.0, gan=0.0, offset=0.0)),
}


def avatar_config(name: str, s: dict, data_root: str, pose_root: str) -> dict:
    data_dir = os.path.join(data_root, s["rel"])
    pose = dict(s["pose"])
    pose_data = dict(data_path=os.path.join(pose_root, pose.pop("path")),
                     **pose)
    ckpt = s.get("test_ckpt_batch", 800000)
    return dict(
        mode="train",
        train=dict(
            dataset=s["dataset"],
            data=dict(subject_name=name, data_dir=data_dir,
                      frame_range=list(s["frames"])
                      if not isinstance(s["frames"], str) else s["frames"],
                      used_cam_ids=list(s["cams"]),
                      load_smpl_pos_map=True),
            pretrained_dir=None,
            net_ckpt_dir=f"./results/{name}/avatar",
            prev_ckpt=None,
            ckpt_interval=dict(epoch=10, batch=50000),
            eval_interval=1000,
            eval_training_ids=list(s["eval_train"]),
            eval_testing_ids=list(s["eval_test"]),
            eval_img_factor=1.0,
            lr_init=0.0005,
            loss_weight=dict(s.get("loss_weight",
                                   dict(l1=1.0, lpips=0.1, offset=0.005))),
            finetune_color=False,
            batch_size=1,
            num_workers=8,
            random_bg_color=True,
        ),
        test=dict(
            dataset=s["dataset"],
            data=dict(data_dir=data_dir,
                      frame_range=list(s["frames"])[:2]
                      if not isinstance(s["frames"], str) else s["frames"],
                      subject_name=name),
            pose_data=pose_data,
            view_setting=s.get("view", "free"),
            render_view_idx=s.get("view_idx", 0),
            global_orient=s.get("global_orient", True),
            img_scale=1.0,
            save_mesh=False,
            render_skeleton=False,
            save_tex_map=False,
            save_ply=False,
            fix_hand=s.get("fix_hand", False),
            fix_hand_id=s.get("fix_hand_id", 0),
            n_pca=20,
            sigma_pca=2.0,
            prev_ckpt=f"./results/{name}/avatar/batch_{ckpt}",
        ),
        model=dict(with_viewdirs=True, random_style=False),
    )


def template_config(name: str, s: dict, data_root: str) -> dict:
    data_dir = os.path.join(data_root, s["rel"])
    return dict(
        mode="train",
        train=dict(
            dataset=s["dataset"],
            data=dict(subject_name=name, data_dir=data_dir,
                      frame_range=[0, 1, 1],
                      used_cam_ids=list(s["cams"]), mode="nerf"),
            net_ckpt_dir=f"./results/{name}/template",
            prev_ckpt=None,
            save_init_ckpt=False,
            start_epoch=0,
            end_epoch=1001,
            ckpt_interval=dict(epoch=500, batch=1000),
            eval_interval=10000,
            depth_guided_sampling=dict(flag=False, near_sur_dist=0.05,
                                       N_ray_samples=32),
            compute_grad=True,
            lr=dict(network=dict(type="Step", initial=0.0005,
                                 interval=40000, factor=0.9, min=8.0e-05)),
            loss_weight=dict(color=1.0, mask=1.0, eikonal=0.1),
            batch_size=1,
            num_workers=0,
        ),
        model=dict(with_hand=True, volume_type="diff",
                   use_root_finding=True, multires=6, use_viewdir=False,
                   multires_viewdir=3),
    )


def main(argv=None):
    """Write every subject's configs; ``argv`` defaults to the command
    line."""
    from argparse import ArgumentParser
    ap = ArgumentParser()
    ap.add_argument("--out_dir", default="configs")
    ap.add_argument("--data_root", default="/data/MultiviewRGB")
    ap.add_argument("--pose_root", default="/data/Pose")
    args = ap.parse_args(argv)

    for name, s in SUBJECTS.items():
        d = os.path.join(args.out_dir, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "avatar.yaml"), "w") as fp:
            yaml.dump(avatar_config(name, s, args.data_root, args.pose_root),
                      fp, sort_keys=False)
        with open(os.path.join(d, "template.yaml"), "w") as fp:
            yaml.dump(template_config(name, s, args.data_root), fp,
                      sort_keys=False)
    print(f"# Wrote configs for {len(SUBJECTS)} subjects to {args.out_dir}")


if __name__ == "__main__":
    main()
