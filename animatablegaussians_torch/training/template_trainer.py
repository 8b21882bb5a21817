"""Template (SDF-NeRF) training: the ray-batch step and the geometry
export. A port of ``animatablegaussians_tpu/training/template_trainer.py``
(ref: main_template.py:18-144): colour L1 + mask L1 + eikonal losses on
random rays; Adam with the config's LR schedule; the SDF on a grid in
chunks, marching cubes and ``template.ply``.

Adam has optax's settings (b1 0.9, b2 0.999, eps 1e-8 outside the square
root); with ``finetune_hand`` only ``left_hand`` and ``right_hand`` are in
the optimizer, so nothing else moves, as optax's ``set_to_zero`` (ref:
main_template.py:83-87).

A step's spans (``utils/profiling.span``): ``template.step`` around it,
``losses`` around the loss terms, ``backward`` around ``total.backward()``
and ``adam`` around the optimizer's and the schedule's step, the names the
avatar trainer uses; ``template.near_far`` around the depth-guided
near/far as around the SMPL-guided one.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from animatablegaussians_torch.training.lr_schedule import \
    get_learning_rate_schedule
from animatablegaussians_torch.utils.profiling import span

HAND_GROUPS = ("left_hand.", "right_hand.")


def make_template_optimizer(net, lr_cfg: dict, finetune_hand: bool = False):
    """-> (Adam, LambdaLR); the first update takes the schedule at 0."""
    params = [p for n, p in net.named_parameters()
              if not finetune_hand or n.startswith(HAND_GROUPS)]
    optimizer = torch.optim.Adam(params, lr=1.0, betas=(0.9, 0.999),
                                 eps=1e-8)
    # lr 1.0 times the schedule: update k takes the schedule at k
    return optimizer, torch.optim.lr_scheduler.LambdaLR(
        optimizer, get_learning_rate_schedule(**lr_cfg))


class TemplateStep:
    """``step(items, generator=None, draws=None) -> terms``: one Adam
    update on one ray batch. ``items`` holds the rays (``ray_o``,
    ``ray_d``, ``near``, ``far``, ``dist``, ``color_gt``, ``mask_gt``) and
    the model's items, tensors on the net's device.

    Near/far follow the reference's ``depth_guided_sampling`` (ref:
    network/template.py:294-316): from the depth where ``flag`` is set and
    ``dist`` > 0, else from the SMPL spheres (``smpl_guided``), else the
    AABB's."""

    def __init__(self, net, optimizer, scheduler, *, loss_weight: dict,
                 n_samples: int = 64, smpl_guided: bool = True,
                 depth_guided: Optional[dict] = None):
        dg = depth_guided or {}
        self.net, self.optimizer, self.scheduler = net, optimizer, scheduler
        self.loss_weight = dict(loss_weight)
        self.n_samples = n_samples
        self.smpl_guided = smpl_guided
        self.near_dist = float(dg.get("near_sur_dist", 0.05))
        self.n_dg_samples = int(dg.get("N_ray_samples", n_samples))
        self.use_depth = bool(dg.get("flag", False))

    def loss(self, items, generator=None, draws=None):
        """-> (total loss, terms): the forward of one step."""
        net, lw = self.net, self.loss_weight
        ray_o, ray_d = items["ray_o"], items["ray_d"]
        near, far = items["near"], items["far"]
        if self.use_depth:
            with span("template.near_far"):
                valid = items["dist"] > 1e-6
                near = torch.where(valid, items["dist"] - self.near_dist,
                                   near)
                far = torch.where(valid, items["dist"] + self.near_dist,
                                  far)
            ns = self.n_dg_samples
        else:
            if self.smpl_guided:
                near, far = net.smpl_guided_near_far(items, ray_o, ray_d,
                                                     near, far)
            ns = self.n_samples
        out = net.render_rays(items, ray_o, ray_d, near, far, n_samples=ns,
                              training=True, generator=generator,
                              draws=draws)
        with span("losses"):
            terms = {}
            cl = torch.abs(out["rgb_map"] - items["color_gt"]).mean()
            total = lw.get("color", 1.0) * cl
            terms["color_loss_random"] = cl
            ml = torch.abs(out["acc_map"] - items["mask_gt"]).mean()
            total = total + lw.get("mask", 0.0) * ml
            terms["mask_loss_random"] = ml
            if "normal" in out and lw.get("eikonal", 0.0) > 0:
                el = ((torch.linalg.norm(out["normal"], dim=-1) - 1.0)
                      ** 2).mean()
                total = total + lw["eikonal"] * el
                terms["eikonal_loss"] = el
            terms["total_loss"] = total
        return total, terms

    def __call__(self, items, generator=None, draws=None) -> dict:
        with span("template.step"):
            self.optimizer.zero_grad(set_to_none=True)
            total, terms = self.loss(items, generator, draws)
            with span("backward"):
                total.backward()
            with span("adam"):
                self.optimizer.step()
                self.scheduler.step()
            return {k: v.detach() for k, v in terms.items()}


# the dataset item's keys a template step reads besides the rays
MODEL_KEYS = ("cano2live_jnt_mats", "live_smpl_v", "smpl_faces",
              "cano_smpl_center")
MANO_KEYS = tuple(f"{side}_{space}_mano_{a}" for side in ("left", "right")
                  for space in ("cano", "live") for a in ("v", "n")) + (
                      "mano_face_closed",)
RAY_KEYS = ("ray_o", "ray_d", "near", "far", "dist", "color_gt", "mask_gt")


def template_items(item: dict, smpl_lbs, device) -> dict:
    """A nerf-mode dataset item -> the step's items on ``device``: its
    rays, its model keys, ``smpl_lbs`` and, when the dataset has the MANO
    maps, every MANO key (the JAX CLI leaves these out, so its
    ``with_hand`` step fails; ``main_template.py:65-71``)."""
    def t(a):
        a = np.asarray(a)
        dtype = torch.int64 if a.dtype.kind in "iu" else torch.float32
        return torch.as_tensor(a, dtype=dtype, device=device)

    items = {k: t(item["nerf_random"][k]) for k in RAY_KEYS}
    items.update({k: t(item[k]) for k in MODEL_KEYS + MANO_KEYS
                  if k in item})
    items["smpl_lbs"] = torch.as_tensor(smpl_lbs, dtype=torch.float32,
                                        device=device)
    return items


def save_checkpoint(ckpt_dir: str, net, optimizer, scheduler,
                    iter_idx: int) -> None:
    """``net.pt`` = {"iter_idx", "template_net": state_dict} and
    ``optm.pt`` = {"template_net": Adam state_dict, "lr_scheduler":
    LambdaLR state_dict}."""
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.save({"iter_idx": int(iter_idx),
                "template_net": net.state_dict()},
               os.path.join(ckpt_dir, "net.pt"))
    torch.save({"template_net": optimizer.state_dict(),
                "lr_scheduler": scheduler.state_dict()},
               os.path.join(ckpt_dir, "optm.pt"))


# ---------------------------------------------------------------------------
# geometry export (ref: main_template.py:103-133)
# ---------------------------------------------------------------------------

def generate_volume_points(bounds: np.ndarray, res) -> np.ndarray:
    """A dense grid of points in ``bounds`` (ref: utils/net_util.py:48-63)."""
    rx, ry, rz = res
    xs = np.linspace(bounds[0, 0], bounds[1, 0], rx)
    ys = np.linspace(bounds[0, 1], bounds[1, 1], ry)
    zs = np.linspace(bounds[0, 2], bounds[1, 2], rz)
    g = np.meshgrid(xs, ys, zs, indexing="ij")
    return np.stack(g, -1).reshape(-1, 3).astype(np.float32)


@torch.no_grad()
def test_geometry(net, items, space: str = "cano",
                  testing_res=(256, 256, 128), chunk: int = 256 * 256,
                  timings: Optional[dict] = None):
    """The SDF on a ``testing_res`` grid over the canonical (or live)
    bounds, in chunks of ``chunk`` points on the net's device, then
    marching cubes and Sobel normals on the host -> (verts, faces,
    normals). ``timings``, when given, receives ``sdf_s`` and
    ``mcubes_s``."""
    from animatablegaussians_torch.utils.recon import (
        compute_sobel_normals, extract_mesh_from_sdf)

    t0 = time.perf_counter()
    dev = next(net.parameters()).device
    bounds = np.asarray(items["live_bounds" if space == "live"
                              else "cano_bounds"])
    if torch.is_tensor(bounds):
        bounds = bounds.cpu().numpy()
    pts = torch.as_tensor(generate_volume_points(bounds, testing_res),
                          device=dev)
    sdfs = []
    for s in range(0, pts.shape[0], chunk):
        p = pts[s:s + chunk]
        if space == "live":
            p, _ = net.transform_live2cano(p, items, near_thres=0.1)
        sdfs.append(net.forward_cano_body_nerf(p, None)["sdf"][:, 0])
    sdf = torch.cat(sdfs).cpu().numpy().reshape(testing_res)
    t1 = time.perf_counter()

    # the net's sdf is inside-positive (ref: template.py:110); marching
    # cubes takes inside < level, so negate
    verts, faces = extract_mesh_from_sdf(-sdf, bounds, level=0.0)
    ii = np.clip(((verts - bounds[0]) / (bounds[1] - bounds[0])
                  * (np.asarray(testing_res) - 1)).astype(int), 0,
                 np.asarray(testing_res) - 1)
    normals = compute_sobel_normals(-sdf)[ii[:, 0], ii[:, 1], ii[:, 2]]
    if timings is not None:
        timings.update(sdf_s=t1 - t0, mcubes_s=time.perf_counter() - t1)
    return verts, faces, normals


def save_mesh_as_ply(path: str, vertices, faces, normals=None):
    """(ref: utils/obj_io.py save_mesh_as_ply)."""
    from animatablegaussians_torch.utils.ply import write_ply
    props = dict(x=vertices[:, 0], y=vertices[:, 1], z=vertices[:, 2])
    if normals is not None:
        props.update(nx=normals[:, 0], ny=normals[:, 1], nz=normals[:, 2])
    write_ply(path, props, faces=np.asarray(faces, np.int32))
