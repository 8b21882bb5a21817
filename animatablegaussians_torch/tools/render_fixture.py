"""Full-width synthetic render and train fixture for the port.

Rebuilds the JAX bench fixture (``bench.py:50-116``) with the port: a
1024x2048 canonical map (517,832 masked texels, block-packed to 531,520
Gaussians), three DualStyleUNet heads 512^2 -> 1024^2 at channel_max 512,
view-direction conditioning on, 1500x2048 images, random weights from a
seed, and the position/other heads' ToRGB weights zeroed so the Gaussians
keep their ``create_from_pcd`` attributes (``bench.py::_zero_head_outputs``).
A sequence of F frames jitters the camera per frame (``bench.py:265-276``);
the same stack of a train frame is the B-frame batch of the batched train
step. ``HAND_KEYS`` add stand-ins for the MANO items of the ``test.fix_hand``
configs (``hand_items``), which the mean-hand render reads.
The train fixture adds the frame's colour image, mask and boundary mask,
and the constants below hold the JAX train bench's settings
(``bench.py:119-142``): Adam at 5e-4 on an 800k-step cosine schedule, L1 +
0.1 LPIPS on a 512 crop + 0.005 offset, a random background, and LPIPS
weights drawn at random from seed 7 (no LPIPS weight files are in the
repository). ``chip_smoke.py`` renders, trains and times this fixture on
the GPU.
"""

from __future__ import annotations

import numpy as np
import torch

from animatablegaussians_torch.models.avatar import AvatarNet
from animatablegaussians_torch.utils import synthetic

MAP_H = 1024                # canonical map 1024x2048 -> CNN in 512^2, out 1024^2
IMG_W, IMG_H = 1500, 2048   # AvatarReX camera resolution
RENDER_KEYS = ("smpl_pos_map", "cano2live_jnt_mats", "extr", "intr")
TRAIN_KEYS = RENDER_KEYS + ("color_img", "mask_img", "boundary_mask_img")
HAND_KEYS = ("left_cano_mano_v", "right_cano_mano_v", "cano_smpl_center",
             "cano2live_jnt_mats_woRoot")
MANO_VERTS = 778            # vertices of one MANO hand
LR_INIT, ITER_NUM = 5e-4, 800_000
LOSS_WEIGHT = dict(l1=1.0, lpips=0.1, offset=0.005)
PATCH_SIZE = 512
LPIPS_SEED = 7


@torch.no_grad()
def zero_head_outputs(net: AvatarNet, names=("position_net", "other_net")):
    """Zero the ToRGB conv weights of the given heads: their outputs become
    exactly 0 while their conv work is unchanged."""
    for name in names:
        head = getattr(net, name)
        for rgb in list(head.to_rgbs1) + list(head.to_rgbs2):
            rgb.conv.weight.zero_()


def hand_items(cano_pos_map: np.ndarray, n_verts: int = MANO_VERTS) -> dict:
    """Stand-ins for a subject's canonical MANO hands, from the canonical
    points (the masked texels): the ``n_verts`` points of largest x as the
    left hand, of smallest x as the right, and the points' bounding-box
    centre as ``cano_smpl_center``."""
    pts = cano_pos_map[np.linalg.norm(cano_pos_map, axis=-1) > 0.0]
    order = np.argsort(pts[:, 0], kind="stable")
    return dict(left_cano_mano_v=pts[order[-n_verts:]],
                right_cano_mano_v=pts[order[:n_verts]],
                cano_smpl_center=0.5 * (pts.min(0) + pts.max(0)))


def build(device, map_h: int = MAP_H, img_w: int = IMG_W,
          img_h: int = IMG_H, channel_max: int = 512, seed: int = 0,
          keys=RENDER_KEYS):
    """-> (net, items): the AvatarNet and one frame's ``keys`` (the render
    inputs; ``TRAIN_KEYS`` for a train step, ``HAND_KEYS`` for the mean
    hands), as tensors on ``device``."""
    pos, nml, lbs = synthetic.make_cano_map(map_h=map_h)
    net = AvatarNet({"with_viewdirs": True, "channel_max": channel_max},
                    pos, lbs, cano_nml_map=nml, device=device, seed=seed)
    zero_head_outputs(net)
    items_np = synthetic.make_items(img_w=img_w, img_h=img_h,
                                    cano_pos_map=pos)
    items_np.update(hand_items(pos))
    items = {k: torch.as_tensor(items_np[k], device=device)
             for k in keys}
    return net, items


def sequence(items: dict, frames: int, seed: int = 0) -> dict:
    """F copies of one frame's items with the camera translation jittered
    per frame (0.01 x N(0, 1) from ``np.random.RandomState(seed)``)."""
    rng = np.random.RandomState(seed)
    seq = {k: v[None].repeat((frames,) + (1,) * v.dim())
           for k, v in items.items()}
    jitter = torch.as_tensor(0.01 * rng.randn(frames, 3), dtype=torch.float32,
                             device=seq["extr"].device)
    seq["extr"][:, :3, 3] += jitter
    return seq

