"""Avatar training, one example per step: the pretrain step and the
main-phase train step.

Port of ``animatablegaussians_tpu/training/avatar_trainer.py:41-200,380-424``
(ref: main_avatar.py:37-264):

  * ``make_optimizer``: Adam with a cosine learning rate and a 5% floor
    over ``iter_num`` steps; ``finetune_color`` freezes the position net;
  * the pretrain step regresses the position and other heads onto the
    static canonical Gaussians with a masked L1;
  * the main step renders under autograd (the splat's backward is the CUDA
    kernel ``csrc/blend_bwd.cu`` on a GPU) and takes L1, mask, SSIM,
    LPIPS on a crop, and offset losses on a random background.

The step's random numbers are injected, never drawn inside: ``draws`` holds
``bg`` (3,), ``viewdir_noise`` (N, 3) and ``crop`` (fv, fu) or None, made
by ``make_draws`` from a ``torch.Generator`` in production and by a test
from the JAX package's own key splits. The module, the optimizer, its
schedule and the step count live in a ``TrainState``, which the steps
update in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from animatablegaussians_torch.training import losses as L


@dataclasses.dataclass
class TrainState:
    net: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    iter_idx: int = 0


def cosine_lr(lr_init: float, iter_num: int, alpha: float = 0.05):
    """lr(t) = lr_init ((cos(pi t / T) + 1) / 2 (1 - alpha) + alpha)
    (ref: main_avatar.py:61-68)."""
    def sched(step: int) -> float:
        progress = min(step / iter_num, 1.0)
        return lr_init * ((math.cos(math.pi * progress) + 1.0) * 0.5
                          * (1 - alpha) + alpha)
    return sched


def make_optimizer(net, lr_init: float = 5e-4, iter_num: int = 800_000,
                   finetune_color: bool = False):
    """-> (optimizer, scheduler): Adam (betas 0.9/0.999, eps 1e-8 outside
    the square root, as optax's ``adam``) on every parameter of ``net``,
    with the cosine schedule; stepping the scheduler after the optimizer
    makes the first update use lr(0), as optax does. ``finetune_color``
    leaves the position net out of the optimizer, so neither its weights
    nor any moments move, as optax's ``set_to_zero`` (ref:
    main_avatar.py:190-196)."""
    params = [p for name, p in net.named_parameters()
              if not (finetune_color and name.startswith("position_net."))]
    optimizer = torch.optim.Adam(params, lr=lr_init, betas=(0.9, 0.999),
                                 eps=1e-8)
    sched = cosine_lr(lr_init, iter_num)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: sched(step) / lr_init)
    return optimizer, scheduler


def make_train_state(net, lr_init: float = 5e-4, iter_num: int = 800_000,
                     finetune_color: bool = False) -> TrainState:
    """A fresh ``TrainState`` for ``net`` with ``make_optimizer``'s Adam."""
    return TrainState(net, *make_optimizer(net, lr_init, iter_num,
                                           finetune_color))


def _apply(state: TrainState) -> None:
    state.optimizer.step()
    state.scheduler.step()
    state.iter_idx += 1


def make_draws(generator: torch.Generator, n_points: int) -> dict:
    """One step's random numbers from ``generator``, on its device."""
    dev = generator.device
    return dict(
        bg=torch.rand(3, generator=generator, device=dev),
        viewdir_noise=torch.randn((n_points, 3), generator=generator,
                                  device=dev),
        crop=tuple(torch.rand(2, generator=generator, device=dev).tolist()))


# ---------------------------------------------------------------------------
# Pretrain phase (ref: main_avatar.py:126-164)
# ---------------------------------------------------------------------------

def make_pretrain_step(net):
    """``step(state, pose_map) -> (state, terms)``: one Adam update of the
    masked L1 between the heads' Gaussians and the canonical ones."""
    # block-packing pad points carry garbage CNN texels; the targets only
    # exist at real masked texels
    vm = net.valid_f[:, None]
    inv_n = 1.0 / float(net.n_valid)

    def masked_l1(a, b):
        return (torch.abs(a - b.detach()) * vm).sum() * (inv_n / a.shape[-1])

    def step(state: TrainState, pose_map):
        net.zero_grad(set_to_none=True)
        g = net.cano_gaussian
        positions = net.get_positions(pose_map)
        opacity, scales, rotations = net.get_others(pose_map)
        lp = masked_l1(positions, g.xyz)
        lo = masked_l1(opacity, g.get_opacity)
        ls = masked_l1(scales, g.get_scaling)
        lr_ = masked_l1(rotations, g.get_rotation)
        total = lp + lo + ls + lr_
        total.backward()
        _apply(state)
        terms = dict(position=lp, opacity=lo, scale=ls, rotation=lr_,
                     total_loss=total)
        return state, {k: v.detach() for k, v in terms.items()}

    return step


# ---------------------------------------------------------------------------
# Main phase (ref: main_avatar.py:166-264)
# ---------------------------------------------------------------------------

def compute_losses(net, items: dict, draws: dict, iter_idx: int, *,
                   loss_weight: dict, lpips=None, random_bg_color: bool = True,
                   patch_size: int = 512, random_patch_after: int = 300_000,
                   img_w: Optional[int] = None, img_h: Optional[int] = None,
                   plain: bool = False):
    """One example's total loss and its terms, under autograd. ``lpips`` is
    a ``training.lpips.LPIPS`` module, needed when its weight is > 0."""
    dev = net.lbs.device
    bg = (draws["bg"] if random_bg_color
          else torch.ones(3, dtype=torch.float32, device=dev))
    out = net.render(items, bg_color=bg, img_w=img_w, img_h=img_h,
                     training=True, draws=draws, plain=plain)
    image = out["rgb_map"]                                    # (H, W, 3)

    mask = items["mask_img"].to(torch.float32)               # (H, W)
    # the boundary band is left out of every pixel loss
    # (ref: main_avatar.py:185-189)
    bnd = 1.0 - items["boundary_mask_img"].to(torch.float32)
    gt = torch.where(mask[..., None] > 0.5, items["color_img"],
                     bg[None, None, :])
    image = image * bnd[..., None] + (1.0 - bnd[..., None]) * bg
    gt = gt * bnd[..., None] + (1.0 - bnd[..., None]) * bg

    total = 0.0
    terms = {}
    w_l1 = float(loss_weight.get("l1", 0.0))
    if w_l1 > 0:
        l1 = torch.abs(image - gt).mean()
        total = total + w_l1 * l1
        terms["l1_loss"] = l1
    w_mask = float(loss_weight.get("mask", 0.0))
    if w_mask > 0:
        ml = torch.abs(out["mask_map"] * bnd - mask * bnd).mean()
        total = total + w_mask * ml
        terms["mask_loss"] = ml
    w_ssim = float(loss_weight.get("ssim", 0.0))
    if w_ssim > 0:
        sl = L.ssim_loss(image, gt)
        total = total + w_ssim * sl
        terms["ssim_loss"] = sl
    w_lp = float(loss_weight.get("lpips", 0.0))
    if w_lp > 0:
        if lpips is None:
            # never skip silently: without the perceptual term the model
            # trains differently (ref: main_avatar.py:229-236)
            raise RuntimeError("loss_weight.lpips > 0 but no LPIPS module")
        crop = None
        if iter_idx >= random_patch_after:
            crop = draws["crop"]
            if crop is None:
                raise ValueError("the random LPIPS crop needs draws['crop']")
        img_c, gt_c = L.crop_to_mask([image, gt], mask, patch_size,
                                     crop=crop)
        lp = lpips(img_c[None], gt_c[None], normalize=True).mean()
        total = total + w_lp * lp
        terms["lpips_loss"] = lp
    # the offset penalty is always on (ref: main_avatar.py:238-241)
    ol = L.offset_loss(out["offset"])
    total = total + float(loss_weight.get("offset", 0.0)) * ol
    terms["offset_loss"] = ol
    terms["total_loss"] = total
    return total, terms


def make_train_step(net, *, loss_weight: dict, lpips=None,
                    random_bg_color: bool = True, patch_size: int = 512,
                    random_patch_after: int = 300_000,
                    img_w: Optional[int] = None, img_h: Optional[int] = None,
                    plain: bool = False):
    """``step(state, items, draws) -> (state, terms)``: one Adam update on
    one example. ``step.loss_and_grads(state, items, draws) -> terms``
    leaves the gradients in the parameters' ``.grad`` without updating.
    ``plain=True`` runs the splat's plain versions (the reference the
    kernels are checked against on the GPU).

    The JAX step discards an update whose static binning caps dropped
    pairs (avatar_trainer.py:409-419); here binning is sized per frame from
    the exact pair count, nothing is ever dropped, and there is no
    ``n_overflow`` to check."""

    def loss_and_grads(state: TrainState, items: dict, draws: dict) -> dict:
        net.zero_grad(set_to_none=True)
        total, terms = compute_losses(
            net, items, draws, state.iter_idx, loss_weight=loss_weight,
            lpips=lpips, random_bg_color=random_bg_color,
            patch_size=patch_size, random_patch_after=random_patch_after,
            img_w=img_w, img_h=img_h, plain=plain)
        total.backward()
        return {k: v.detach() for k, v in terms.items()}

    def step(state: TrainState, items: dict, draws: dict):
        terms = loss_and_grads(state, items, draws)
        _apply(state)
        return state, terms

    step.loss_and_grads = loss_and_grads
    return step
