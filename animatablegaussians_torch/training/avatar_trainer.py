"""Avatar training: the pretrain step, the main-phase train step on one
example or on a batch of B, and the multi-step train scans.

Port of ``animatablegaussians_tpu/training/avatar_trainer.py`` (ref:
main_avatar.py:37-264):

  * ``make_optimizer``: Adam with a cosine learning rate and a 5% floor
    over ``iter_num`` steps; ``finetune_color`` freezes the position net;
  * the pretrain step regresses the position and other heads onto the
    static canonical Gaussians with a masked L1;
  * the main step renders under autograd (the splat's backward is the CUDA
    kernel ``csrc/blend_bwd.cu`` on a GPU) and takes L1, mask, SSIM,
    LPIPS on a crop, and offset losses on a random background;
  * the batched step runs the three heads once on the B pose maps (forward
    and backward), splats each item, takes LPIPS once on the B stacked
    crops, and makes one Adam update on the mean over B;
  * the train scans run n steps in a host loop and stack their terms.

The step's random numbers are injected, never drawn inside: ``draws`` holds
``bg`` (3,), ``viewdir_noise`` (N, 3), ``crop`` (fv, fu) or None and, for a
net with ``random_style``, ``style`` (1, 512), made by ``make_draws`` from a
``torch.Generator`` in production and by a test from the JAX package's own
key splits; the batched step takes one such dict per item and refuses
``random_style``, whose per-item colour styles would break the heads'
shared-weight batching (as JAX avatar_trainer.py:226-229). The module,
the optimizer, its schedule and the step count live in a ``TrainState``,
which the steps update in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from animatablegaussians_torch.training import losses as L
from animatablegaussians_torch.utils.profiling import span


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


@span("adam")
def apply_update(state: TrainState) -> None:
    """One Adam update from the gradients in ``.grad``, then the schedule
    and the step count."""
    state.optimizer.step()
    state.scheduler.step()
    state.iter_idx += 1


def make_draws(generator: torch.Generator, n_points: int,
               style_dim: int = 0) -> dict:
    """One step's random numbers from ``generator``, on its device; with
    ``style_dim`` > 0 (a net with ``random_style``: ``draws_style_dim``)
    also a U[0, 1) colour style (1, style_dim), drawn after the others, so
    that the rest are the same numbers either way."""
    dev = generator.device
    draws = dict(
        bg=torch.rand(3, generator=generator, device=dev),
        viewdir_noise=torch.randn((n_points, 3), generator=generator,
                                  device=dev),
        crop=tuple(torch.rand(2, generator=generator, device=dev).tolist()))
    if style_dim:
        draws["style"] = torch.rand((1, style_dim), generator=generator,
                                    device=dev)
    return draws


def draws_style_dim(net) -> int:
    """``make_draws``' ``style_dim`` for ``net``: its style width with
    ``random_style``, else 0."""
    return net.style_dim if getattr(net, "random_style", False) else 0


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
        apply_update(state)
        terms = dict(position=lp, opacity=lo, scale=ls, rotation=lr_,
                     total_loss=total)
        return state, {k: v.detach() for k, v in terms.items()}

    return step


# ---------------------------------------------------------------------------
# Main phase (ref: main_avatar.py:166-264)
# ---------------------------------------------------------------------------

def _loss_weights(loss_weight: dict, lpips) -> dict:
    w = {k: float(loss_weight.get(k, 0.0))
         for k in ("l1", "mask", "ssim", "lpips", "offset")}
    if w["lpips"] > 0 and lpips is None:
        # never skip silently: without the perceptual term the model
        # trains differently (ref: main_avatar.py:229-236)
        raise RuntimeError("loss_weight.lpips > 0 but no LPIPS module")
    return w


@span("losses")
def _item_terms(out: dict, items: dict, bg, draws: dict, iter_idx: int,
                w: dict, patch_size: int, random_patch_after: int):
    """One rendered example's pixel and offset loss terms, and its
    (image, target) LPIPS crop (None when LPIPS is off)."""
    image = out["rgb_map"]                                    # (H, W, 3)
    mask = items["mask_img"].to(torch.float32)               # (H, W)
    # the boundary band is left out of every pixel loss
    # (ref: main_avatar.py:185-189)
    bnd = 1.0 - items["boundary_mask_img"].to(torch.float32)
    gt = torch.where(mask[..., None] > 0.5, items["color_img"],
                     bg[None, None, :])
    image = image * bnd[..., None] + (1.0 - bnd[..., None]) * bg
    gt = gt * bnd[..., None] + (1.0 - bnd[..., None]) * bg
    terms = {}
    if w["l1"] > 0:
        terms["l1_loss"] = torch.abs(image - gt).mean()
    if w["mask"] > 0:
        terms["mask_loss"] = torch.abs(out["mask_map"] * bnd
                                       - mask * bnd).mean()
    if w["ssim"] > 0:
        terms["ssim_loss"] = L.ssim_loss(image, gt)
    # the offset penalty is always on (ref: main_avatar.py:238-241)
    terms["offset_loss"] = L.offset_loss(out["offset"])
    crop = None
    if w["lpips"] > 0:
        window = None
        if iter_idx >= random_patch_after:
            window = draws["crop"]
            if window is None:
                raise ValueError("the random LPIPS crop needs draws['crop']")
        crop = L.crop_to_mask([image, gt], mask, patch_size, crop=window)
    return terms, crop


@span("losses")
def _total(terms: dict, crops: list, w: dict, lpips):
    """The weighted total of the terms and of LPIPS, once on the stacked
    crops (contiguous, so one example and a batch of one run the same
    convolutions); adds lpips_loss and total_loss to ``terms``."""
    total = 0.0
    for key in ("l1", "mask", "ssim"):
        if w[key] > 0:
            total = total + w[key] * terms[f"{key}_loss"]
    if w["lpips"] > 0:
        lp = lpips(torch.stack([c[0] for c in crops]),
                   torch.stack([c[1] for c in crops]), normalize=True).mean()
        total = total + w["lpips"] * lp
        terms["lpips_loss"] = lp
    total = total + w["offset"] * terms["offset_loss"]
    terms["total_loss"] = total
    return total, terms


def compute_losses(net, items: dict, draws: dict, iter_idx: int, *,
                   loss_weight: dict, lpips=None, random_bg_color: bool = True,
                   patch_size: int = 512, random_patch_after: int = 300_000,
                   img_w: Optional[int] = None, img_h: Optional[int] = None,
                   plain: bool = False):
    """One example's total loss and its terms, under autograd. ``lpips`` is
    a ``training.lpips.LPIPS`` module, needed when its weight is > 0."""
    w = _loss_weights(loss_weight, lpips)
    bg = (draws["bg"] if random_bg_color
          else torch.ones(3, dtype=torch.float32, device=net.lbs.device))
    out = net.render(items, bg_color=bg, img_w=img_w, img_h=img_h,
                     training=True, draws=draws, plain=plain)
    terms, crop = _item_terms(out, items, bg, draws, iter_idx, w, patch_size,
                              random_patch_after)
    return _total(terms, [crop], w, lpips)


def make_train_step(net, *, loss_weight: dict, lpips=None,
                    random_bg_color: bool = True, patch_size: int = 512,
                    random_patch_after: int = 300_000,
                    img_w: Optional[int] = None, img_h: Optional[int] = None,
                    plain: bool = False):
    """``step(state, items, draws) -> (state, terms)``: one Adam update on
    one example. ``step.loss_and_grads(state, items, draws) -> terms``
    leaves the gradients in the parameters' ``.grad`` without updating.
    ``plain=True`` runs the kernels' plain versions, the CNN's FIRs and the
    splat (the reference the kernels are checked against on the GPU).

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
        with span("backward"):
            total.backward()
        return {k: v.detach() for k, v in terms.items()}

    def step(state: TrainState, items: dict, draws: dict):
        with span("train.step"):
            terms = loss_and_grads(state, items, draws)
            apply_update(state)
        return state, terms

    step.loss_and_grads = loss_and_grads
    return step


def _refuse_random_style(net) -> None:
    if getattr(net, "random_style", False):
        raise NotImplementedError(
            "random_style breaks the shared-weight head batching: use the "
            "batch-1 step")


def compute_losses_batched(net, batch: dict, draws: list, iter_idx: int, *,
                           loss_weight: dict, lpips=None,
                           random_bg_color: bool = True,
                           patch_size: int = 512,
                           random_patch_after: int = 300_000,
                           img_w: Optional[int] = None,
                           img_h: Optional[int] = None, plain: bool = False):
    """The mean loss over a batch of B examples and its mean terms, under
    autograd: every ``batch`` leaf has a leading (B,) axis, and item b uses
    ``draws[b]`` as ``compute_losses`` uses its draws, so B = 1 is
    ``compute_losses`` exactly. The constant style shares the modulated
    weights across items, so the three heads run as one batch-B conv stack;
    the select / skin / splat tail runs per item (binning sizes are per
    frame)."""
    _refuse_random_style(net)
    w = _loss_weights(loss_weight, lpips)
    dev = net.lbs.device
    n_items = len(draws)
    bgs = [d["bg"] if random_bg_color
           else torch.ones(3, dtype=torch.float32, device=dev) for d in draws]
    frames = [{k: v[b] for k, v in batch.items()} for b in range(n_items)]
    front_vd = back_vd = None
    if net.with_viewdirs:
        front_vd, back_vd = net._encode_viewdirs(torch.stack(
            [net._viewdir_half_map(it, d.get("viewdir_noise"))
             for it, d in zip(frames, draws)]))
    pos_out, other_out, color_out = net._head_outputs(
        batch["smpl_pos_map"][..., :3], front_vd, back_vd, plain)
    per_item, crops = [], []
    for b, (items, d, bg) in enumerate(zip(frames, draws, bgs)):
        out = net._finish_render(items, pos_out[b:b + 1],
                                 other_out[b:b + 1], color_out[b:b + 1], bg,
                                 img_w, img_h, full=False, plain=plain)
        terms, crop = _item_terms(out, items, bg, d, iter_idx, w,
                                  patch_size, random_patch_after)
        per_item.append(terms)
        crops.append(crop)
    terms = {k: torch.stack([t[k] for t in per_item]).mean()
             for k in per_item[0]}
    return _total(terms, crops, w, lpips)


def make_train_step_batched(net, *, loss_weight: dict, lpips=None,
                            random_bg_color: bool = True,
                            patch_size: int = 512,
                            random_patch_after: int = 300_000,
                            img_w: Optional[int] = None,
                            img_h: Optional[int] = None, plain: bool = False):
    """``step(state, batch, draws) -> (state, terms)``: one Adam update on
    the mean gradient over a batch of B examples (``draws`` one dict per
    item), the semantics of B data-parallel devices.
    ``step.loss_and_grads`` leaves the gradients in ``.grad`` without
    updating. As ``make_train_step``, nothing is dropped by binning, so
    there is no overflow to discard an update for. A net with
    ``random_style`` is refused."""
    _refuse_random_style(net)

    def loss_and_grads(state: TrainState, batch: dict, draws: list) -> dict:
        net.zero_grad(set_to_none=True)
        total, terms = compute_losses_batched(
            net, batch, draws, state.iter_idx, loss_weight=loss_weight,
            lpips=lpips, random_bg_color=random_bg_color,
            patch_size=patch_size, random_patch_after=random_patch_after,
            img_w=img_w, img_h=img_h, plain=plain)
        with span("backward"):
            total.backward()
        return {k: v.detach() for k, v in terms.items()}

    def step(state: TrainState, batch: dict, draws: list):
        with span("train.step"):
            terms = loss_and_grads(state, batch, draws)
            apply_update(state)
        return state, terms

    step.loss_and_grads = loss_and_grads
    return step


def _stack_terms(terms_seq: list) -> dict:
    return {k: torch.stack([t[k] for t in terms_seq]) for k in terms_seq[0]}


def make_train_scan(step_fn):
    """``multi(state, items, draws_seq) -> (state, terms)``: the steps of
    ``step_fn`` (a ``make_train_step`` or ``make_train_step_batched``
    step) on the same example for each entry of ``draws_seq``, terms
    stacked along a leading (n,) axis. On the GPU this is the host loop
    that ``jax.lax.scan`` compiles into one program on the TPU."""
    def multi(state: TrainState, items: dict, draws_seq: list):
        out = []
        for draws in draws_seq:
            state, terms = step_fn(state, items, draws)
            out.append(terms)
        return state, _stack_terms(out)
    return multi


def make_train_scan_batched(step_fn):
    """``make_train_scan`` where step i trains on its own example: every
    leaf of ``batch`` has a leading (n,) axis, and step i takes slice i
    with ``draws_seq[i]`` (the multi-step training path)."""
    def multi(state: TrainState, batch: dict, draws_seq: list):
        out = []
        for i, draws in enumerate(draws_seq):
            state, terms = step_fn(state, {k: v[i] for k, v in
                                           batch.items()}, draws)
            out.append(terms)
        return state, _stack_terms(out)
    return multi
