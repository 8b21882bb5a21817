"""Training losses: L1 colour, mask, offset norm, SSIM, and the crop of the
image pair that the LPIPS term sees.

Port of ``animatablegaussians_tpu/training/losses.py:15-137,157-186``.
Images are (H, W, C) as in the JAX package. The random LPIPS crop takes its
two uniform draws ``(fv, fu)`` from the caller, so a test can hand both
packages the same numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def l1_loss(pred, target, weight=None):
    diff = torch.abs(pred - target)
    if weight is not None:
        diff = diff * weight
    return torch.mean(diff)


def mask_loss(pred_mask, target_mask, boundary_mask=None):
    """L1 between rendered alpha and the GT mask, the boundary band left
    out (ref: main_avatar.py:215-222)."""
    diff = torch.abs(pred_mask - target_mask)
    if boundary_mask is not None:
        diff = diff * boundary_mask
    return torch.mean(diff)


def offset_loss(offset):
    """Mean L2 norm of the non-rigid offsets, with a zero (not NaN)
    gradient at a zero offset: the square root only ever sees positive
    sums."""
    sq = torch.sum(offset * offset, dim=-1)
    pos = sq > 0
    norm = torch.sqrt(torch.where(pos, sq, torch.ones_like(sq)))
    return torch.mean(torch.where(pos, norm, torch.zeros_like(norm)))


def _triangle_weights(in_size: int, out_size: int, scale, translation):
    """(in_size, out_size) resampling matrix of
    ``jax.image.scale_and_translate(method="bilinear", antialias=True)``
    along one axis: a triangle kernel widened by 1/scale when downscaling,
    each output's weights normalized to sum 1, outputs that sample outside
    the input zeroed."""
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev)
                 + 0.5) * inv_scale - translation * inv_scale - 0.5)
    x = torch.abs(sample_f[None, :] - torch.arange(
        in_size, dtype=torch.float32, device=dev)[:, None]) / kernel_scale
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(weights, dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(
        torch.abs(total) > eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def crop_to_mask(imgs, mask, patch_size: int,
                 crop: Optional[Tuple[float, float]] = None):
    """Crop each (H, W, C) image to the mask's square bbox and resample it
    to (patch_size, patch_size, C), bilinear with antialiasing, as two
    small matrix products (ref: main_avatar.py:75-115).

    With ``crop = (fv, fu)``, two uniform [0, 1) draws, a patch_size window
    whose top-left corner lies inside the bbox is sliced instead (the
    reference's mode after 300k iterations)."""
    h, w = mask.shape[:2]
    ys = torch.any(mask > 0.5, dim=1)
    xs = torch.any(mask > 0.5, dim=0)
    idx_y = torch.arange(h, device=mask.device)
    idx_x = torch.arange(w, device=mask.device)
    min_v = torch.min(torch.where(ys, idx_y, h - 1))
    max_v = torch.max(torch.where(ys, idx_y, 0)) + 1
    min_u = torch.min(torch.where(xs, idx_x, w - 1))
    max_u = torch.max(torch.where(xs, idx_x, 0)) + 1
    len_v = torch.clamp(max_v - min_v, min=1)
    len_u = torch.clamp(max_u - min_u, min=1)

    single = not isinstance(imgs, (list, tuple))
    img_list = [imgs] if single else list(imgs)
    if crop is not None:
        fv, fu = crop
        # float32 products truncated toward zero, as the JAX package's
        # astype(int32)
        f32 = torch.float32
        v0 = min_v + (torch.tensor(fv, dtype=f32) * torch.clamp(
            len_v - patch_size, min=0).to(f32)).to(torch.int64)
        u0 = min_u + (torch.tensor(fu, dtype=f32) * torch.clamp(
            len_u - patch_size, min=0).to(f32)).to(torch.int64)
        v0 = int(torch.clamp(v0, 0, max(h - patch_size, 0)))
        u0 = int(torch.clamp(u0, 0, max(w - patch_size, 0)))
        out = [im[v0:v0 + patch_size, u0:u0 + patch_size] for im in img_list]
    else:
        max_size = torch.maximum(len_v, len_u).to(torch.float32)
        scale = patch_size / max_size
        cy = 0.5 * (min_v + max_v).to(torch.float32)
        cx = 0.5 * (min_u + max_u).to(torch.float32)
        wy = _triangle_weights(h, patch_size, scale, 0.5 * patch_size
                               - cy * scale)                    # (H, p)
        wx = _triangle_weights(w, patch_size, scale, 0.5 * patch_size
                               - cx * scale)                    # (W, p)
        out = [torch.einsum("hwc,hp,wq->pqc", im, wy, wx) for im in img_list]
    return out[0] if single else out


def ssim(a, b, data_range: float = 1.0, win_size: int = 7, k1: float = 0.01,
         k2: float = 0.03):
    """Differentiable SSIM with a uniform window (skimage semantics) on
    (H, W, C) images."""
    c = a.shape[-1]
    kern = torch.full((c, 1, win_size, win_size), 1.0 / win_size ** 2,
                      dtype=a.dtype, device=a.device)

    def filt(x):
        return F.conv2d(x.permute(2, 0, 1)[None], kern, groups=c)[0]

    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1)
    ua, ub = filt(a), filt(b)
    va = cov_norm * (filt(a * a) - ua * ua)
    vb = cov_norm * (filt(b * b) - ub * ub)
    vab = cov_norm * (filt(a * b) - ua * ub)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ua * ub + c1) * (2 * vab + c2)
         / ((ua ** 2 + ub ** 2 + c1) * (va + vb + c2)))
    return torch.mean(s)


def ssim_loss(pred, target):
    return 1.0 - ssim(pred, target)
