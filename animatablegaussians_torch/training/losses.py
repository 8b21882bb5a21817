"""Training losses: L1 colour, mask, offset norm, SSIM, the crop of the
image pair that the LPIPS term sees, the square crops and crop centres,
the generic losses of the reference's ``utils/losses.py`` and the StyleGAN
adversarial losses.

Port of ``animatablegaussians_tpu/training/losses.py``. Images are (H, W,
C) as in the JAX package. The random LPIPS crop takes its two uniform
draws ``(fv, fu)`` from the caller, so a test can hand both packages the
same numbers; ``random_crop_center`` draws from a ``torch.Generator``.
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


def crop_square(img, center_xy, size: int):
    """(H, W, C) -> the (size, size, C) square centred at ``center_xy``
    (x, y), its corner clamped into the image as ``jax.lax.dynamic_slice``
    clamps it (ref patch crop for LPIPS: main_avatar.py:75-115). The corner
    stays a tensor and the rows and columns are gathered with it, so the
    crop does not sync with the host."""
    h, w = img.shape[:2]
    c = torch.as_tensor(center_xy, device=img.device).to(torch.int64)
    x0 = torch.clamp(c[0] - size // 2, 0, w - size)
    y0 = torch.clamp(c[1] - size // 2, 0, h - size)
    span = torch.arange(size, device=img.device)
    return img.index_select(0, y0 + span).index_select(1, x0 + span)


def mask_center(mask):
    """Centroid of a binary mask as int32 (x, y) pixel coordinates
    (truncated, as the JAX package's ``astype(int32)``)."""
    h, w = mask.shape[:2]
    ys = torch.arange(h, dtype=torch.float32, device=mask.device)
    xs = torch.arange(w, dtype=torch.float32, device=mask.device)
    total = torch.clamp(torch.sum(mask), min=1.0)
    cy = torch.sum(mask * ys[:, None]) / total
    cx = torch.sum(mask * xs[None, :]) / total
    return torch.stack([cx, cy]).to(torch.int32)


def random_crop_center(generator: torch.Generator, mask, size: int):
    """A random int32 (x, y) centre in the bounding box of ``mask > 0.5``
    (the reference's crop after 300k iterations; ref:
    main_avatar.py:98-115), drawn on the generator's device without a host
    sync. Each coordinate is uniform on the JAX package's range [min(lo,
    hi), max(hi, lo + 1)) of the box's first and last row (column), which
    for an empty mask is [0, h + 1), as in JAX. ``size`` is unused, as in
    JAX. JAX's ``randint`` draws cannot be reproduced: the integers come
    from ``torch.randint`` over [0, 2^31 - 1) taken modulo the range's
    length (a bias below 1e-6 at image sizes)."""
    h, w = mask.shape[:2]
    dev = mask.device
    ys = torch.any(mask > 0.5, dim=1)
    xs = torch.any(mask > 0.5, dim=0)
    idx_y = torch.arange(h, device=dev)
    idx_x = torch.arange(w, device=dev)
    y0 = torch.min(torch.where(ys, idx_y, h))
    y1 = torch.max(torch.where(ys, idx_y, 0))
    x0 = torch.min(torch.where(xs, idx_x, w))
    x1 = torch.max(torch.where(xs, idx_x, 0))
    lo = torch.stack([torch.minimum(x0, x1), torch.minimum(y0, y1)])
    hi = torch.stack([torch.maximum(x1, x0 + 1), torch.maximum(y1, y0 + 1)])
    r = torch.randint(0, 2 ** 31 - 1, (2,), generator=generator,
                      device=generator.device).to(dev)
    return (lo + r % (hi - lo)).to(torch.int32)


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


# generic losses (ref: utils/losses.py)

def mse(a, b):
    return torch.mean((a - b) ** 2)


def tv_loss(img):
    """Mean absolute difference along the first two axes, summed."""
    dy = torch.abs(img[1:, :] - img[:-1, :]).mean()
    dx = torch.abs(img[:, 1:] - img[:, :-1]).mean()
    return dx + dy


def eikonal_loss(grads):
    """|| |grad sdf| - 1 ||^2 (ref: main_template.py:52-59)."""
    return torch.mean((torch.linalg.norm(grads, dim=-1) - 1.0) ** 2)


def second_order_smoothness(x, axis: int = 0):
    """Sequence acceleration penalty (ref: utils/losses.py:16-31)."""
    n = x.shape[axis]
    x0 = x.narrow(axis, 0, n - 2)
    x1 = x.narrow(axis, 1, n - 2)
    x2 = x.narrow(axis, 2, n - 2)
    return torch.mean((2 * x1 - x2 - x0) ** 2)


def weighted_mse(pred, target, weight):
    """(ref: utils/losses.py:34-40)."""
    return torch.mean((pred * weight - target * weight) ** 2)


def cosine_distance(pred, target, weight=None, axis: int = -1,
                    normalized: bool = True):
    """1 - cosine similarity along ``axis`` (ref: utils/losses.py:43-62),
    the norms clamped at 1e-8."""
    if normalized:
        pred = pred / torch.clamp(
            torch.linalg.norm(pred, dim=axis, keepdim=True), min=1e-8)
        target = target / torch.clamp(
            torch.linalg.norm(target, dim=axis, keepdim=True), min=1e-8)
    d = 1.0 - torch.sum(pred * target, dim=axis)
    if weight is not None:
        d = d * weight
    return torch.mean(d)


def iou_loss(predict, target):
    """1 - IoU of soft masks, per item over all but the first axis (ref:
    utils/losses.py:80-89)."""
    # torch.sum over no dims would sum everything; jnp.sum sums nothing
    dims = tuple(range(predict.dim()))[1:]
    total = (lambda x: torch.sum(x, dims)) if dims else (lambda x: x)
    intersect = total(predict * target)
    union = total(predict + target - predict * target) + 1e-6
    return torch.mean(1.0 - intersect / union)


def kld_loss(mu, logvar):
    """VAE KL(q || N(0, 1)) (ref: utils/losses.py:92-104)."""
    return torch.mean(-0.5 * torch.sum(
        1 + logvar - mu ** 2 - torch.exp(logvar), dim=-1))


# StyleGAN adversarial losses (ref: utils/losses.py:139-159). The R1
# penalty is a gradient of a gradient: its graph runs back through the
# discriminator's backward, FIRs included (ops/fir.py::_FIRGrad).

def d_logistic_loss(real_pred, fake_pred):
    return torch.mean(F.softplus(-real_pred) + F.softplus(fake_pred))


def g_nonsaturating_loss(fake_pred):
    return torch.mean(F.softplus(-fake_pred))


def d_r1_loss(discriminator_fn, real_img):
    """R1 gradient penalty ||dD/dx||^2 per sample on real images, taken at
    a detached copy of them, with the graph kept so that its gradient
    reaches the discriminator's parameters."""
    x = real_img.detach().requires_grad_(True)
    grad, = torch.autograd.grad(torch.sum(discriminator_fn(x)), x,
                                create_graph=True)
    return torch.sum(grad ** 2) / real_img.shape[0]
