"""Plain PyTorch train step of the avatar: L1, LPIPS (VGG16) on the mask's
centred crop, the offset penalty, and Adam on the cosine schedule.

The loss of AnimatableGaussians' ``main_avatar.py`` (``train_avatar``)
before its 300k-step switch to random crops: the image and the target over
a background colour, the boundary band taken out, L1 over the image, LPIPS
between the two resampled to the crop size around the mask's bounding
box, and the mean norm of the non-rigid offsets. Adam as ``torch.optim``
defines it (eps outside the square root), at lr(t) = lr0 ((cos(pi t / T)
+ 1) / 2 (1 - 0.05) + 0.05).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512)
TAPS = (1, 3, 6, 9, 12)
LIN = (64, 128, 256, 512, 512)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def vgg_shapes():
    shapes, c_in = [], 3
    for c in VGG16:
        if c != "M":
            shapes.append((c, c_in, 3, 3))
            c_in = c
    return shapes


def lpips(w: dict, a, b):
    """LPIPS distance (B,) of (B, H, W, 3) images in [0, 1]."""
    dev = a.device
    shift = torch.tensor(SHIFT, device=dev).reshape(1, 3, 1, 1)
    scale = torch.tensor(SCALE, device=dev).reshape(1, 3, 1, 1)

    def feats(x):
        x = ((2.0 * x - 1.0).permute(0, 3, 1, 2) - shift) / scale
        out, i = [], 0
        for c in VGG16:
            if c == "M":
                x = F.max_pool2d(x, 2)
                continue
            x = F.relu(F.conv2d(x, w[f"convs.{i}.weight"],
                                w[f"convs.{i}.bias"], padding=1))
            if i in TAPS:
                out.append(x)
            i += 1
        return out

    def unit(x):
        return x * torch.rsqrt(torch.sum(x * x, 1, keepdim=True) + 1e-10)

    total = 0.0
    for k, (fa, fb) in enumerate(zip(feats(a), feats(b))):
        d = (unit(fa) - unit(fb)) ** 2
        total = total + torch.mean(torch.sum(
            d * w[f"lins.{k}"][None, :, None, None], 1), dim=(1, 2))
    return total


def _resample_matrix(n_in, n_out, scale, shift):
    """(n_in, n_out) weights of an antialiased bilinear resize by
    ``scale`` after a ``shift`` (output = input * scale + shift)."""
    dev = scale.device
    ks = torch.clamp(1.0 / scale, min=1.0)
    src = (torch.arange(n_out, device=dev, dtype=torch.float32) + 0.5
           - shift) / scale - 0.5
    x = torch.abs(src[None] - torch.arange(n_in, device=dev,
                                           dtype=torch.float32)[:, None]) / ks
    w = torch.clamp(1.0 - x, min=0.0)
    tot = w.sum(0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (src >= -0.5) & (src <= n_in - 0.5)
    return torch.where(inside[None], w, torch.zeros_like(w))


def centre_crop(imgs, mask, size: int):
    """Each (H, W, C) image's square around the mask's bounding box,
    resampled to (size, size, C)."""
    h, w = mask.shape
    ys = torch.nonzero((mask > 0.5).any(1))[:, 0]
    xs = torch.nonzero((mask > 0.5).any(0))[:, 0]
    v0, v1 = ys.min(), ys.max() + 1
    u0, u1 = xs.min(), xs.max() + 1
    scale = size / torch.maximum(v1 - v0, u1 - u0).float()
    cy, cx = 0.5 * (v0 + v1).float(), 0.5 * (u0 + u1).float()
    wy = _resample_matrix(h, size, scale, 0.5 * size - cy * scale)
    wx = _resample_matrix(w, size, scale, 0.5 * size - cx * scale)
    return [torch.einsum("hs,hwc,wt->stc", wy, im, wx) for im in imgs]


def item_loss(model, items, draws, lpips_w, loss_weight, patch: int,
              img_w: int, img_h: int):
    """-> (weighted L1 + offset, (image crop, target crop)) of one item."""
    bg = draws["bg"]
    img, _, offset, _ = model.render(items, bg, img_w, img_h,
                                     noise=draws["viewdir_noise"])
    mask = items["mask_img"]
    keep = (1.0 - items["boundary_mask_img"])[..., None]
    gt = torch.where(mask[..., None] > 0.5, items["color_img"], bg)
    img = img * keep + (1.0 - keep) * bg
    gt = gt * keep + (1.0 - keep) * bg
    l1 = torch.abs(img - gt).mean()
    sq = torch.sum(offset * offset, -1)
    pos = sq > 0
    off = torch.where(pos, torch.sqrt(torch.where(pos, sq,
                                                  torch.ones_like(sq))),
                      torch.zeros_like(sq)).mean()
    crops = centre_crop([img, gt], mask, patch)
    return loss_weight["l1"] * l1 + loss_weight["offset"] * off, crops


def step_loss_and_grads(model, batch: list, draws: list, lpips_w: dict,
                        loss_weight: dict, patch: int, img_w: int,
                        img_h: int) -> float:
    """The mean loss over the batch's items, its gradient accumulated in
    the parameters' ``.grad``, one item at a time (the loss is a mean of
    per-item terms, so the sum of the items' gradients over B is the
    batch's)."""
    for p in model.parameters():
        p.grad = None
    n = len(batch)
    total = 0.0
    for items, d in zip(batch, draws):
        loss, (a, b) = item_loss(model, items, d, lpips_w, loss_weight,
                                 patch, img_w, img_h)
        loss = loss + loss_weight["lpips"] * lpips(lpips_w, a[None],
                                                   b[None])[0]
        (loss / n).backward()
        total += float(loss.detach()) / n
    return total


class Adam:
    """Adam (0.9, 0.999, eps 1e-8 outside the square root) with the cosine
    learning rate and its 5% floor."""

    def __init__(self, params, lr0: float, iter_num: int):
        self.params = [p for p in params]
        self.lr0, self.iter_num, self.t = lr0, iter_num, 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    def lr(self, step: int) -> float:
        prog = min(step / self.iter_num, 1.0)
        return self.lr0 * ((math.cos(math.pi * prog) + 1.0) * 0.5 * 0.95
                           + 0.05)

    @torch.no_grad()
    def step(self):
        lr = self.lr(self.t)
        self.t += 1
        b1, b2 = 0.9, 0.999
        for p, m, v in zip(self.params, self.m, self.v):
            if p.grad is None:
                continue
            m.mul_(b1).add_(p.grad, alpha=1 - b1)
            v.mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
            mh = m / (1 - b1 ** self.t)
            vh = v / (1 - b2 ** self.t)
            p.sub_(lr * mh / (vh.sqrt() + 1e-8))
