"""Evaluation metrics: PSNR / SSIM / LPIPS and the mask-crop protocol.

Port of ``animatablegaussians_tpu/eval/score.py`` (ref: eval/score.py:9-108):
PSNR and SSIM on full frames (data_range 1), LPIPS on mask-cropped square
patches with 50 px of padding resized to 512^2.

PSNR and SSIM run in float64 on ``device`` (the card unless the caller
says otherwise), with skimage's semantics as the JAX package implements
them: a uniform 7x7 window, K1 = 0.01, K2 = 0.03, the sample covariance
(``win_size^2 / (win_size^2 - 1)``), the mean over the image less a
``(win_size - 1) // 2`` border, then over the channels. The JAX package
filters with scipy's ``uniform_filter`` (its ``reflect`` boundary) and then
crops that border, so every value it keeps comes from a window inside the
image; a box filter without padding computes those values and no others,
and needs no boundary mode.

LPIPS is the port's ``training/lpips.LPIPS``; a non-square crop is padded
with ones to a square first. The crop stays on the host (cv2), as in the
JAX package.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from animatablegaussians_torch.training.lpips import LPIPS, init_random
from animatablegaussians_torch.utils.device import resolve


class Metrics:
    """Running means (ref: eval/score.py:9-20)."""

    def __init__(self):
        self.psnr = 0.0
        self.ssim = 0.0
        self.lpips = 0.0
        self.count = 0

    def update(self, psnr=0.0, ssim=0.0, lpips=0.0):
        self.psnr += psnr
        self.ssim += ssim
        self.lpips += lpips
        self.count += 1

    def __repr__(self):
        if self.count == 0:
            return "count is 0!"
        c = self.count
        return (f"Count: {c}, PSNR: {self.psnr / c}, SSIM: {self.ssim / c}, "
                f"LPIPS: {self.lpips / c}")


def _f64(img, dev: torch.device) -> torch.Tensor:
    """A numpy array or tensor as float64 on ``dev``."""
    return torch.as_tensor(img).to(device=dev, dtype=torch.float64)


def compute_psnr(src, tar, data_range: float = 1.0,
                 device="cuda") -> float:
    """skimage.metrics.peak_signal_noise_ratio semantics, in float64 on
    ``device``."""
    dev = resolve(device)
    mse = float(torch.mean((_f64(src, dev) - _f64(tar, dev)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _box_valid(x: torch.Tensor, win_size: int) -> torch.Tensor:
    """Mean over every ``win_size``^2 window inside (N, 1, H, W): a
    separable box filter without padding, (N, 1, H - w + 1, W - w + 1)."""
    x = F.avg_pool2d(x, (win_size, 1), stride=1)
    return F.avg_pool2d(x, (1, win_size), stride=1)


def _ssim_maps(x: torch.Tensor, y: torch.Tensor, data_range: float,
               win_size: int = 7, k1: float = 0.01,
               k2: float = 0.03) -> torch.Tensor:
    """The SSIM map of (N, H, W) float64 planes at the window centres the
    JAX package keeps (ref: score.py:50-76): (N, H - 6, W - 6) at 7x7."""
    np_ = win_size ** 2
    cov_norm = np_ / (np_ - 1)
    n = x.shape[0]
    planes = torch.cat([x, y, x * x, y * y, x * y])[:, None]
    ux, uy, uxx, uyy, uxy = _box_valid(planes, win_size)[:, 0].split(n)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux ** 2 + uy ** 2 + c1
    b2 = vx + vy + c2
    return (a1 * a2) / (b1 * b2)


def compute_ssim(src, tar, data_range: float = 1.0,
                 device="cuda") -> float:
    """Multichannel SSIM = mean over channels (skimage multichannel=True),
    in float64 on ``device``. (H, W) or (H, W, C)."""
    dev = resolve(device)
    x, y = _f64(src, dev), _f64(tar, dev)
    if x.ndim == 2:
        x, y = x[..., None], y[..., None]
    s = _ssim_maps(x.permute(2, 0, 1), y.permute(2, 0, 1), data_range)
    return float(s.mean(dim=(1, 2)).mean())


@functools.lru_cache(maxsize=None)
def _default_lpips(device: torch.device) -> LPIPS:
    """The random-weight LPIPS of a call that passes no weights (as the
    JAX package's; not a valid perceptual metric)."""
    return LPIPS(init_random(0), device=device)


def _square(img: np.ndarray) -> np.ndarray:
    """Pad with ones to a square (ref: score.py:73-98's cut_rect)."""
    h, w = img.shape[:2]
    size = max(h, w)
    out = np.ones((size, size, img.shape[2]), img.dtype)
    out[:h, :w] = img
    return out


@torch.no_grad()
def compute_lpips(src: np.ndarray, tar: np.ndarray,
                  lpips_params: Optional[Union[dict, LPIPS]] = None,
                  device="cuda") -> float:
    """LPIPS (VGG) on (H, W, 3) float [0, 1] images; non-square inputs are
    padded to square with ones (ref: eval/score.py:73-98).
    ``lpips_params``: an ``LPIPS`` module (used where it lives), a state
    dict (``training/lpips.py``'s layout, loaded onto ``device``), or None
    for random weights on ``device``."""
    if isinstance(lpips_params, LPIPS):
        net = lpips_params
    else:
        dev = resolve(device)
        net = (_default_lpips(dev) if lpips_params is None
               else LPIPS(lpips_params, device=dev))
    dev = net.shift.device
    if src.shape[0] != src.shape[1]:
        src, tar = _square(src), _square(tar)
    a = torch.as_tensor(np.asarray(src, np.float32), device=dev)[None]
    b = torch.as_tensor(np.asarray(tar, np.float32), device=dev)[None]
    return float(net(a, b, normalize=True)[0])


def crop_image(gt_mask: np.ndarray, patch_size: int, *args):
    """Mask-bbox square crop (pad 50) resized to patch_size
    (ref: eval/score.py:23-60)."""
    import cv2 as cv

    uv = np.argwhere(gt_mask > 0.0)
    min_v, min_u = uv.min(0)
    max_v, max_u = uv.max(0)
    pad = 50
    min_v = max(min_v - pad, 0)
    min_u = max(min_u - pad, 0)
    max_v = min(max_v + pad, gt_mask.shape[0])
    max_u = min(max_u + pad, gt_mask.shape[1])
    len_v, len_u = max_v - min_v, max_u - min_u
    size = max(len_v, len_u)

    out = []
    for image in args:
        if image is None:
            out.append(None)
            continue
        patch = np.ones((size, size, 3), image.dtype)
        if len_v > len_u:
            s = (size - len_u) // 2
            patch[:, s:s + len_u] = image[min_v:max_v, min_u:max_u]
        else:
            s = (size - len_v) // 2
            patch[s:s + len_v, :] = image[min_v:max_v, min_u:max_u]
        out.append(cv.resize(patch, (patch_size, patch_size),
                             interpolation=cv.INTER_LINEAR))
    return out[0] if len(out) == 1 else out
