"""Fréchet Inception Distance.

Port of ``animatablegaussians_tpu/eval/fid.py``. The reference computes FID
with ``pytorch-fid`` over mask-cropped patch directories (ref:
eval/comparison_body_only_avatars.py:97-112); the JAX package's metric,
which this module follows, is self-contained:

  * ``frechet_distance``: ||mu1 - mu2||^2 + tr(C1 + C2 - 2 (C1 C2)^{1/2}),
    the square root's trace from the eigenvalues of the symmetric S C2 S
    with S = C1^{1/2}; float64, ``torch.linalg.eigh`` on the device;
  * ``InceptionV3Features``: the pool3 (2048-d) trunk of torchvision's
    InceptionV3 as an ``nn.Module`` with BatchNorm folded into each
    convolution, loadable from a torchvision ``inception_v3`` state dict
    (``from_torch``). Without a weight file, ``init_random`` gives
    architecture-correct random weights: a pipeline check, NOT a valid
    metric;
  * ``compute_fid``: directory-to-directory FID like the reference CLI.

As in the JAX package: the resize to 299 is antialiased bilinear
(``jax.image.resize``; pytorch-fid's has no antialiasing), every average
pool divides by the count of pixels inside the image (Mixed_7c's too,
where pytorch-fid max-pools), and the weights are read in torchvision's
layout. Statistics accumulate in float64.
"""

from __future__ import annotations

import math
import os
from typing import Iterable, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animatablegaussians_torch.utils.device import resolve


# ---------------------------------------------------------------------------
# Fréchet distance
# ---------------------------------------------------------------------------

def gaussian_stats(feats, device="cuda") -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(N, D) features -> (mu (D,), cov (D, D)), float64 on ``device``;
    the covariance with N - 1 in the denominator (``np.cov``)."""
    f = torch.as_tensor(feats).to(device=resolve(device),
                                  dtype=torch.float64)
    mu = f.mean(0)
    d = f - mu
    cov = d.T @ d / (f.shape[0] - 1)
    return mu, cov


def _sqrtm_product(c1: torch.Tensor, c2: torch.Tensor) -> float:
    """tr((C1 C2)^{1/2}) via the symmetric form: with S = C1^{1/2},
    (C1 C2)^{1/2} has the same eigenvalues as (S C2 S)^{1/2}, which is
    symmetric PSD; eigendecompose and sum the roots of the clipped
    eigenvalues."""
    w1, v1 = torch.linalg.eigh(c1)
    s = (v1 * torch.sqrt(w1.clamp(min=0))) @ v1.T          # C1^{1/2}
    m = s @ c2 @ s
    w = torch.linalg.eigvalsh((m + m.T) * 0.5)
    return float(torch.sqrt(w.clamp(min=0)).sum())


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6,
                     device="cuda") -> float:
    """||mu1-mu2||^2 + tr(C1 + C2 - 2 (C1 C2)^{1/2}) (FID formula), in
    float64 on ``device``."""
    dev = resolve(device)

    def f64(a):
        return torch.as_tensor(a).to(device=dev, dtype=torch.float64)

    mu1, mu2 = f64(mu1), f64(mu2)
    eye = torch.eye(mu1.shape[0], dtype=torch.float64, device=dev)
    cov1 = f64(cov1) + eps * eye
    cov2 = f64(cov2) + eps * eye
    diff = mu1 - mu2
    tr_sqrt = _sqrtm_product(cov1, cov2)
    return float(diff @ diff + torch.trace(cov1) + torch.trace(cov2)
                 - 2.0 * tr_sqrt)


# ---------------------------------------------------------------------------
# InceptionV3 pool3 feature trunk (torchvision names)
# ---------------------------------------------------------------------------

def _bn_fold(conv_w, bn_w, bn_b, bn_m, bn_v, eps=1e-3):
    """Fold BatchNorm into the conv (inference only) -> (w, b)."""
    scale = bn_w / np.sqrt(bn_v + eps)
    w = conv_w * scale[:, None, None, None]      # (out, in, kh, kw)
    b = bn_b - bn_m * scale
    return w, b


class _Spec:
    """Static InceptionV3 architecture description (torchvision names)."""

    STEM = [  # (name, out_ch, k, stride, pad)
        ("Conv2d_1a_3x3", 32, 3, 2, 0),
        ("Conv2d_2a_3x3", 32, 3, 1, 0),
        ("Conv2d_2b_3x3", 64, 3, 1, 1),
        ("POOL", 0, 3, 2, 0),
        ("Conv2d_3b_1x1", 80, 1, 1, 0),
        ("Conv2d_4a_3x3", 192, 3, 1, 0),
        ("POOL", 0, 3, 2, 0),
    ]
    # Inception blocks: torchvision Mixed_5b..7c (name, kind, in_ch,
    # pool_ch: A's pool branch width, C's 7x7 width)
    BLOCKS = [
        ("Mixed_5b", "A", 192, 32), ("Mixed_5c", "A", 256, 64),
        ("Mixed_5d", "A", 288, 64),
        ("Mixed_6a", "B", 288, 0),
        ("Mixed_6b", "C", 768, 128), ("Mixed_6c", "C", 768, 160),
        ("Mixed_6d", "C", 768, 160), ("Mixed_6e", "C", 768, 192),
        ("Mixed_7a", "D", 768, 0),
        ("Mixed_7b", "E", 1280, 0), ("Mixed_7c", "E", 2048, 0),
    ]


def _build_shapes(need):
    """Declare every conv's shape, ``need(name, kh, kw, cin, cout)``, in
    the JAX package's order (ref: fid.py:276-330)."""
    cin = 3
    for name, cout, k, s, pd in _Spec.STEM:
        if name == "POOL":
            continue
        need(name, k, k, cin, cout)
        cin = cout
    for name, kind, ch, pool_ch in _Spec.BLOCKS:
        if kind == "A":
            need(f"{name}.branch1x1", 1, 1, ch, 64)
            need(f"{name}.branch5x5_1", 1, 1, ch, 48)
            need(f"{name}.branch5x5_2", 5, 5, 48, 64)
            need(f"{name}.branch3x3dbl_1", 1, 1, ch, 64)
            need(f"{name}.branch3x3dbl_2", 3, 3, 64, 96)
            need(f"{name}.branch3x3dbl_3", 3, 3, 96, 96)
            need(f"{name}.branch_pool", 1, 1, ch, pool_ch)
        elif kind == "B":
            need(f"{name}.branch3x3", 3, 3, ch, 384)
            need(f"{name}.branch3x3dbl_1", 1, 1, ch, 64)
            need(f"{name}.branch3x3dbl_2", 3, 3, 64, 96)
            need(f"{name}.branch3x3dbl_3", 3, 3, 96, 96)
        elif kind == "C":
            c7 = pool_ch
            need(f"{name}.branch1x1", 1, 1, ch, 192)
            need(f"{name}.branch7x7_1", 1, 1, ch, c7)
            need(f"{name}.branch7x7_2", 1, 7, c7, c7)
            need(f"{name}.branch7x7_3", 7, 1, c7, 192)
            need(f"{name}.branch7x7dbl_1", 1, 1, ch, c7)
            need(f"{name}.branch7x7dbl_2", 7, 1, c7, c7)
            need(f"{name}.branch7x7dbl_3", 1, 7, c7, c7)
            need(f"{name}.branch7x7dbl_4", 7, 1, c7, c7)
            need(f"{name}.branch7x7dbl_5", 1, 7, c7, 192)
            need(f"{name}.branch_pool", 1, 1, ch, 192)
        elif kind == "D":
            need(f"{name}.branch3x3_1", 1, 1, ch, 192)
            need(f"{name}.branch3x3_2", 3, 3, 192, 320)
            need(f"{name}.branch7x7x3_1", 1, 1, ch, 192)
            need(f"{name}.branch7x7x3_2", 1, 7, 192, 192)
            need(f"{name}.branch7x7x3_3", 7, 1, 192, 192)
            need(f"{name}.branch7x7x3_4", 3, 3, 192, 192)
        else:
            need(f"{name}.branch1x1", 1, 1, ch, 320)
            need(f"{name}.branch3x3_1", 1, 1, ch, 384)
            need(f"{name}.branch3x3_2a", 1, 3, 384, 384)
            need(f"{name}.branch3x3_2b", 3, 1, 384, 384)
            need(f"{name}.branch3x3dbl_1", 1, 1, ch, 448)
            need(f"{name}.branch3x3dbl_2", 3, 3, 448, 384)
            need(f"{name}.branch3x3dbl_3a", 1, 3, 384, 384)
            need(f"{name}.branch3x3dbl_3b", 3, 1, 384, 384)
            need(f"{name}.branch_pool", 1, 1, ch, 192)


def _avg3(x):
    """3x3 stride-1 average over the pixels inside the image."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max3s2(x):
    return F.max_pool2d(x, 3, stride=2)


# padding (H, W) of the factorized convolutions
_P7A, _P7B, _P3A, _P3B = (0, 3), (3, 0), (0, 1), (1, 0)


class InceptionV3Features(nn.Module):
    """pool3 (2048-d) features. Each convolution is an ``nn.Conv2d`` with
    its BatchNorm folded into weight and bias, at the torchvision name
    (``Conv2d_1a_3x3``, ``Mixed_5b.branch1x1``, ...), followed by a
    ReLU."""

    def __init__(self, weights: dict, device="cuda"):
        """``weights``: ``{<name>.weight (out, in, kh, kw), <name>.bias}``
        as ``from_torch``, ``init_random`` and
        ``utils.convert.inception_from_jax`` make them. The module lives on
        the card unless ``device`` says otherwise."""
        super().__init__()

        def need(name, kh, kw, cin, cout):
            parent, _, leaf = name.rpartition(".")
            owner = self
            if parent:
                if not hasattr(self, parent):
                    self.add_module(parent, nn.Module())
                owner = getattr(self, parent)
            owner.add_module(leaf, nn.Conv2d(cin, cout, (kh, kw),
                                             device="meta"))

        _build_shapes(need)
        self.load_state_dict(weights, assign=True)
        self.requires_grad_(False)
        self.to(resolve(device))

    # -- weight loading ------------------------------------------------
    @staticmethod
    def from_torch(path: str, device="cuda") -> "InceptionV3Features":
        """torchvision ``inception_v3`` state dict (BN folded in float64
        at eps 1e-3; the ``fc`` and ``Aux`` keys are dropped)."""
        sd = torch.load(path, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        np_sd = {k: np.asarray(v.detach().numpy(), np.float64)
                 for k, v in sd.items() if "fc" not in k and "Aux" not in k}
        weights = {}
        prefixes = sorted({k.rsplit(".conv.weight", 1)[0]
                           for k in np_sd if k.endswith("conv.weight")})
        for p in prefixes:
            w, b = _bn_fold(np_sd[f"{p}.conv.weight"],
                            np_sd[f"{p}.bn.weight"], np_sd[f"{p}.bn.bias"],
                            np_sd[f"{p}.bn.running_mean"],
                            np_sd[f"{p}.bn.running_var"])
            weights[f"{p}.weight"] = torch.from_numpy(w.astype(np.float32))
            weights[f"{p}.bias"] = torch.from_numpy(b.astype(np.float32))
        return InceptionV3Features(weights, device=device)

    @staticmethod
    def init_random(generator: torch.Generator,
                    device="cuda") -> "InceptionV3Features":
        """Architecture-correct random weights (pipeline checks only, NOT
        a valid metric): He normal (ReLU gain sqrt(2)) weights drawn from
        ``generator`` in ``_build_shapes`` order, zero biases, so the
        activations keep an O(1) scale through the trunk."""
        weights = {}

        def need(name, kh, kw, cin, cout):
            w = torch.randn((cout, cin, kh, kw), generator=generator,
                            device=generator.device)
            weights[f"{name}.weight"] = w * math.sqrt(2.0 / (kh * kw * cin))
            weights[f"{name}.bias"] = torch.zeros(cout,
                                                  device=generator.device)

        _build_shapes(need)
        return InceptionV3Features(weights, device=device)

    # -- forward ---------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.Conv2d_1a_3x3.weight.device

    def _conv(self, name: str, x, stride=1, padding=0):
        c = self.get_submodule(name)
        return F.relu(F.conv2d(x, c.weight, c.bias, stride, padding))

    def _block_a(self, x, name):
        c = lambda n, xx, **kw: self._conv(f"{name}.{n}", xx, **kw)
        b1 = c("branch1x1", x)
        b2 = c("branch5x5_2", c("branch5x5_1", x), padding=2)
        b3 = c("branch3x3dbl_3",
               c("branch3x3dbl_2", c("branch3x3dbl_1", x), padding=1),
               padding=1)
        b4 = c("branch_pool", _avg3(x))
        return torch.cat([b1, b2, b3, b4], 1)

    def _block_b(self, x, name):
        c = lambda n, xx, **kw: self._conv(f"{name}.{n}", xx, **kw)
        b1 = c("branch3x3", x, stride=2)
        b2 = c("branch3x3dbl_3",
               c("branch3x3dbl_2", c("branch3x3dbl_1", x), padding=1),
               stride=2)
        return torch.cat([b1, b2, _max3s2(x)], 1)

    def _block_c(self, x, name):
        c = lambda n, xx, **kw: self._conv(f"{name}.{n}", xx, **kw)
        b1 = c("branch1x1", x)
        b2 = c("branch7x7_3", c("branch7x7_2", c("branch7x7_1", x),
                                padding=_P7A), padding=_P7B)
        b3 = c("branch7x7dbl_5",
               c("branch7x7dbl_4",
                 c("branch7x7dbl_3",
                   c("branch7x7dbl_2", c("branch7x7dbl_1", x),
                     padding=_P7B),
                   padding=_P7A), padding=_P7B), padding=_P7A)
        b4 = c("branch_pool", _avg3(x))
        return torch.cat([b1, b2, b3, b4], 1)

    def _block_d(self, x, name):
        c = lambda n, xx, **kw: self._conv(f"{name}.{n}", xx, **kw)
        b1 = c("branch3x3_2", c("branch3x3_1", x), stride=2)
        b2 = c("branch7x7x3_4",
               c("branch7x7x3_3",
                 c("branch7x7x3_2", c("branch7x7x3_1", x), padding=_P7A),
                 padding=_P7B), stride=2)
        return torch.cat([b1, b2, _max3s2(x)], 1)

    def _block_e(self, x, name):
        c = lambda n, xx, **kw: self._conv(f"{name}.{n}", xx, **kw)
        b1 = c("branch1x1", x)
        m2 = c("branch3x3_1", x)
        b2 = torch.cat([c("branch3x3_2a", m2, padding=_P3A),
                        c("branch3x3_2b", m2, padding=_P3B)], 1)
        m3 = c("branch3x3dbl_2", c("branch3x3dbl_1", x), padding=1)
        b3 = torch.cat([c("branch3x3dbl_3a", m3, padding=_P3A),
                        c("branch3x3dbl_3b", m3, padding=_P3B)], 1)
        b4 = c("branch_pool", _avg3(x))
        return torch.cat([b1, b2, b3, b4], 1)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, 299, 299) in [-1, 1] -> (B, 2048)."""
        for name, _, k, s, pd in _Spec.STEM:
            if name == "POOL":
                x = F.max_pool2d(x, k, stride=s, padding=pd)
            else:
                x = self._conv(name, x, stride=s, padding=pd)
        blocks = dict(A=self._block_a, B=self._block_b, C=self._block_c,
                      D=self._block_d, E=self._block_e)
        for name, kind, _, _ in _Spec.BLOCKS:
            x = blocks[kind](x, name)
        return x.mean(dim=(2, 3))                     # adaptive avg pool

    @torch.no_grad()
    def features(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) in [0, 1] -> (B, 2048). Resized to 299 by
        antialiased bilinear interpolation (``jax.image.resize``'s) and
        mapped to [-1, 1] as pytorch-fid does."""
        x = resize_299(images.permute(0, 3, 1, 2))
        return self.trunk(x * 2.0 - 1.0)


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 299, 299), bilinear with antialiasing (half-
    pixel centres), as ``jax.image.resize(..., "bilinear")``."""
    return F.interpolate(x, size=(299, 299), mode="bilinear",
                         align_corners=False, antialias=True)


# ---------------------------------------------------------------------------
# Directory FID (the reference CLI semantics)
# ---------------------------------------------------------------------------

def features_of_images(model: InceptionV3Features,
                       images: Iterable[np.ndarray],
                       batch: int = 8) -> torch.Tensor:
    """(N, 2048) float32 features on the model's device of (H, W, 3) [0, 1]
    host images, ``batch`` at a time."""
    dev = model.device
    feats: List[torch.Tensor] = []
    buf: List[np.ndarray] = []

    def flush():
        if not buf:
            return
        x = torch.from_numpy(np.stack(buf)).to(dev)
        feats.append(model.features(x))
        buf.clear()

    for im in images:
        buf.append(np.asarray(im, np.float32))
        if len(buf) == batch:
            flush()
    flush()
    return (torch.cat(feats) if feats
            else torch.zeros((0, 2048), device=dev))


def read_rgb_dir(d: str):
    """The images of a directory in name order, as (H, W, 3) RGB [0, 1]
    (cv2 read, BGR to RGB)."""
    import cv2 as cv

    for f in sorted(os.listdir(d)):
        img = cv.imread(os.path.join(d, f))
        if img is not None:
            yield img[..., ::-1] / 255.0


def compute_fid(dir1: str, dir2: str, model: InceptionV3Features,
                batch: int = 8) -> float:
    """FID between two image directories (ref:
    comparison_body_only_avatars.py:97-112 / pytorch-fid CLI), on the
    model's device."""
    dev = model.device
    s1 = gaussian_stats(features_of_images(model, read_rgb_dir(dir1),
                                           batch), dev)
    s2 = gaussian_stats(features_of_images(model, read_rgb_dir(dir2),
                                           batch), dev)
    return frechet_distance(s1[0], s1[1], s2[0], s2[1], device=dev)
