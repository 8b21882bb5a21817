"""LPIPS perceptual loss with a VGG16 trunk, frozen.

Port of ``animatablegaussians_tpu/training/lpips.py:32-162``: inputs in
[0, 1] are mapped to [-1, 1], shifted and scaled by LPIPS's ImageNet
statistics, run through the VGG16 convolutions with taps after relu1_2,
relu2_2, relu3_3, relu4_3 and relu5_3; each tap is unit-normalized over
channels, the squared difference weighted by the non-negative "lin"
vector, averaged over space, and the five terms summed.

The public call takes (B, H, W, 3) NHWC images like the JAX function. The
2x2 max-pool is a reshape and ``amax``, as the JAX package's reshape-max,
so a tie splits its gradient equally on both sides. The weights never get
a gradient (``requires_grad`` is off).

Weights come as a state dict (``convs.<i>.weight`` (out, in, 3, 3),
``convs.<i>.bias``, ``lins.<i>`` (C,)) from ``load_torch_weights`` (the
torchvision ``vgg16`` features and LPIPS lin checkpoint files),
``init_random`` (architecture-correct random numbers from numpy, not a
valid metric) or ``utils.convert.lpips_from_jax``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# VGG16 convolutional trunk: out channels, "M" for a 2x2 max-pool
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512)
# the convolutions after whose ReLU a feature is tapped
TAP_AFTER_CONV = (1, 3, 6, 9, 12)
LIN_CHANNELS = (64, 128, 256, 512, 512)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def conv_shapes():
    """(out, in, 3, 3) of each VGG16 convolution."""
    shapes, in_ch = [], 3
    for c in VGG16_CFG:
        if c != "M":
            shapes.append((c, in_ch, 3, 3))
            in_ch = c
    return shapes


def init_random(seed: int) -> dict:
    """Random weights from ``np.random.default_rng(seed)`` with the JAX
    package's scales: normal / sqrt(fan_in) convolutions, zero biases,
    |normal| / C lin weights."""
    rng = np.random.default_rng(seed)
    sd = {}
    for i, shape in enumerate(conv_shapes()):
        fan_in = shape[1] * shape[2] * shape[3]
        sd[f"convs.{i}.weight"] = torch.from_numpy(
            (rng.standard_normal(shape) / math.sqrt(fan_in)).astype(
                np.float32))
        sd[f"convs.{i}.bias"] = torch.zeros(shape[0])
    for i, c in enumerate(LIN_CHANNELS):
        sd[f"lins.{i}"] = torch.from_numpy(
            (np.abs(rng.standard_normal(c)) / c).astype(np.float32))
    return sd


def load_torch_weights(vgg_path: str, lin_path: str) -> dict:
    """State dict from the torch checkpoint files the reference vendors:
    torchvision ``vgg16`` features (``features.N.weight`` or bare
    ``N.weight``) and the LPIPS lin heads (``linK.model.1.weight`` or
    ``lins.K.model.1.weight``)."""
    vgg_sd = torch.load(vgg_path, map_location="cpu")
    if hasattr(vgg_sd, "state_dict"):
        vgg_sd = vgg_sd.state_dict()
    lin_sd = torch.load(lin_path, map_location="cpu")

    def find(sd, keys, what):
        for k in keys:
            if k in sd:
                return sd[k].detach().to(torch.float32)
        raise KeyError(f"{what} not in checkpoint")

    sd, torch_idx, conv_i = {}, 0, 0
    for c in VGG16_CFG:
        if c == "M":
            torch_idx += 1
            continue
        for kind in ("weight", "bias"):
            sd[f"convs.{conv_i}.{kind}"] = find(
                vgg_sd, (f"features.{torch_idx}.{kind}",
                         f"{torch_idx}.{kind}"),
                f"vgg16 layer {torch_idx}.{kind}")
        torch_idx += 2  # conv + relu
        conv_i += 1
    for i, c in enumerate(LIN_CHANNELS):
        sd[f"lins.{i}"] = find(lin_sd, (f"lin{i}.model.1.weight",
                                        f"lins.{i}.model.1.weight"),
                               f"lin{i} weight").reshape(c)
    return sd


class LPIPS(nn.Module):
    def __init__(self, weights: dict, device="cuda"):
        """``weights``: a state dict as the module docstring lays out. The
        module lives on the card unless ``device`` says otherwise."""
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv2d(s[1], s[0], 3, padding=1, device="meta")
            for s in conv_shapes())
        self.lins = nn.ParameterList(
            nn.Parameter(torch.empty(c, device="meta"))
            for c in LIN_CHANNELS)
        self.load_state_dict(weights, assign=True)
        self.requires_grad_(False)
        self.to(torch.device(device))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1)
                             .to(device), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1)
                             .to(device), persistent=False)

    def _features(self, x):
        """(B, 3, H, W) normalized -> the five tapped ReLU outputs."""
        feats, conv_i = [], 0
        for c in VGG16_CFG:
            if c == "M":
                n, ch, h, w = x.shape
                x = x[:, :, :h // 2 * 2, :w // 2 * 2].reshape(
                    n, ch, h // 2, 2, w // 2, 2).amax(dim=(3, 5))
                continue
            conv = self.convs[conv_i]
            x = F.relu(F.conv2d(x, conv.weight, conv.bias, padding=1))
            if conv_i in TAP_AFTER_CONV:
                feats.append(x)
            conv_i += 1
        return feats

    @staticmethod
    def _unit(x, eps: float = 1e-10):
        return x * torch.rsqrt(torch.sum(x * x, dim=1, keepdim=True) + eps)

    def forward(self, img0, img1, normalize: bool = True):
        """img0, img1 (B, H, W, 3) RGB, in [0, 1] with ``normalize``.
        Returns (B,) distances."""
        if normalize:
            img0 = 2.0 * img0 - 1.0
            img1 = 2.0 * img1 - 1.0
        x0 = (img0.permute(0, 3, 1, 2) - self.shift) / self.scale
        x1 = (img1.permute(0, 3, 1, 2) - self.shift) / self.scale
        total = 0.0
        for a, b, lin in zip(self._features(x0), self._features(x1),
                             self.lins):
            d = (self._unit(a) - self._unit(b)) ** 2             # (B, C, h, w)
            total = total + torch.mean(
                torch.sum(d * lin[None, :, None, None], dim=1), dim=(1, 2))
        return total
