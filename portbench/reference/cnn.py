"""Plain PyTorch DualStyleUNet: the heads of the avatar, for the check.

A frozen copy of the network the port runs (the StyleGAN2-style U-Net of
AnimatableGaussians' ``network/styleunet/dual_styleunet.py``), kept apart
from the port so that a later change to the port cannot change the
yardstick. Every FIR resampling is the textbook upfirdn2d: zero-stuff,
pad, and a depthwise ``F.conv2d`` with the flipped taps. The modules and
their order mirror the reference checkpoint's names, so one state dict
loads into this network and into the port's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BLUR_KERNEL = (1, 3, 3, 1)


def make_kernel(k) -> np.ndarray:
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return k / k.sum()


def upfirdn2d(x, kernel: np.ndarray, up: int = 1, down: int = 1,
              pad=(0, 0, 0, 0)):
    """x (N, C, H, W); pad (px0, px1, py0, py1), negative pads crop."""
    px0, px1, py0, py1 = pad
    n, c, h, w = x.shape
    if up > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1])
        x = x.reshape(n, c, h * up, w * up)
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0):x.shape[2] - max(-py1, 0),
          max(-px0, 0):x.shape[3] - max(-px1, 0)]
    k = torch.as_tensor(np.ascontiguousarray(np.flip(kernel, (0, 1))),
                        dtype=x.dtype, device=x.device)
    wgt = k[None, None].expand(c, 1, k.shape[0], k.shape[1])
    return F.conv2d(x, wgt, stride=down, groups=c)


def _pad4(p0, p1):
    return (p0, p1, p0, p1)


def upsample(x, kernel, factor=2):
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel * factor ** 2, up=factor,
                     pad=_pad4((p + 1) // 2 + factor - 1, p // 2))


def downsample(x, kernel, factor=2):
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, down=factor, pad=_pad4((p + 1) // 2, p // 2))


def leaky(x, bias=None):
    if bias is not None:
        x = x + bias.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x >= 0, x, x * 0.2) * math.sqrt(2.0)


def _haar():
    s = 1.0 / math.sqrt(2.0)
    lo = np.full((1, 2), s, np.float32)
    hi = np.array([[-s, s]], np.float32)
    return lo.T @ lo, hi.T @ lo, lo.T @ hi, hi.T @ hi


def haar(x):
    """(N, C, H, W) -> (N, 4C, H/2, W/2), [ll, lh, hl, hh] blocks."""
    n, c, h, w = x.shape
    p = x.reshape(n, c, h // 2, 2, w // 2, 2)
    return torch.cat([sum(float(k[1 - a, 1 - b]) * p[:, :, :, a, :, b]
                          for a in (0, 1) for b in (0, 1))
                      for k in _haar()], dim=1)


def inverse_haar(x):
    """(N, 4C, H, W) -> (N, C, 2H, 2W)."""
    n, c4, h, w = x.shape
    c = c4 // 4
    subs = (x[:, :c], x[:, c:2 * c], x[:, 2 * c:3 * c], x[:, 3 * c:])
    out = x.new_empty((n, c, h, 2, w, 2))
    for a in (0, 1):
        for b in (0, 1):
            out[:, :, :, a, :, b] = sum(
                sg * float(k[a, b]) * s for s, sg, k in
                zip(subs, (1.0, -1.0, -1.0, 1.0), _haar()))
    return out.reshape(n, c, 2 * h, 2 * w)


class PixelNorm(nn.Module):
    def forward(self, x):
        return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-8)


class EqualLinear(nn.Module):
    def __init__(self, in_dim, out_dim, bias_init=0.0, lr_mul=1.0,
                 activation=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))
        self.scale = lr_mul / math.sqrt(in_dim)
        self.lr_mul, self.bias_init = lr_mul, bias_init
        self.activation = activation

    def forward(self, x):
        out = F.linear(x, self.weight * self.scale)
        if self.activation:
            return leaky(out, self.bias * self.lr_mul)
        return out + self.bias * self.lr_mul


class EqualConv2d(nn.Module):
    def __init__(self, in_ch, out_ch, k, stride=1, padding=0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.scale = 1.0 / math.sqrt(in_ch * k * k)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return F.conv2d(x, self.weight * self.scale, None,
                        stride=self.stride, padding=self.padding)


class Blur(nn.Module):
    def __init__(self, pad):
        super().__init__()
        self.pad = pad

    def forward(self, x):
        return upfirdn2d(x, make_kernel(BLUR_KERNEL), pad=_pad4(*self.pad))


class Bias(nn.Module):
    """The bias of a fused bias + LeakyReLU."""

    def __init__(self, ch):
        super().__init__()
        self.bias = nn.Parameter(torch.empty(ch))

    def forward(self, x):
        return leaky(x, self.bias)


def conv_layer(in_ch, out_ch, k, down=False):
    if down:
        p = (len(BLUR_KERNEL) - 2) + (k - 1)
        return nn.Sequential(Blur(((p + 1) // 2, p // 2)),
                             EqualConv2d(in_ch, out_ch, k, 2, 0),
                             Bias(out_ch))
    return nn.Sequential(EqualConv2d(in_ch, out_ch, k, 1, k // 2),
                         Bias(out_ch))


class ConvBlock(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv1 = conv_layer(in_ch, in_ch, 3)
        self.conv2 = conv_layer(in_ch, out_ch, 3, down=True)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class FromRGB(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv = conv_layer(in_ch, out_ch, 1)

    def forward(self, img, skip):
        img = downsample(img, make_kernel(BLUR_KERNEL))
        return img, self.conv(img) + skip


class ModulatedConv2d(nn.Module):
    def __init__(self, in_ch, out_ch, k, style_dim, demodulate=True,
                 up=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, out_ch, in_ch, k, k))
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1.0)
        self.scale = 1.0 / math.sqrt(in_ch * k * k)
        self.k, self.demodulate, self.up = k, demodulate, up

    def forward(self, x, style):
        s = self.modulation(style)[0]
        w = self.scale * self.weight[0] * s[None, :, None, None]
        if self.demodulate:
            w = w * torch.rsqrt(torch.sum(w * w, dim=(1, 2, 3))
                                + 1e-8)[:, None, None, None]
        if not self.up:
            return F.conv2d(x, w, padding=self.k // 2)
        out = F.conv_transpose2d(x, w.transpose(0, 1), stride=2)
        p = (len(BLUR_KERNEL) - 2) - (self.k - 1)
        return upfirdn2d(out, make_kernel(BLUR_KERNEL) * 4.0,
                         pad=_pad4((p + 1) // 2 + 1, p // 2 + 1))


class Noise(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))


class StyledConv(nn.Module):
    def __init__(self, in_ch, out_ch, style_dim, up=False):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, out_ch, 3, style_dim, up=up)
        self.noise = Noise()
        self.activate = Bias(out_ch)

    def forward(self, x, style, noise):
        return self.activate(self.conv(x, style) + self.noise.weight * noise)


class ToRGB(nn.Module):
    def __init__(self, in_ch, style_dim, out_ch):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, out_ch, 1, style_dim,
                                    demodulate=False)
        self.bias = nn.Parameter(torch.empty(1, out_ch, 1, 1))

    def forward(self, x, style, skip=None):
        out = self.conv(x, style) + self.bias
        if skip is None:
            return out
        return out + haar(upsample(inverse_haar(skip),
                                   make_kernel(BLUR_KERNEL)))


def channels(mult: int, channel_max: int) -> dict:
    c = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * mult, 128: 128 * mult,
         256: 64 * mult, 512: 32 * mult, 1024: 16 * mult, 2048: 16 * mult}
    return {k: min(v, channel_max) for k, v in c.items()}


class DualStyleUNet(nn.Module):
    """style (1, style_dim), cond (B, S, S, 3) NHWC -> (B, 2S, 2S, 2 out_ch)
    NHWC, [front | back] channels."""

    def __init__(self, inp_size, out_size, out_ch, style_dim=512, n_mlp=2,
                 middle_size=8, channel_multiplier=2, lr_mlp=0.01,
                 channel_max=512):
        super().__init__()
        ch = channels(channel_multiplier, channel_max)
        self.middle = mid = int(math.log2(middle_size))
        top_out = int(math.log2(out_size))
        self.style = nn.Sequential(PixelNorm(), *[
            EqualLinear(style_dim, style_dim, lr_mul=lr_mlp, activation=True)
            for _ in range(n_mlp)])
        enc_in = ch[inp_size // 2]
        self.conv_in = conv_layer(3, enc_in, 3, down=True)
        self.from_rgbs, self.cond_convs = nn.ModuleList(), nn.ModuleList()
        comb = [conv_layer(enc_in * 2, enc_in, 3)]
        c_in = enc_in
        for i in range(int(math.log2(inp_size)) - 2, mid - 1, -1):
            c_out = ch[2 ** i]
            self.from_rgbs.append(FromRGB(3, c_in))
            self.cond_convs.append(ConvBlock(c_in, c_out))
            comb.append(conv_layer(c_out * 2 if i > mid else c_out, c_out, 3))
            c_in = c_out
        self.comb_convs = nn.ModuleList(comb)
        chans = [ch[2 ** mid]] + [ch[2 ** i] for i in range(mid + 1, top_out)]
        for branch in ("1", "2"):
            convs, rgbs = nn.ModuleList(), nn.ModuleList()
            for cin, cout in zip(chans, chans[1:]):
                convs.append(StyledConv(cin, cout, style_dim, up=True))
                convs.append(StyledConv(cout, cout, style_dim))
                rgbs.append(ToRGB(cout, style_dim, out_ch * 4))
            setattr(self, f"convs{branch}", convs)
            setattr(self, f"to_rgbs{branch}", rgbs)
        self.num_layers = 2 * (top_out - mid - 1)
        self.noises = nn.Module()
        for i in range(self.num_layers):
            res = 2 ** ((i + 2 * (mid + 1)) // 2)
            self.noises.register_buffer(f"noise_{i}",
                                        torch.empty(1, 1, res, res))

    def _decode(self, convs, rgbs, latent, noise, cond_list, view):
        n_comb = len(self.comb_convs)
        out = skip = None
        for stage, rgb in enumerate(rgbs):
            i = 2 * stage
            if i == 0:
                out = self.comb_convs[-1](cond_list[-1])
            elif i < 2 * n_comb:
                out = torch.cat([out, cond_list[-1 - i // 2]], dim=1)
                out = self.comb_convs[-1 - i // 2](out)
            out = convs[i](out, latent, noise[i])
            out = convs[i + 1](out, latent, noise[i + 1])
            skip = rgb(out, latent, skip)
            if view is not None and i == 8:
                out = out + F.interpolate(view.permute(0, 3, 1, 2),
                                          size=out.shape[2:],
                                          mode="bilinear",
                                          align_corners=False)
        return skip

    def forward(self, style, cond, view1=None, view2=None):
        latent = self.style(style)
        noise = [getattr(self.noises, f"noise_{i}")
                 for i in range(self.num_layers)]
        img = cond.permute(0, 3, 1, 2)
        out = self.conv_in(img)
        cond_list = [out]
        for frgb, block in zip(self.from_rgbs, self.cond_convs):
            img, out = frgb(img, out)
            out = block(out)
            cond_list.append(out)
        images = [inverse_haar(self._decode(c, r, latent, noise, cond_list,
                                            v))
                  for c, r, v in ((self.convs1, self.to_rgbs1, view1),
                                  (self.convs2, self.to_rgbs2, view2))]
        return torch.cat(images, dim=1).permute(0, 2, 3, 1)
