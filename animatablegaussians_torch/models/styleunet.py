"""DualStyleUNet: pose map -> dual (front/back) Gaussian-map CNN.

Port of ``animatablegaussians_tpu/models/styleunet.py`` as ``nn.Module``s
whose ``state_dict`` keys are the reference torch checkpoint's names, the
ones ``animatablegaussians_tpu/training/checkpoint.py::import_dual_styleunet``
reads (``conv_in.1.weight``, ``convs1.3.conv.weight`` of shape
(1, out, in, k, k), ``noises.noise_i`` in NCHW, ...). The CNN runs NCHW
inside; ``DualStyleUNet.forward`` takes and returns NHWC like the JAX
``apply``.

The JAX package folds the up-conv + blur and blur + down-conv chains into
polyphase convolutions (styleunet.py:208-256,294-348); here they are the
chains themselves (transposed conv then FIR blur; FIR blur then strided
conv), which agree up to float32 summation order. Every FIR of the net goes
through ``ops/upfirdn2d._upfirdn2d`` and so through the FIR kernel on the
card; ``forward(..., plain=True)`` sends them to its plain version.

``remat=True`` recomputes each decoder stage in the backward instead of
keeping its activations (``torch.utils.checkpoint``), as the JAX
``DualStyleUNet(remat=True)`` wraps the same stage in ``jax.checkpoint``
(styleunet.py:450-454,588-595).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from animatablegaussians_torch.ops.upfirdn2d import (
    _downsample, _fused_leaky_relu, _inverse_haar_transform, _upfirdn2d,
    _upsample, _wavelet_downsample, _wavelet_upsample, make_kernel)

BLUR_KERNEL = (1, 3, 3, 1)


def _randn(shape, generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32)


class PixelNorm(nn.Module):
    def forward(self, x):
        return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-8)


class EqualLinear(nn.Module):
    """Equalized-lr linear layer; weight (out, in)."""

    def __init__(self, in_dim, out_dim, bias_init=0.0, lr_mul=1.0,
                 activation=False, generator=None):
        super().__init__()
        self.weight = nn.Parameter(_randn((out_dim, in_dim), generator)
                                   / lr_mul)
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init)))
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x):
        out = F.linear(x, self.weight * self.scale)
        if self.activation:
            return _fused_leaky_relu(out, self.bias * self.lr_mul)
        return out + self.bias * self.lr_mul


class EqualConv2d(nn.Module):
    """Equalized-lr conv; weight (out, in, k, k)."""

    def __init__(self, in_ch, out_ch, k, stride=1, padding=0, bias=True,
                 generator=None):
        super().__init__()
        self.weight = nn.Parameter(_randn((out_ch, in_ch, k, k), generator))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.scale = 1.0 / math.sqrt(in_ch * k * k)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return F.conv2d(x, self.weight * self.scale, self.bias,
                        stride=self.stride, padding=self.padding)


class Blur(nn.Module):
    def __init__(self, kernel, pad):
        super().__init__()
        self.kernel, self.pad = make_kernel(kernel), pad

    def forward(self, x, plain=False):
        return _upfirdn2d(x, self.kernel, pad=self.pad, plain=plain)


class FusedLeakyReLU(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return _fused_leaky_relu(x, self.bias)


class ConvLayer(nn.Sequential):
    """ConvLayer (ref: dual_styleunet.py:329-371): [Blur,] EqualConv2d,
    FusedLeakyReLU — so the keys are ``.0/.1`` or ``.1/.2``."""

    def forward(self, x, plain=False):
        for m in self:
            x = m(x, plain) if isinstance(m, Blur) else m(x)
        return x


def conv_layer(in_ch, out_ch, k, downsample=False, generator=None):
    layers = []
    if downsample:
        p = (len(BLUR_KERNEL) - 2) + (k - 1)
        layers.append(Blur(BLUR_KERNEL, pad=((p + 1) // 2, p // 2)))
        stride, padding = 2, 0
    else:
        stride, padding = 1, k // 2
    layers.append(EqualConv2d(in_ch, out_ch, k, stride, padding, bias=False,
                              generator=generator))
    layers.append(FusedLeakyReLU(out_ch))
    return ConvLayer(*layers)


class ConvBlock(nn.Module):
    def __init__(self, in_ch, out_ch, generator=None):
        super().__init__()
        self.conv1 = conv_layer(in_ch, in_ch, 3, generator=generator)
        self.conv2 = conv_layer(in_ch, out_ch, 3, downsample=True,
                                generator=generator)

    def forward(self, x, plain=False):
        return self.conv2(self.conv1(x), plain)


class FromRGB(nn.Module):
    """FromRGB (ref: dual_styleunet.py:442-470): the image is first
    downsampled (``downsample``), by a FIR or in the Haar domain
    (``use_wt``); a 1x1 ConvLayer of it is added to ``skip``. Returns
    (image, features)."""

    def __init__(self, in_ch, out_ch, downsample=True, use_wt=False,
                 generator=None):
        super().__init__()
        self.downsample, self.use_wt = downsample, use_wt
        self.conv = conv_layer(in_ch, out_ch, 1, generator=generator)

    def forward(self, img, skip=None, plain=False):
        if self.downsample and self.use_wt:
            img = _wavelet_downsample(img, BLUR_KERNEL, plain=plain)
        elif self.downsample:
            img = _downsample(img, make_kernel(BLUR_KERNEL), plain=plain)
        out = self.conv(img)
        return img, out if skip is None else out + skip


class ModulatedConv2d(nn.Module):
    """Style-modulated conv (ref: dual_styleunet.py:168-300); weight
    (1, out, in, k, k)."""

    def __init__(self, in_ch, out_ch, k, style_dim, demodulate=True,
                 upsample=False, generator=None):
        super().__init__()
        self.weight = nn.Parameter(_randn((1, out_ch, in_ch, k, k),
                                          generator))
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1.0,
                                      generator=generator)
        self.scale = 1.0 / math.sqrt(in_ch * k * k)
        self.k, self.demodulate, self.upsample = k, demodulate, upsample

    def _weight(self, s):
        w = self.scale * self.weight[0] * s[None, :, None, None]
        if self.demodulate:
            demod = torch.rsqrt(torch.sum(w * w, dim=(1, 2, 3)) + 1e-8)
            w = w * demod[:, None, None, None]
        return w

    def _conv(self, x, w, plain):
        if self.upsample:
            out = F.conv_transpose2d(x, w.transpose(0, 1), stride=2)
            p = (len(BLUR_KERNEL) - 2) - (self.k - 1)
            return _upfirdn2d(out, make_kernel(BLUR_KERNEL) * 4.0,
                              pad=((p + 1) // 2 + 1, p // 2 + 1), plain=plain)
        return F.conv2d(x, w, padding=self.k // 2)

    def forward(self, x, style, plain=False):
        s = self.modulation(style)                          # (B, in)
        if s.shape[0] == 1:
            # one style row modulates every sample: one shared weight and
            # one batched conv (the frame-batched inference path)
            return self._conv(x, self._weight(s[0]), plain)
        return torch.cat([self._conv(x[i:i + 1], self._weight(s[i]), plain)
                          for i in range(s.shape[0])])


class NoiseInjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def forward(self, x, noise):
        return x + self.weight * noise


class StyledConv(nn.Module):
    def __init__(self, in_ch, out_ch, k, style_dim, upsample=False,
                 generator=None):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, out_ch, k, style_dim,
                                    upsample=upsample, generator=generator)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_ch)

    def forward(self, x, style, noise, plain=False):
        return self.activate(self.noise(self.conv(x, style, plain), noise))


class ToRGB(nn.Module):
    """ToRGB: a 1x1 modulated conv plus the upsampled skip, in the Haar
    domain (``use_wt``: out_ch = 4 x image channels) or in pixel space."""

    def __init__(self, in_ch, style_dim, out_ch, use_wt=True,
                 generator=None):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, out_ch, 1, style_dim,
                                    demodulate=False, generator=generator)
        self.bias = nn.Parameter(torch.zeros(1, out_ch, 1, 1))
        self.use_wt = use_wt

    def forward(self, x, style, skip=None, plain=False):
        out = self.conv(x, style) + self.bias
        if skip is None:
            return out
        if self.use_wt:
            return out + _wavelet_upsample(skip, BLUR_KERNEL, plain=plain)
        return out + _upsample(skip, make_kernel(BLUR_KERNEL), plain=plain)


def _channels(mult: int):
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * mult,
            128: 128 * mult, 256: 64 * mult, 512: 32 * mult,
            1024: 16 * mult, 2048: 16 * mult, 4096: 16 * mult}


def mapping(style_dim: int, n_mlp: int, lr_mlp: float, c_dim: int = 0,
            generator=None) -> nn.Sequential:
    """The mapping MLP; a conditioning vector of ``c_dim`` joins its
    input."""
    dims = [style_dim + c_dim] + [style_dim] * n_mlp
    return nn.Sequential(PixelNorm(), *[
        EqualLinear(dims[i], dims[i + 1], lr_mul=lr_mlp, activation=True,
                    generator=generator) for i in range(n_mlp)])


class StyleUNetBase(nn.Module):
    """The encoder, decoder and noise buffers the StyleUNets share (ref:
    dual_styleunet.py:680-721), built and run in the reference's order;
    the subclass sets ``middle_log_size`` first."""

    def _build_encoder(self, cond_ch, enc_in, top, channels, use_wt=False,
                       generator=None):
        """``conv_in``, then from level ``top`` down to the middle one a
        FromRGB, a ConvBlock and a combining conv each (``from_rgbs``,
        ``cond_convs``, ``comb_convs``)."""
        g = generator
        self.conv_in = conv_layer(cond_ch, enc_in, 3, downsample=True,
                                  generator=g)
        self.from_rgbs = nn.ModuleList()
        self.cond_convs = nn.ModuleList()
        comb = [conv_layer(enc_in * 2, enc_in, 3, generator=g)]
        in_ch = enc_in
        for i in range(top, self.middle_log_size - 1, -1):
            out_c = channels[2 ** i]
            self.from_rgbs.append(FromRGB(cond_ch, in_ch, use_wt=use_wt,
                                          generator=g))
            self.cond_convs.append(ConvBlock(in_ch, out_c, generator=g))
            comb.append(conv_layer(
                out_c * 2 if i > self.middle_log_size else out_c, out_c, 3,
                generator=g))
            in_ch = out_c
        self.comb_convs = nn.ModuleList(comb)

    def _build_decoder(self, branches, channels, top, style_dim, rgb_ch,
                       use_wt=True, generator=None):
        """Per branch ``convs{b}`` (an upsampling and a plain StyledConv a
        level, from above the middle one to ``top``, exclusive) and
        ``to_rgbs{b}``; then the fixed noise buffers, one a layer (ref:
        dual_styleunet.py:717-721)."""
        g = generator
        levels = range(self.middle_log_size + 1, top)
        chans = [channels[2 ** self.middle_log_size]] + [
            channels[2 ** i] for i in levels]
        for branch in branches:
            convs, rgbs = nn.ModuleList(), nn.ModuleList()
            for cin, cout in zip(chans, chans[1:]):
                convs.append(StyledConv(cin, cout, 3, style_dim,
                                        upsample=True, generator=g))
                convs.append(StyledConv(cout, cout, 3, style_dim,
                                        generator=g))
                rgbs.append(ToRGB(cout, style_dim, rgb_ch, use_wt=use_wt,
                                  generator=g))
            setattr(self, f"convs{branch}", convs)
            setattr(self, f"to_rgbs{branch}", rgbs)
        self.num_layers = 2 * len(levels)
        self.noises = nn.Module()
        for i in range(self.num_layers):
            res = self._noise_res(i)
            self.noises.register_buffer(f"noise_{i}",
                                        _randn((1, 1, res, res), g))

    def _noise_res(self, i: int) -> int:
        return 2 ** ((i + 2 * (self.middle_log_size + 1)) // 2)

    def _encode(self, img, plain):
        """The condition features of each encoder level, top first."""
        cond_out = self.conv_in(img, plain)
        cond_list = [cond_out]
        for frgb, cblock in zip(self.from_rgbs, self.cond_convs):
            img, cond_out = frgb(img, cond_out, plain)
            cond_out = cblock(cond_out, plain)
            cond_list.append(cond_out)
        return cond_list

    def _decode(self, convs, rgbs, style_at, noise, cond_list, plain,
                view_feature=None, remat=False):
        """One branch's ToRGB skip: ``style_at(i)`` the style of layer i
        (the ToRGB after layer i + 1 takes ``style_at(i + 2)``), noise[i]
        its NCHW noise map; ``view_feature`` (NHWC) is added after the
        fifth level. With ``remat`` and a graph being built, each stage
        (its two StyledConvs and its ToRGB) is recomputed in the backward
        rather than kept."""
        n_comb = len(self.comb_convs)
        out = skip = None
        for stage, rgb in enumerate(rgbs):
            i = 2 * stage

            def stage_fn(out, skip, i=i, rgb=rgb):
                out = convs[i](out, style_at(i), noise[i], plain)
                out = convs[i + 1](out, style_at(i + 1), noise[i + 1], plain)
                return out, rgb(out, style_at(i + 2), skip, plain)

            if i == 0:
                out = self.comb_convs[-1](cond_list[-1])
            elif i < 2 * n_comb:
                out = torch.cat([out, cond_list[-1 - i // 2]], dim=1)
                out = self.comb_convs[-1 - i // 2](out)
            if remat and torch.is_grad_enabled():
                # the stage draws no random numbers (the noise maps are
                # fixed buffers), so its recompute needs no RNG state
                out, skip = torch.utils.checkpoint.checkpoint(
                    stage_fn, out, skip, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                out, skip = stage_fn(out, skip)
            if view_feature is not None and i == 8:
                out = out + F.interpolate(
                    view_feature.permute(0, 3, 1, 2), size=out.shape[2:],
                    mode="bilinear", align_corners=False)
        return skip


class DualStyleUNet(StyleUNetBase):
    def __init__(self, inp_size: int, inp_ch: int, out_ch: int,
                 out_size: int, style_dim: int, n_mlp: int,
                 middle_size: int = 8, channel_multiplier: int = 2,
                 lr_mlp: float = 0.01, channel_max: int = 512,
                 remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.remat = remat
        self.middle_log_size = int(math.log2(middle_size))
        self.log_size = int(math.log2(out_size)) - 1
        if inp_size < 4 * middle_size:
            raise ValueError(f"inp_size {inp_size} must be >= "
                             f"{4 * middle_size}")
        channels = {k: min(v, channel_max)
                    for k, v in _channels(channel_multiplier).items()}
        self.style = mapping(style_dim, n_mlp, lr_mlp, generator=g)
        self._build_encoder(inp_ch, channels[inp_size // 2],
                            int(math.log2(inp_size)) - 2, channels,
                            generator=g)
        self._build_decoder(("1", "2"), channels, self.log_size + 1,
                            style_dim, out_ch * 4, generator=g)

    def forward(self, style, cond_img, view_feature1=None,
                view_feature2=None, plain=False):
        """style (B or 1, style_dim); cond_img (B, inp, inp, inp_ch) NHWC;
        view features NHWC. Returns (B, out, out, 2 * out_ch) NHWC:
        [front, back]. ``plain=True`` runs the FIRs' plain version."""
        latent = self.style(style)
        noise = [getattr(self.noises, f"noise_{i}")
                 for i in range(self.num_layers)]
        cond_list = self._encode(cond_img.permute(0, 3, 1, 2), plain)
        images = [_inverse_haar_transform(self._decode(
            convs, rgbs, lambda i: latent, noise, cond_list, plain, view,
            self.remat))
            for convs, rgbs, view in ((self.convs1, self.to_rgbs1,
                                       view_feature1),
                                      (self.convs2, self.to_rgbs2,
                                       view_feature2))]
        return torch.cat(images, dim=1).permute(0, 2, 3, 1)
