"""StyleGAN2 wavelet-input Discriminator.

Port of ``animatablegaussians_tpu/models/discriminator.py`` (ref:
network/styleunet/dual_styleunet.py:473-567) as an ``nn.Module``: a Haar
input, the wavelet FromRGB / ConvBlock pyramid down to 4x4, the minibatch
standard deviation feature, and the pose-projection head when ``c_dim > 0``
(the logit's inner product with a normalized pose embedding). The
``state_dict`` keys are the reference checkpoint's (``from_rgbs.i.conv``,
the last one the 4x4 FromRGB; ``convs.i``, ``final_conv``,
``final_linear.0/1``, ``mapping.i``), the layout
``animatablegaussians_tpu/training/checkpoint.py::import_discriminator``
reads. The 4x4 map is flattened NCHW, as the reference flattens it, so
``final_linear.0`` takes the reference's columns as they are. ``forward``
takes NHWC images; ``plain=True`` runs the FIRs' plain version.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from animatablegaussians_torch.models.styleunet import (
    ConvBlock, EqualLinear, FromRGB, _channels, conv_layer)
from animatablegaussians_torch.ops.upfirdn2d import _haar_transform
from animatablegaussians_torch.utils.device import resolve


class Discriminator(nn.Module):
    def __init__(self, size: int, img_channel: int = 6,
                 channel_multiplier: int = 2, c_dim: int = 0,
                 channel_max: int = 512, stddev_group: int = 4,
                 stddev_feat: int = 1,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        g = generator
        self.c_dim = c_dim
        self.stddev_group, self.stddev_feat = stddev_group, stddev_feat
        channels = {k: min(v, channel_max)
                    for k, v in _channels(channel_multiplier).items()}
        log_size = int(math.log2(size)) - 1
        wt_ch = img_channel * 4
        # one FromRGB and ConvBlock a pyramid level, the first on the Haar
        # input as it is (ref: dual_styleunet.py:500-508)
        self.from_rgbs, self.convs = nn.ModuleList(), nn.ModuleList()
        in_ch = channels[size]
        for i in range(log_size, 2, -1):
            out_ch = channels[2 ** (i - 1)]
            self.from_rgbs.append(FromRGB(wt_ch, in_ch,
                                          downsample=i != log_size,
                                          use_wt=True, generator=g))
            self.convs.append(ConvBlock(in_ch, out_ch, generator=g))
            in_ch = out_ch
        ch4 = channels[4]
        self.from_rgbs.append(FromRGB(wt_ch, ch4, use_wt=True, generator=g))
        self.final_conv = conv_layer(in_ch + 1, ch4, 3, generator=g)
        self.final_linear = nn.Sequential(
            EqualLinear(ch4 * 4 * 4, ch4, activation=True, generator=g),
            EqualLinear(ch4, 1, generator=g))
        if c_dim > 0:
            dims = [c_dim, 64, 64, 64, 64]
            self.mapping = nn.Sequential(*[
                EqualLinear(dims[i], dims[i + 1], lr_mul=0.01,
                            activation=True, generator=g) for i in range(4)])
        self.to(resolve(device))

    def _minibatch_stddev(self, out: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> one more channel: each group's stddev over the
        batch, averaged over the map (ref: dual_styleunet.py:548-556);
        sample b = g * m + j of the B = group * m reads group member j's."""
        b, c, h, w = out.shape
        group = min(b, self.stddev_group)
        m = b // group
        x = out.reshape(group, m, self.stddev_feat, c // self.stddev_feat,
                        h, w)
        std = torch.sqrt(x.var(dim=0, unbiased=False) + 1e-8)
        std = std.mean(dim=(2, 3, 4)).mean(dim=1)         # (m,)
        std = std.repeat(group)                           # (B,)
        return torch.cat([out, std[:, None, None, None].expand(b, 1, h, w)],
                         dim=1)

    def forward(self, img: torch.Tensor,
                flat_pose: Optional[torch.Tensor] = None,
                plain: bool = False) -> torch.Tensor:
        """img (B, size, size, img_channel) NHWC -> (B, 1) logits."""
        x = _haar_transform(img.permute(0, 3, 1, 2))   # wavelet-domain input
        out = None
        for frgb, block in zip(self.from_rgbs, self.convs):
            x, out = frgb(x, out, plain)
            out = block(out, plain)
        _, out = self.from_rgbs[-1](x, out, plain)

        out = self.final_conv(self._minibatch_stddev(out))
        out = self.final_linear(out.reshape(out.shape[0], -1))   # (B, 1)
        if self.c_dim > 0:
            if flat_pose is None:
                raise ValueError("c_dim > 0: the pose head needs flat_pose")
            e = self.mapping(flat_pose)
            e = e * torch.rsqrt(torch.mean(e * e, dim=1, keepdim=True)
                                + 1e-8)
            out = torch.sum(out * e, dim=1, keepdim=True) / math.sqrt(
                self.c_dim)
        return out
