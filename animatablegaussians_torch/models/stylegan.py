"""StyleGAN2 generator with wavelet ToRGB skips.

Port of ``animatablegaussians_tpu/models/stylegan.py::StyleGenerator``
(ref: stylegan.py:148-331) as an ``nn.Module`` on the port's v1 primitives:
the mapping MLP, a learned constant 4x4 input, modulated-conv synthesis
pairs with noise injection, the wavelet-domain ToRGB skip chain, a final
inverse Haar to pixel space and the latent API of ``models/styleunet_v2.py``
(mixing, truncation, W+, ``input_is_latent``). The ``state_dict`` keys are
the reference checkpoint's (``input.input`` NCHW, ``conv1``, ``to_rgb1``,
``convs.i``, ``to_rgbs.i``, ``noises.noise_i``), the layout
``animatablegaussians_tpu/training/checkpoint.py::import_style_generator``
reads. ``forward`` returns NHWC; ``plain=True`` runs the FIRs' plain
version.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn

from animatablegaussians_torch.models.styleunet import (
    StyledConv, ToRGB, _channels, _randn, mapping)
from animatablegaussians_torch.models.styleunet_v2 import (
    draw_noise, mix_latents, resolve_noise, truncate)
from animatablegaussians_torch.ops.upfirdn2d import _inverse_haar_transform
from animatablegaussians_torch.utils.device import resolve


class ConstantInput(nn.Module):
    def __init__(self, channel: int, size: int = 4, generator=None):
        super().__init__()
        self.input = nn.Parameter(_randn((1, channel, size, size), generator))

    def forward(self, batch: int):
        return self.input.expand(batch, -1, -1, -1)


class StyleGenerator(nn.Module):
    def __init__(self, size: int, style_dim: int, n_mlp: int,
                 out_ch: int = 3, channel_multiplier: int = 2,
                 lr_mlp: float = 0.01, channel_max: int = 512,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        g = generator
        self.style_dim = style_dim
        channels = {k: min(v, channel_max)
                    for k, v in _channels(channel_multiplier).items()}
        self.log_size = int(math.log2(size)) - 1
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.n_latent = self.log_size * 2 - 2

        self.style = mapping(style_dim, n_mlp, lr_mlp, generator=g)
        ch4 = channels[4]
        self.input = ConstantInput(ch4, generator=g)
        self.conv1 = StyledConv(ch4, ch4, 3, style_dim, generator=g)
        self.to_rgb1 = ToRGB(ch4, style_dim, out_ch * 4, generator=g)
        self.convs, self.to_rgbs = nn.ModuleList(), nn.ModuleList()
        in_ch = ch4
        for i in range(3, self.log_size + 1):
            out_c = channels[2 ** i]
            self.convs.append(StyledConv(in_ch, out_c, 3, style_dim,
                                         upsample=True, generator=g))
            self.convs.append(StyledConv(out_c, out_c, 3, style_dim,
                                         generator=g))
            self.to_rgbs.append(ToRGB(out_c, style_dim, out_ch * 4,
                                      generator=g))
            in_ch = out_c
        self.noises = nn.Module()
        for i, shape in enumerate(self._noise_shapes()):
            self.noises.register_buffer(f"noise_{i}",
                                        _randn((1, 1) + shape[1:3], g))
        self.to(resolve(device))

    @property
    def device(self) -> torch.device:
        return self.input.input.device

    def _noise_shapes(self):
        """Each layer's NHWC noise shape at batch 1: 4x4, then two a
        resolution from 8 up."""
        shapes = [(1, 4, 4, 1)]
        for i in range(3, self.log_size + 1):
            shapes += [(1, 2 ** i, 2 ** i, 1)] * 2
        return shapes

    def get_latent(self, style):
        return self.style(style)

    def mean_latent(self, n_latent: int,
                    generator: Optional[torch.Generator] = None):
        z = torch.randn((n_latent, self.style_dim), generator=generator,
                        device=generator.device if generator is not None
                        else self.device).to(self.device)
        return self.get_latent(z).mean(0, keepdim=True)

    def make_noise(self, generator: Optional[torch.Generator] = None,
                   zero_noise: bool = False) -> List:
        return draw_noise(self._noise_shapes(), generator, zero_noise,
                          self.device)

    def forward(self, styles, return_latents: bool = False,
                inject_index: Optional[int] = None,
                truncation: float = 1.0, truncation_latent=None,
                input_is_latent: bool = False, noise: Optional[List] = None,
                randomize_noise: bool = True,
                generator: Optional[torch.Generator] = None,
                plain: bool = False):
        """styles: a list of (B, style_dim) vectors (or one (B, L, D) W+);
        noise NHWC maps. Returns (image (B, size, size, out_ch) NHWC, the
        latents or None)."""
        if not isinstance(styles, (list, tuple)):
            styles = [styles]
        if not input_is_latent:
            styles = [self.get_latent(s) for s in styles]
        styles = truncate(styles, truncation, truncation_latent)
        if inject_index is None:
            inject_index = self.n_latent // 2
        latent = mix_latents(styles, self.n_latent, inject_index)

        b = latent.shape[0]
        noise = resolve_noise(self, noise, randomize_noise, b, generator)
        out = self.conv1(self.input(b), latent[:, 0], noise[0], plain)
        skip = self.to_rgb1(out, latent[:, 1], None, plain)
        i = 1
        for c1, c2, rgb, n1, n2 in zip(self.convs[::2], self.convs[1::2],
                                       self.to_rgbs, noise[1::2],
                                       noise[2::2]):
            out = c1(out, latent[:, i], n1, plain)
            out = c2(out, latent[:, i + 1], n2, plain)
            skip = rgb(out, latent[:, min(i + 2, self.n_latent - 1)], skip,
                       plain)
            i += 2
        image = _inverse_haar_transform(skip).permute(0, 2, 3, 1)
        return image, (latent if return_latents else None)
