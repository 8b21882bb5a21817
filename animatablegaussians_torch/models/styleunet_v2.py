"""DualStyleUNet v2 family: ``DualStyleUNetV2`` in its three modes and the
single-branch ``SWGANUnet``, with the full StyleGAN2 latent API.

Port of ``animatablegaussians_tpu/models/styleunet_v2.py`` as ``nn.Module``s
built from the port's v1 primitives (``models/styleunet.py``):

  * ``mode="base"``: the v1 net plus style mixing with ``inject_index``,
    truncation toward a mean latent, ``input_is_latent``, per-layer W+
    latents and a conditioning vector joined to the mapping MLP's input
    when ``c_dim > 0``;
  * ``mode="add_dwt"``: the condition image enters in the Haar domain
    (``conv_in`` takes 4 x inp_ch), the FromRGB cascade downsamples there,
    one encoder stage fewer;
  * ``mode="wo_dwt"``: no wavelets; one decoder stage more, up to
    out_size, and pixel-space ToRGB skips.

The ``state_dict`` keys are the reference torch checkpoint's, the v1
names (``SWGANUnet``: one ``convs`` / ``to_rgbs`` branch) that
``animatablegaussians_tpu/training/checkpoint.py::import_dual_styleunet_v2``
and ``import_swgan_unet`` read, so a reference state dict loads with
``load_state_dict(strict=True)``. The net runs NCHW inside; ``forward``
takes and returns NHWC images and noise maps, like the JAX ``apply``.
Every FIR goes through ``ops/upfirdn2d._upfirdn2d``, so through the FIR
kernel on the card; ``plain=True`` sends them to its plain version.
"""

from __future__ import annotations

import math
import random
from typing import List, Optional, Sequence

import torch

from animatablegaussians_torch.models.styleunet import (
    StyleUNetBase, _channels, mapping)
from animatablegaussians_torch.ops.upfirdn2d import (_haar_transform,
                                                     _inverse_haar_transform)
from animatablegaussians_torch.utils.device import resolve


def mix_latents(styles: Sequence[torch.Tensor], n_latent: int,
                inject_index: int) -> torch.Tensor:
    """(B, n_latent, D) W+ latents: one (B, D) latent repeated, a (B, L, D)
    one as it is, or two mixed, layers below ``inject_index`` from the
    first (ref: v2:836-843)."""
    if len(styles) < 2:
        s = styles[0]
        return s if s.dim() == 3 else s[:, None].repeat(1, n_latent, 1)
    return torch.cat([styles[0][:, None].repeat(1, inject_index, 1),
                      styles[1][:, None].repeat(1, n_latent - inject_index,
                                                1)], dim=1)


def truncate(styles, truncation: float, truncation_latent):
    if truncation >= 1.0:
        return list(styles)
    if truncation_latent is None:
        raise ValueError("truncation < 1 needs a truncation_latent")
    return [truncation_latent + truncation * (s - truncation_latent)
            for s in styles]


def draw_noise(shapes, generator, zero_noise: bool, device) -> List:
    """One NHWC map per shape: zeros, or normal draws from ``generator``
    (on its own device, then moved)."""
    if zero_noise or generator is None:
        return [torch.zeros(s, device=device) for s in shapes]
    return [torch.randn(s, generator=generator,
                        device=generator.device).to(device) for s in shapes]


def resolve_noise(net, noise, randomize_noise: bool, batch: int,
                  generator) -> List:
    """The NCHW noise maps a forward of ``net`` adds: the caller's (NHWC),
    fresh draws from ``generator`` at the batch, or the fixed buffers."""
    if noise is not None:
        return [n.permute(0, 3, 1, 2) for n in noise]
    if randomize_noise and generator is not None:
        return [t.permute(0, 3, 1, 2) for t in draw_noise(
            [(batch,) + s[1:] for s in net._noise_shapes()], generator,
            False, net.device)]
    return [getattr(net.noises, f"noise_{i}")
            for i in range(net.num_layers)]


class DualStyleUNetV2(StyleUNetBase):
    """The v2 net (ref: dual_styleunet_v2.py:634-901, 903-1184,
    1186-1451). ``generator`` draws the weights and noise buffers; the
    module lives on the card unless ``device`` says otherwise."""

    MODES = ("base", "add_dwt", "wo_dwt")
    BRANCHES = ("1", "2")

    def __init__(self, inp_size: int, inp_ch: int, out_ch: int,
                 out_size: int, style_dim: int, n_mlp: int,
                 middle_size: int = 8, c_dim: int = 0,
                 channel_multiplier: int = 2, lr_mlp: float = 0.01,
                 channel_max: int = 512, mode: str = "base",
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if mode not in self.MODES:
            raise ValueError(f"mode {mode!r} is not one of {self.MODES}")
        g = generator
        self.mode = mode
        self.style_dim, self.c_dim = style_dim, c_dim
        self.middle_log_size = int(math.log2(middle_size))
        self.log_size = int(math.log2(out_size)) - 1
        channels = {k: min(v, channel_max)
                    for k, v in _channels(channel_multiplier).items()}

        # encoder schedule (ref: v2 base 680-699; add_dwt starts one stage
        # later on the half-size wavelet stream, v2:951-965)
        if mode == "add_dwt":
            enc_in = channels[inp_size // 4]
            enc_top = int(math.log2(inp_size)) - 3
            cond_ch = inp_ch * 4
        else:
            enc_in = channels[inp_size // 2]
            enc_top = int(math.log2(inp_size)) - 2
            cond_ch = inp_ch
        # decoder schedule: wo_dwt runs to out_size in pixel space, the
        # wavelet modes to out_size / 2 (ref: v2:1282-1299)
        dec_top = self.log_size + (2 if mode == "wo_dwt" else 1)
        # W+ length (ref: v2:764; wo_dwt v2:1301)
        self.n_latent = self.log_size * 2 - (self.middle_log_size * 2 - 1) + 1
        if mode == "wo_dwt":
            self.n_latent += 3
        rgb_ch = out_ch if mode == "wo_dwt" else out_ch * 4

        self.style = mapping(style_dim, n_mlp, lr_mlp, c_dim, generator=g)
        self._build_encoder(cond_ch, enc_in, enc_top, channels,
                            use_wt=mode == "add_dwt", generator=g)
        self._build_decoder(self.BRANCHES, channels, dec_top, style_dim,
                            rgb_ch, use_wt=mode != "wo_dwt", generator=g)
        self.to(resolve(device))

    @property
    def device(self) -> torch.device:
        return self.noises.noise_0.device

    def _noise_shapes(self):
        """Each layer's NHWC noise shape at batch 1."""
        return [(1, self._noise_res(i), self._noise_res(i), 1)
                for i in range(self.num_layers)]

    # -- latent utilities (ref: v2:766-788) ---------------------------------
    def get_latent(self, style, cond=None):
        if cond is not None:
            style = torch.cat([style, cond], dim=-1)
        return self.style(style)

    def mean_latent(self, n_latent: int,
                    generator: Optional[torch.Generator] = None):
        """The mean W latent (1, style_dim) of ``n_latent`` normal draws."""
        z = torch.randn((n_latent, self.style_dim + self.c_dim),
                        generator=generator,
                        device=generator.device if generator is not None
                        else self.device).to(self.device)
        if self.c_dim:
            w = self.get_latent(z[:, :self.style_dim],
                                z[:, self.style_dim:])
        else:
            w = self.get_latent(z)
        return w.mean(0, keepdim=True)

    def make_noise(self, generator: Optional[torch.Generator] = None,
                   zero_noise: bool = False) -> List:
        """NHWC noise maps (1, res, res, 1), one a layer: zeros without a
        generator or with ``zero_noise``."""
        return draw_noise(self._noise_shapes(), generator, zero_noise,
                          self.device)

    # -- forward pieces (shared with SWGANUnet) ------------------------------
    def _prepare_latent(self, styles, cond, inject_index, truncation,
                        truncation_latent, input_is_latent):
        if not isinstance(styles, (list, tuple)):
            styles = [styles]
        if not input_is_latent:
            styles = [self.get_latent(s, cond) for s in styles]
        styles = truncate(styles, truncation, truncation_latent)
        if len(styles) > 1 and inject_index is None:
            # the reference's host-side draw on each call (ref: v2:836-843)
            inject_index = random.randint(1, self.n_latent - 1)
        return mix_latents(styles, self.n_latent, inject_index)

    # -- forward (ref: v2:789-901) ------------------------------------------
    def forward(self, styles, cond_img, cond=None,
                return_latents: bool = False,
                inject_index: Optional[int] = None,
                truncation: float = 1.0, truncation_latent=None,
                input_is_latent: bool = False, noise: Optional[List] = None,
                randomize_noise: bool = True,
                generator: Optional[torch.Generator] = None,
                plain: bool = False):
        """styles: a list of (B, style_dim) z or w vectors, or one (B, L,
        D) W+ tensor in a 1-list; cond_img (B, S, S, inp_ch) NHWC; noise
        NHWC maps. Returns (images (B, out, out, 2 * out_ch) NHWC [front,
        back], the latents or None) like the reference forward."""
        latent = self._prepare_latent(styles, cond, inject_index,
                                      truncation, truncation_latent,
                                      input_is_latent)
        noise = resolve_noise(self, noise, randomize_noise,
                              cond_img.shape[0], generator)
        cond_img = cond_img.permute(0, 3, 1, 2)
        if self.mode == "add_dwt":
            cond_img = _haar_transform(cond_img)     # (ref: v2:1119)
        cond_list = self._encode(cond_img, plain)
        last = self.n_latent - 1
        images = []
        for b in self.BRANCHES:
            skip = self._decode(getattr(self, f"convs{b}"),
                                getattr(self, f"to_rgbs{b}"),
                                lambda i: latent[:, min(i, last)], noise,
                                cond_list, plain)
            # wo_dwt's skip is already in pixel space
            images.append(skip if self.mode == "wo_dwt"
                          else _inverse_haar_transform(skip))
        images = torch.cat(images, dim=1).permute(0, 2, 3, 1)
        return images, (latent if return_latents else None)


class SWGANUnet(DualStyleUNetV2):
    """``SWGAN_unet`` (ref: network/styleunet/styleunet.py:634-860): the
    v2 ``base`` net with one decoder branch (``convs`` / ``to_rgbs``),
    returning (B, out, out, out_ch)."""

    BRANCHES = ("",)

    def __init__(self, *args, **kw):
        if kw.pop("mode", "base") != "base":
            raise ValueError("SWGAN_unet has no wavelet-input or pixel-skip "
                             "variants")
        super().__init__(*args, mode="base", **kw)
