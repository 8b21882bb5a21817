"""2D feature fields: differentiable grid sampling, tri-plane and UV learned
feature maps, a same-resolution conv stack and a 5-level U-Net.

Port of ``animatablegaussians_tpu/models/feature2d.py`` (ref:
utils/feature2d.py:9-183) as ``nn.Module``s, NCHW inside like the port's
other CNNs:

  * ``grid_sample2d``: bilinear sampling of an (B, C, H, W) image at
    (B, ..., 2) points in [-1, 1] (x, y; ``align_corners=True``
    semantics) -> (B, ..., C), differentiable in the image and the points,
    to any order. It is the JAX version's explicit four-corner gather:
    the floor of the detached coordinates, indices clamped into the image,
    corner weights that keep the gradient to the points. The reference
    hand-writes this op so that a gradient of a gradient runs through it.
    ``F.grid_sample(mode="bilinear", padding_mode="border",
    align_corners=True)`` gives the same values everywhere and, inside the
    image, the same first and second derivatives (a float64 check), but
    it clamps the coordinate, whose gradient is 0 on the image's low edge,
    where the gather keeps the one-sided derivative: at x = -1 or y = -1
    the points' gradients differ. So the gather, which is the JAX
    function, stays;
  * ``triplane_sample`` / ``TriPlaneFeature``: the (xy, yz, zx) planes of a
    3C-channel plane stack sampled at 3D points and concatenated;
  * ``UVFeature``: one learned UV plane;
  * ``ConvStack``: a k in {3, 5, 7} same-resolution conv stack with an
    optional leaky ReLU between layers (ref: feature2d.py:27-56);
  * ``UNet5``: a 5-level stride-2 U-Net with a transposed-conv decoder and
    skip concatenations, leaky ReLU and no BatchNorm, as the JAX package
    (the reference's BatchNorm variant is never instantiated by a shipped
    config; ref: feature2d.py:58-89).

Weights are drawn from a ``torch.Generator`` with the JAX package's
distributions; ``utils/convert.feature2d_state`` carries JAX parameters
across.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


# ---------------------------------------------------------------------------
# grid sampling
# ---------------------------------------------------------------------------

def grid_sample2d(image: torch.Tensor, p2d: torch.Tensor) -> torch.Tensor:
    """image (B, C, H, W); p2d (B, ..., 2) in [-1, 1], (x, y) order ->
    (B, ..., C)."""
    B, C, H, W = image.shape
    pts_shape = p2d.shape[1:-1]
    p = p2d.reshape(B, -1, 2)
    n = p.shape[1]
    ix = (p[..., 0] + 1.0) * 0.5 * (W - 1)
    iy = (p[..., 1] + 1.0) * 0.5 * (H - 1)
    ix0 = torch.floor(ix.detach())
    iy0 = torch.floor(iy.detach())
    # corner weights keep full gradients with respect to the points
    wx1 = ix - ix0
    wy1 = iy - iy0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    flat = image.reshape(B, C, H * W)

    def g(xi, yi):
        xi = torch.clamp(xi, 0, W - 1).to(torch.int64)
        yi = torch.clamp(yi, 0, H - 1).to(torch.int64)
        idx = (yi * W + xi)[:, None, :].expand(B, C, n)
        return torch.gather(flat, 2, idx)                 # (B, C, N)

    out = (g(ix0, iy0) * (wx0 * wy0)[:, None]
           + g(ix0 + 1, iy0) * (wx1 * wy0)[:, None]
           + g(ix0, iy0 + 1) * (wx0 * wy1)[:, None]
           + g(ix0 + 1, iy0 + 1) * (wx1 * wy1)[:, None])
    return out.permute(0, 2, 1).reshape((B,) + tuple(pts_shape) + (C,))


def triplane_sample(xyz: torch.Tensor, fmap: torch.Tensor) -> torch.Tensor:
    """xyz (B, ..., 3) in [-1, 1]; fmap (B, 3C, H, W), the plane stack [xy
    | yz | zx] -> (B, ..., 3C), the three planes' samples concatenated
    (ref: feature2d.py:144-153)."""
    C = fmap.shape[1] // 3
    outs = []
    for pi, (a1, a2) in enumerate(((0, 1), (1, 2), (2, 0))):
        plane = fmap[:, pi * C:(pi + 1) * C]
        p2d = torch.stack([xyz[..., a1], xyz[..., a2]], dim=-1)
        outs.append(grid_sample2d(plane, p2d))
    return torch.cat(outs, dim=-1)


def _generator(generator: Optional[torch.Generator], device, seed: int):
    if generator is not None:
        return generator
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


class _FeatureMap(nn.Module):
    """A learned (1, channels, S, S) map, 0.03 N(0, 1) at init."""

    def __init__(self, channels: int, feat_size: int, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 seed: int = 0):
        super().__init__()
        gen = _generator(generator, device, seed)
        self.fmap = nn.Parameter(0.03 * torch.randn(
            (1, channels, feat_size, feat_size), generator=gen,
            device=gen.device).to(device))

    def forward(self, batch: int) -> torch.Tensor:
        """The map broadcast to (batch, channels, S, S)."""
        return self.fmap.expand((batch,) + tuple(self.fmap.shape[1:]))


class TriPlaneFeature(_FeatureMap):
    """Learned (1, 3C, S, S) plane stack (ref: feature2d.py:156-167)."""

    def __init__(self, feat_dim: int, feat_size: int, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 seed: int = 0):
        super().__init__(3 * feat_dim, feat_size, device, generator, seed)
        self.feat_dim, self.feat_size = feat_dim, feat_size

    @staticmethod
    def sample_feat(xyz, fmap):
        return triplane_sample(xyz, fmap)


class UVFeature(_FeatureMap):
    """Learned (1, C, S, S) UV plane (ref: feature2d.py:170-182)."""

    def __init__(self, feat_dim: int, feat_size: int, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 seed: int = 0):
        super().__init__(feat_dim, feat_size, device, generator, seed)
        self.feat_dim, self.feat_size = feat_dim, feat_size

    @staticmethod
    def sample_feat(p2d, fmap):
        return grid_sample2d(fmap, p2d)


# ---------------------------------------------------------------------------
# conv stacks
# ---------------------------------------------------------------------------

def _leaky(x):
    """Leaky ReLU 0.2 with the JAX package's ``where(x >= 0, ...)``: the
    gradient at 0 is 1 (``F.leaky_relu``'s is 0.2)."""
    return torch.where(x >= 0, x, 0.2 * x)


def _conv(gen, cin: int, cout: int, k: int, device, stride: int = 1,
          bias: bool = False, transposed: bool = False) -> nn.Module:
    """A k x k conv (or a stride-2 transposed conv with output padding 1,
    the reference's deconv3x3, an exact 2x upsampling) with weights
    N(0, 2 / (k k cin)) and a zero bias, as JAX ``_conv_init``."""
    if transposed:
        conv = nn.ConvTranspose2d(cin, cout, k, stride=2, padding=1,
                                  output_padding=1, bias=bias, device=device)
    else:
        conv = nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                         bias=bias, device=device)
    with torch.no_grad():
        w = torch.randn(conv.weight.shape, generator=gen,
                        device=gen.device) * math.sqrt(2.0 / (k * k * cin))
        conv.weight.copy_(w)
        if bias:
            conv.bias.zero_()
    return conv


class ConvStack(nn.Module):
    """Same-resolution conv stack (ref: feature2d.py:27-56); NCHW."""

    def __init__(self, in_dim: int, out_dim: int,
                 hid_dim: Optional[int] = None, kernel_size: int = 5,
                 layer_num: int = 3, use_relu: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 seed: int = 0):
        super().__init__()
        if kernel_size not in (3, 5, 7):
            raise ValueError(f"kernel_size {kernel_size}: 3, 5 or 7")
        gen = _generator(generator, device, seed)
        dims = [in_dim] + [hid_dim or out_dim] * (layer_num - 1) + [out_dim]
        self.convs = nn.ModuleList(
            _conv(gen, dims[i], dims[i + 1], kernel_size, device)
            for i in range(len(dims) - 1))
        self.use_relu = use_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if self.use_relu and i < len(self.convs) - 1:
                x = _leaky(x)
        return x


class UNet5(nn.Module):
    """5-level U-Net (ref: feature2d.py:58-89) with leaky ReLU and no
    BatchNorm, as the JAX package; NCHW, H and W multiples of 16."""

    def __init__(self, in_c: int, out_c: int, nf: int, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 seed: int = 0):
        super().__init__()
        gen = _generator(generator, device, seed)
        c = lambda *a, **k: _conv(gen, *a, device=device, **k)  # noqa: E731
        self.conv1 = c(in_c, nf, 3)
        self.conv2 = c(nf, 2 * nf, 3, stride=2)
        self.conv3 = c(2 * nf, 4 * nf, 3, stride=2)
        self.conv4 = c(4 * nf, 8 * nf, 3, stride=2)
        self.conv5 = c(8 * nf, 8 * nf, 3, stride=2)
        self.deconv1 = c(8 * nf, 8 * nf, 3, transposed=True)
        self.deconv2 = c(16 * nf, 4 * nf, 3, transposed=True)
        self.deconv3 = c(8 * nf, 2 * nf, 3, transposed=True)
        self.deconv4 = c(4 * nf, nf, 3, transposed=True)
        self.deconv5 = c(2 * nf, nf, 3)
        self.tail = c(nf, out_c, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = _leaky(self.conv1(x))
        x2 = _leaky(self.conv2(x1))
        x3 = _leaky(self.conv3(x2))
        x4 = _leaky(self.conv4(x3))
        x5 = _leaky(self.conv5(x4))
        y1 = _leaky(self.deconv1(x5))
        y2 = _leaky(self.deconv2(torch.cat([y1, x4], 1)))
        y3 = _leaky(self.deconv3(torch.cat([y2, x3], 1)))
        y4 = _leaky(self.deconv4(torch.cat([y3, x2], 1)))
        y5 = _leaky(self.deconv5(torch.cat([y4, x1], 1)))
        return self.tail(y5)
