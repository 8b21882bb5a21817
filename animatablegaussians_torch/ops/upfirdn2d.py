"""StyleGAN2-style FIR resampling (upfirdn2d), fused bias+LeakyReLU and the
Haar wavelet transforms.

Port of ``animatablegaussians_tpu/ops/upfirdn2d.py``. The public functions
keep the JAX package's NHWC layout; each is a thin wrapper around an NCHW
core (leading underscore) that the CNN (``models/styleunet.py``) calls
directly. The JAX package folds several chains into single convolutions
(polyphase downsample, the composed wavelet-upsample kernel); here they are
the plain chains they were derived from, which agree up to float32
summation order.

Every resampling goes through ``_upfirdn2d``. A call that passes the JAX
package's gates (``upfirdn2d._try_pallas_fir``: up and down at most 2, a
numpy kernel that is rank-1 separable with at most 4 taps a side) goes
through ``ops/fir.py::upfirdn2d_fir``: the CUDA kernel ``csrc/fir.cu`` for
a tensor on the card, its plain version for one on the CPU. The JAX
package's further gate of at least 32 channels keeps narrow maps out of
the TPU kernel's VMEM blocks, where they lane-pad; the CUDA kernel tiles
each image plane whatever the channel count, so it is not kept (on the
H100 it is faster than the library's depthwise convolution at the CNN's
3- and 8-channel calls too; ``PERF.md``). ``plain=True`` sends the
gated calls to the plain version on any device (the reference the kernel
path is held to). The rest is a depthwise ``F.conv2d``.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from animatablegaussians_torch.ops import fir as _fir


def make_kernel(k: Sequence[float]) -> np.ndarray:
    """1D -> separable 2D FIR kernel, normalized to sum 1."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return k / k.sum()


def _norm_pad(pad) -> Tuple[int, int, int, int]:
    if len(pad) == 2:
        return pad[0], pad[1], pad[0], pad[1]
    return tuple(pad)  # (px0, px1, py0, py1)


def _nhwc(fn, x, *args, **kw):
    return fn(x.permute(0, 3, 1, 2), *args, **kw).permute(0, 2, 3, 1)


_FACTOR_CACHE: dict = {}


def _fir_factors(kernel, up: int, down: int):
    """The (kv, kh) tap tuples when this call passes the gates, else None."""
    if up > 2 or down > 2:
        return None
    if not isinstance(kernel, np.ndarray):
        return None
    key = (kernel.tobytes(), kernel.shape, kernel.dtype.str)
    if key not in _FACTOR_CACHE:
        fac = _fir.separable_factors(kernel)
        _FACTOR_CACHE[key] = None if fac is None else (
            tuple(fac[0].tolist()), tuple(fac[1].tolist()))
    return _FACTOR_CACHE[key]


# ---------------------------------------------------------------------------
# NCHW cores
# ---------------------------------------------------------------------------

def _upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
               pad=(0, 0), plain: bool = False) -> torch.Tensor:
    """Zero-stuff by ``up``, pad (negative pads crop), correlate with the
    flipped kernel (a true convolution), keep every ``down``-th sample;
    through the FIR kernel (its plain version with ``plain=True``) where
    ``_fir_factors`` lets it."""
    px0, px1, py0, py1 = _norm_pad(pad)
    fac = _fir_factors(kernel, up, down)
    if fac is not None:
        fn = _fir.upfirdn2d_fir_plain if plain else _fir.upfirdn2d_fir
        return fn(x.contiguous(), fac[0], fac[1], up, down,
                  (px0, px1, py0, py1))
    n, c, h, w = x.shape
    if up > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1])
        x = x.reshape(n, c, h * up, w * up)
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0):x.shape[2] - max(-py1, 0),
          max(-px0, 0):x.shape[3] - max(-px1, 0)]
    k = _fir_weight(kernel, x.device, x.dtype)
    wgt = k[None, None].expand(c, 1, k.shape[0], k.shape[1])
    return F.conv2d(x, wgt, stride=down, groups=c)


def _fir_weight(kernel: np.ndarray, device, dtype) -> torch.Tensor:
    """The flipped taps of ``kernel`` as a tensor on ``device``. The CNN
    uses a few fixed kernels, so each is copied to the device once and
    reused, not uploaded on every call."""
    k = np.ascontiguousarray(np.flip(kernel, (0, 1)))
    return _fir_weight_cached(k.tobytes(), k.shape, k.dtype.str, device,
                              dtype)


@functools.lru_cache(maxsize=64)
def _fir_weight_cached(taps, shape, np_dtype, device, dtype):
    k = np.frombuffer(taps, dtype=np_dtype).reshape(shape)
    return torch.as_tensor(k.copy(), dtype=dtype, device=device)


def _fused_leaky_relu(x, bias=None, negative_slope=0.2,
                      scale=math.sqrt(2.0)):
    if bias is not None:
        x = x + bias.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x >= 0, x, x * negative_slope) * scale


def _upsample(x, kernel: np.ndarray, factor: int = 2, plain: bool = False):
    p = kernel.shape[0] - factor
    return _upfirdn2d(x, kernel * (factor ** 2), up=factor, down=1,
                      pad=((p + 1) // 2 + factor - 1, p // 2), plain=plain)


def _downsample(x, kernel: np.ndarray, factor: int = 2, plain: bool = False):
    p = kernel.shape[0] - factor
    return _upfirdn2d(x, kernel, up=1, down=factor,
                      pad=((p + 1) // 2, p // 2), plain=plain)


def _blur(x, kernel: np.ndarray, pad, upsample_factor: int = 1):
    k = kernel * (upsample_factor ** 2) if upsample_factor > 1 else kernel
    return _upfirdn2d(x, k, pad=pad)


def haar_wavelets():
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    lo = np.full((1, 2), inv_sqrt2, dtype=np.float32)
    hi = np.array([[-inv_sqrt2, inv_sqrt2]], dtype=np.float32)
    return lo.T @ lo, hi.T @ lo, lo.T @ hi, hi.T @ hi  # ll, lh, hl, hh


def _haar_transform(x):
    """(N, C, H, W) -> (N, 4C, H/2, W/2), [ll, lh, hl, hh] channel blocks:
    out_s[i, j] = sum_{a,b} k_s[1-a, 1-b] * x[2i+a, 2j+b]."""
    n, c, h, w = x.shape
    p = x.reshape(n, c, h // 2, 2, w // 2, 2)
    outs = []
    for k in haar_wavelets():
        acc = None
        for a in (0, 1):
            for b in (0, 1):
                term = float(k[1 - a, 1 - b]) * p[:, :, :, a, :, b]
                acc = term if acc is None else acc + term
        outs.append(acc)
    return torch.cat(outs, dim=1)


def _depth_to_space2(o):
    """(N, 4c, H, W) phase-major [a, b, c] channels -> (N, c, 2H, 2W)."""
    n, c4, h, w = o.shape
    c = c4 // 4
    return (o.reshape(n, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2)
            .reshape(n, c, 2 * h, 2 * w))


def _space_to_depth2(x):
    """(N, c, 2H, 2W) -> (N, 4c, H, W) with phase-major [a, b, c] channels."""
    n, c, h2, w2 = x.shape
    h, w = h2 // 2, w2 // 2
    return (x.reshape(n, c, h, 2, w, 2).permute(0, 3, 5, 1, 2, 4)
            .reshape(n, 4 * c, h, w))


def _inverse_haar_transform(x):
    """(N, 4C, H, W) -> (N, C, 2H, 2W): y[2i+a, 2j+b] =
    ll*k_ll[a,b] - lh*k_lh[a,b] - hl*k_hl[a,b] + hh*k_hh[a,b]."""
    c = x.shape[1] // 4
    subs = (x[:, :c], x[:, c:2 * c], x[:, 2 * c:3 * c], x[:, 3 * c:])
    signs = (1.0, -1.0, -1.0, 1.0)
    phases = []
    for a in (0, 1):
        for b in (0, 1):
            acc = None
            for s, sg, k in zip(subs, signs, haar_wavelets()):
                term = (sg * float(k[a, b])) * s
                acc = term if acc is None else acc + term
            phases.append(acc)
    return _depth_to_space2(torch.cat(phases, dim=1))


def _wavelet_upsample(x, fir: Sequence[float] = (1, 3, 3, 1),
                      plain: bool = False):
    return _haar_transform(_upsample(_inverse_haar_transform(x),
                                     make_kernel(fir), plain=plain))


def _wavelet_downsample(x, fir: Sequence[float] = (1, 3, 3, 1)):
    return _haar_transform(_downsample(_inverse_haar_transform(x),
                                       make_kernel(fir)))


# ---------------------------------------------------------------------------
# Public NHWC API (the JAX package's layout)
# ---------------------------------------------------------------------------

def upfirdn2d(x, kernel, up: int = 1, down: int = 1, pad=(0, 0)):
    """x (N, H, W, C); kernel (kh, kw); pad (p0, p1) or (px0, px1, py0, py1)."""
    return _nhwc(_upfirdn2d, x, kernel, up, down, pad)


def fused_leaky_relu(x, bias=None, negative_slope: float = 0.2,
                     scale: float = math.sqrt(2.0)):
    """bias-add over the last axis + LeakyReLU(slope) * scale."""
    if bias is not None:
        x = x + bias
    return torch.where(x >= 0, x, x * negative_slope) * scale


def upsample(x, kernel: np.ndarray, factor: int = 2):
    return _nhwc(_upsample, x, kernel, factor)


def downsample(x, kernel: np.ndarray, factor: int = 2):
    return _nhwc(_downsample, x, kernel, factor)


def blur(x, kernel: np.ndarray, pad, upsample_factor: int = 1):
    return _nhwc(_blur, x, kernel, pad, upsample_factor)


def haar_transform(x):
    return _nhwc(_haar_transform, x)


def inverse_haar_transform(x):
    return _nhwc(_inverse_haar_transform, x)


def depth_to_space2(o):
    return _nhwc(_depth_to_space2, o)


def space_to_depth2(x):
    return _nhwc(_space_to_depth2, x)


def wavelet_upsample(x, fir: Sequence[float] = (1, 3, 3, 1)):
    return _nhwc(_wavelet_upsample, x, fir)


def wavelet_downsample(x, fir: Sequence[float] = (1, 3, 3, 1)):
    return _nhwc(_wavelet_downsample, x, fir)
