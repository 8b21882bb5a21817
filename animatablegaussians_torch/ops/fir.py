"""Separable up-FIR-down resampling (upfirdn2d) through a hand-written
kernel, and its gradient.

Port of ``animatablegaussians_tpu/ops/fir_pallas.py`` (``_vhfir_kernel``,
launched by ``_pallas_core``, and the ``upfirdn2d_pallas`` custom VJP). The
CUDA kernel is ``csrc/fir.cu``; ``upfirdn2d_fir_plain`` is its plain PyTorch
version, the same arithmetic step by step: vertical taps first, then
horizontal, float32, taps reversed (a true convolution). The layout is the
port's NCHW; the kernel walks the N x C image planes.

``upfirdn2d_fir`` is differentiable (``_FIR``, a ``torch.autograd.Function``):
its backward is the same operator on the cotangent with the taps reversed,
``up`` and ``down`` swapped and the grad pads of ``grad_pads``, as
``fir_pallas._bwd``. The operator is linear, so that backward is itself
differentiable (``_FIRGrad``): the derivative of the transposed call with
respect to its cotangent is the forward call, which an R1 penalty (a
gradient of a gradient) launches. Every direction goes through ``_launch``
(the derivatives by way of ``_launch_grad`` and ``_launch_grad2``),
which runs the plain version for tensors on the CPU and the kernel for
tensors on a CUDA device; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from animatablegaussians_torch.utils import cuda_build
from animatablegaussians_torch.utils.profiling import count

MAX_TAPS = 4   # the TPU kernel's HALO: taps per axis the kernel takes


def separable_factors(kernel: np.ndarray) -> Optional[Tuple[np.ndarray,
                                                          np.ndarray]]:
    """(kh, kw) 2-D FIR -> (kv (kh,), kh (kw,)) float32 if it is rank 1
    with at most ``MAX_TAPS`` taps per axis, else None. The float64 SVD,
    the cast to float32 and the sign split follow
    ``fir_pallas.separable_factors`` exactly, so the taps round alike."""
    k = np.asarray(kernel, np.float64)
    if k.ndim != 2 or min(k.shape) < 1 or max(k.shape) > MAX_TAPS:
        return None
    u, s, vt = np.linalg.svd(k)
    if min(k.shape) > 1 and s[1] > 1e-6 * max(s[0], 1e-30):
        return None
    g = math.sqrt(float(s[0]))
    kv = (u[:, 0] * g).astype(np.float32)
    kh_ = (vt[0] * g).astype(np.float32)
    if kv.sum() < 0 and kh_.sum() < 0:  # stabilize the sign split
        kv, kh_ = -kv, -kh_
    return kv, kh_


def out_len(n: int, k: int, up: int, down: int, p0: int, p1: int) -> int:
    """Output length along one axis (``fir_pallas._out_len``): the up - 1
    trailing stuffed zeros are folded into the right pad."""
    return (n * up + p0 + p1 - k) // down + 1


def grad_pads(in_hw: Tuple[int, int], nv: int, nh: int, up: int, down: int,
              pad: Tuple[int, int, int, int]) -> Tuple[int, int, int, int]:
    """Pads of the transposed operator (``fir_pallas._bwd``): the gradient
    of a call on an (H, W) input with ``nv`` x ``nh`` taps is the call on
    the cotangent with up and down swapped and these pads (some may be
    negative)."""
    px0, px1, py0, py1 = pad
    h, w = in_hw
    oh = out_len(h, nv, up, down, py0, py1)
    ow = out_len(w, nh, up, down, px0, px1)
    return (nh - px0 - 1, w * up - ow * down + px0 - up + 1,
            nv - py0 - 1, h * up - oh * down + py0 - up + 1)


def _axis_plain(x: torch.Tensor, taps: Sequence[float], up: int, down: int,
                pad0: int, n_out: int, dim: int) -> torch.Tensor:
    """1-D upfirdn along ``dim``: out[o] = sum_m rev(taps)[m] * xs[o * down
    + m - pad0], xs the zero-stuffed input, zero outside it; the terms are
    added in tap order, as ``fir_pallas._axis_fir`` adds them."""
    if up > 1:
        shape = list(x.shape)
        stuffed = x.new_zeros(shape[:dim] + [shape[dim], up] + shape[dim + 1:])
        stuffed.select(dim + 1, 0).copy_(x)
        x = stuffed.flatten(dim, dim + 1)
    n = x.shape[dim]
    span = (n_out - 1) * down + 1
    lo = max(0, pad0)
    hi = max(0, len(taps) - 1 - pad0 + span - n)
    widths = [0, 0] * (x.dim() - 1 - dim) + [lo, hi]
    xp = F.pad(x, widths)
    lead = (slice(None),) * dim
    acc = None
    for m, t in enumerate(reversed(taps)):
        start = m - pad0 + lo
        part = xp[lead + (slice(start, start + span, down),)]
        term = part * t
        acc = term if acc is None else acc + term
    return acc


def upfirdn2d_fir_plain(x: torch.Tensor, kv: Sequence[float],
                        kh: Sequence[float], up: int, down: int,
                        pad: Tuple[int, int, int, int]) -> torch.Tensor:
    """x (N, C, H, W) float32; kv, kh tap sequences; pad (px0, px1, py0,
    py1). The arithmetic of ``csrc/fir.cu`` in PyTorch ops: the vertical
    pass over every input column, then the horizontal pass."""
    px0, px1, py0, py1 = pad
    _, _, h, w = x.shape
    oh = out_len(h, len(kv), up, down, py0, py1)
    ow = out_len(w, len(kh), up, down, px0, px1)
    y = _axis_plain(x, kv, up, down, py0, oh, dim=2)
    return _axis_plain(y, kh, up, down, px0, ow, dim=3)


def _check(x: torch.Tensor, kv, kh, up: int, down: int, pad) -> None:
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("upfirdn2d_fir: want x (N, C, H, W) float32 "
                         f"contiguous, got {x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")
    if not (1 <= len(kv) <= MAX_TAPS and 1 <= len(kh) <= MAX_TAPS
            and up in (1, 2) and down in (1, 2) and len(pad) == 4):
        raise ValueError(f"upfirdn2d_fir: want 1-{MAX_TAPS} taps per axis, "
                         f"up and down 1 or 2 and four pads, got {len(kv)}, "
                         f"{len(kh)}, {up}, {down}, {pad}")


class _Params(ctypes.Structure):
    """``csrc/fir.cu``'s ``FirParams``: the call's shape, pads and taps."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "n", "c", "h", "w", "oh", "ow", "up", "down", "px0", "py0", "nv",
        "nh")] + [("v", ctypes.c_float * MAX_TAPS),
                  ("hz", ctypes.c_float * MAX_TAPS)]


# (input shape, kv, kh, up, down, pad) -> (output shape, _Params, its
# address; the entry keeps the struct alive): the CNN makes a few dozen
# distinct calls, each checked and packed once
_PLANS: dict = {}
_kernel = None  # the C entry, resolved at the first launch


def _plan(x: torch.Tensor, kv, kh, up: int, down: int, pad):
    _check(x, kv, kh, up, down, pad)
    px0, px1, py0, py1 = (int(p) for p in pad)
    n, c, h, w = x.shape
    oh = out_len(h, len(kv), up, down, py0, py1)
    ow = out_len(w, len(kh), up, down, px0, px1)
    if oh < 1 or ow < 1:
        raise ValueError(f"upfirdn2d_fir: empty output {oh}x{ow}")
    if max(x.numel(), n * c * oh * ow) >= 2 ** 31:
        raise ValueError("upfirdn2d_fir: the kernel indexes with 32-bit "
                         f"ints; {tuple(x.shape)} -> {oh}x{ow} is too large")
    prm = _Params(n, c, h, w, oh, ow, up, down, px0, py0, len(kv), len(kh))
    prm.v[:len(kv)] = [float(t) for t in kv]
    prm.hz[:len(kh)] = [float(t) for t in kh]
    plan = ((n, c, oh, ow), prm, ctypes.addressof(prm))
    _PLANS[(x.shape, kv, kh, up, down, pad)] = plan
    return plan


def _launch(x: torch.Tensor, kv, kh, up: int, down: int,
            pad) -> torch.Tensor:
    """One resampling without autograd: ``upfirdn2d_fir_plain`` on the
    CPU, ``csrc/fir.cu`` on a GPU. The GPU route is short because it runs
    ~180 times a train step, mostly on maps the card finishes in
    microseconds: the call's checks and packed arguments are looked up by
    its shape, the C entry is resolved once, the stream's raw handle is
    read without a ``Stream`` object, and the device is switched only when
    ``x`` is not on the current one."""
    global _kernel
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"upfirdn2d_fir: unsupported device {x.device}")
        _check(x, kv, kh, up, down, pad)
        return upfirdn2d_fir_plain(x, kv, kh, up, down, pad)
    if x.dtype != torch.float32 or not x.is_contiguous():
        _check(x, kv, kh, up, down, pad)            # raises
    plan = _PLANS.get((x.shape, kv, kh, up, down, pad))
    if plan is None:
        plan = _plan(x, kv, kh, up, down, pad)
    dev = x.get_device()
    if dev != torch._C._cuda_getDevice():
        with torch.cuda.device(dev):
            return _launch(x, kv, kh, up, down, pad)
    if _kernel is None:
        _kernel = cuda_build.load().ag_upfirdn2d_fir
    out = x.new_empty(plan[0])
    err = _kernel(x.data_ptr(), out.data_ptr(), plan[2],
                  torch._C._cuda_getCurrentRawStream(dev))
    if err:
        cuda_build.check(err, "upfirdn2d_fir")
    count("fir.launches")
    return out


@functools.lru_cache(maxsize=256)
def _grad_args(hw, kv, kh, up: int, down: int, pad):
    """``_launch``'s arguments for the gradient of a call on an (H, W)
    input: taps reversed, up and down swapped, ``grad_pads``."""
    return (tuple(reversed(kv)), tuple(reversed(kh)), down, up,
            grad_pads(hw, len(kv), len(kh), up, down, pad))


def _launch_grad(g: torch.Tensor, args) -> torch.Tensor:
    """The first derivative of the call ``args`` (``_FIR.forward``'s
    ``ctx.args``): the transposed call on the cotangent ``g``."""
    return _launch(g, *_grad_args(*args))


def _launch_grad2(gg: torch.Tensor, args) -> torch.Tensor:
    """The second derivative of the call ``args``: the call itself on
    ``gg``, the cotangent of its first derivative's output."""
    return _launch(gg, *args[1:])


class _FIR(torch.autograd.Function):
    """``_launch`` with the transposed operator as its gradient
    (``fir_pallas._bwd``); only ``x`` gets a gradient. The transposed call
    is launched directly unless a graph of the backward is being built
    for a cotangent that carries a gradient, which ``_FIRGrad`` records."""

    @staticmethod
    def forward(ctx, x, kv, kh, up, down, pad):
        ctx.args = (tuple(x.shape[2:]), kv, kh, up, down, pad)
        return _launch(x, kv, kh, up, down, pad)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if g.requires_grad and torch.is_grad_enabled():
            return (_FIRGrad.apply(g, ctx.args),) + (None,) * 5
        return (_launch_grad(g, ctx.args),) + (None,) * 5


class _FIRGrad(torch.autograd.Function):
    """The transposed call of ``_FIR.backward`` (the same launch,
    ``_launch_grad``) as a differentiable function of the cotangent: its
    gradient is the transpose of the transpose, the forward call with the
    forward's own arguments, which lands on the forward's output shape
    whatever the floor in ``out_len`` dropped."""

    @staticmethod
    def forward(ctx, g, args):
        ctx.args = args
        return _launch_grad(g, args)

    @staticmethod
    def backward(ctx, gg):
        gg = gg.contiguous()
        if gg.requires_grad and torch.is_grad_enabled():
            return _FIR.apply(gg, *ctx.args[1:]), None
        return _launch_grad2(gg, ctx.args), None


def upfirdn2d_fir(x: torch.Tensor, kv: Sequence[float], kh: Sequence[float],
                  up: int, down: int,
                  pad: Tuple[int, int, int, int]) -> torch.Tensor:
    """Differentiable separable upfirdn2d of x (N, C, H, W) float32 with
    tap sequences ``kv`` (vertical) and ``kh`` (horizontal) and pad (px0,
    px1, py0, py1): the plain version on the CPU, the kernel on a GPU,
    forward and backward. A call that needs no gradient skips the
    ``autograd.Function``, whose own host cost is about that of the rest
    of the launch."""
    args = (tuple(kv), tuple(kh), int(up), int(down),
            tuple(int(p) for p in pad))
    if x.requires_grad and torch.is_grad_enabled():
        return _FIR.apply(x, *args)
    return _launch(x, *args)
