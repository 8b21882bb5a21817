"""Pair expansion: (tile, depth) sort keys and gids for every (Gaussian,
tile) pair.

Port of ``animatablegaussians_tpu/ops/rasterize/expand_pallas.py``
(``_expand_kernel``). The CUDA kernel is ``csrc/expand.cu``;
``expand_pairs_plain`` is its plain PyTorch version. ``expand_pairs`` runs
the plain version for tensors on the CPU and the kernel for tensors on a
CUDA device; it never falls back from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from animatablegaussians_torch.utils.profiling import count


def _keys(tile_id: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """int64 (tile << 32) | float_bits(depth); depth > 0 orders like its
    bits."""
    bits = depth.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return (tile_id.to(torch.int64) << 32) | bits


def expand_pairs_plain(rect: torch.Tensor, depth: torch.Tensor,
                       offs: torch.Tensor, total: int,
                       grid_x: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """rect (N, 4) int32 [rx0, ry0, width, cnt]; depth (N,) f32; offs
    (N+1,) int64 exclusive cumsum of cnt with offs[N] == total. Returns
    (keys (total,) int64, gids (total,) int32), Gaussian i owning slots
    [offs[i], offs[i+1]) in ascending gid order."""
    n = rect.shape[0]
    cnt = rect[:, 3].to(torch.int64)
    gid = torch.repeat_interleave(
        torch.arange(n, device=rect.device), cnt, output_size=total)
    d = torch.arange(total, device=rect.device) - offs[gid]
    r = rect[gid].to(torch.int64)
    ty = r[:, 1] + torch.div(d, r[:, 2], rounding_mode="floor")
    tx = r[:, 0] + torch.remainder(d, r[:, 2])
    return _keys(ty * grid_x + tx, depth[gid]), gid.to(torch.int32)


def expand_pairs(rect: torch.Tensor, depth: torch.Tensor, offs: torch.Tensor,
                 total: int, grid_x: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``expand_pairs_plain`` on the CPU, ``csrc/expand.cu`` on a GPU."""
    if rect.device.type == "cpu":
        return expand_pairs_plain(rect, depth, offs, total, grid_x)
    if rect.device.type != "cuda":
        raise ValueError(f"expand_pairs: unsupported device {rect.device}")
    from animatablegaussians_torch.utils import cuda_build

    n = rect.shape[0]
    if (rect.dtype != torch.int32 or rect.shape != (n, 4)
            or depth.dtype != torch.float32 or depth.shape != (n,)
            or offs.dtype != torch.int64 or offs.shape != (n + 1,)):
        raise ValueError("expand_pairs: want rect (N, 4) int32, depth (N,) "
                         "float32, offs (N+1,) int64")
    if not (depth.device == offs.device == rect.device):
        raise ValueError("expand_pairs: inputs on different devices")
    rect, depth, offs = rect.contiguous(), depth.contiguous(), offs.contiguous()
    keys = torch.empty((total,), dtype=torch.int64, device=rect.device)
    gids = torch.empty((total,), dtype=torch.int32, device=rect.device)
    lib = cuda_build.load()
    with torch.cuda.device(rect.device):
        err = lib.ag_expand_pairs(
            rect.data_ptr(), depth.data_ptr(), offs.data_ptr(), n, grid_x,
            keys.data_ptr(), gids.data_ptr(), cuda_build.stream_of(rect))
    cuda_build.check(err, "expand_pairs")
    count("expand.launches")
    return keys, gids
