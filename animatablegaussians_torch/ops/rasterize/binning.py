"""Tile binning, sized per frame from the exact pair count.

Port of ``animatablegaussians_tpu/ops/rasterize/binning.py:90-98,117-308``.
The JAX package binned into static, capped buffers; here, as in the CUDA
reference rasterizer, the pair count is read back once per frame (one host
sync) and the buffers are allocated to fit, so ``max_dup``, ``k_max``,
``max_pairs``, the active-tile cap and ``n_overflow`` have no counterpart.

Pipeline: tile rectangles -> per-Gaussian counts -> exclusive cumsum ->
pair expansion (``expand.py``, a CUDA kernel on the GPU) -> stable sort of
the (tile << 32 | depth bits) keys -> per-tile [start, end) ranges by
searchsorted. Invalid and pad Gaussians get a count of 0 and are never
binned.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from animatablegaussians_torch.utils.profiling import count, span

from .expand import expand_pairs, expand_pairs_plain


class TileBins(NamedTuple):
    gid: torch.Tensor      # (n_pairs,) int32 Gaussian ids, (tile, depth) order
    starts: torch.Tensor   # (T+1,) int64: tile t owns gid[starts[t]:starts[t+1]]
    n_pairs: int           # total (Gaussian, tile) pairs (num_rendered)


def tile_rect(means2d, radii, grid_x: int, grid_y: int, tile: int):
    """Tile-rect bounds per Gaussian (ref: auxiliary.h getRect)."""
    x, y = means2d[:, 0], means2d[:, 1]
    r = radii.to(means2d.dtype)

    def edge(v, hi):
        return torch.clamp(torch.floor(v / tile), 0, hi).to(torch.int32)

    return (edge(x - r, grid_x), edge(y - r, grid_y),
            edge(x + r + tile - 1, grid_x), edge(y + r + tile - 1, grid_y))


def pair_counts(means2d, radii, valid, grid_x: int, grid_y: int,
                tile: int = 16):
    """Per-Gaussian rect (N, 4) int32 [rx0, ry0, width, cnt] (cnt = 0 for
    invalid Gaussians) and its exclusive cumsum offs (N+1,) int64."""
    rx0, ry0, rx1, ry1 = tile_rect(means2d, radii, grid_x, grid_y, tile)
    width = rx1 - rx0
    cnt = torch.where(valid, width * (ry1 - ry0), torch.zeros_like(width))
    offs = torch.nn.functional.pad(torch.cumsum(cnt, 0, dtype=torch.int64),
                                   (1, 0))
    return torch.stack([rx0, ry0, width, cnt], dim=1), offs


def bin_gaussians(means2d, depths, radii, valid, img_w: int, img_h: int,
                  tile: int = 16, plain: bool = False) -> TileBins:
    """``plain=True`` runs the expansion's plain PyTorch version on any
    device (the reference the kernel is checked against)."""
    grid_x = -(-img_w // tile)
    grid_y = -(-img_h // tile)
    with span("splat.binning") as sp:
        rect, offs = pair_counts(means2d, radii, valid, grid_x, grid_y, tile)
        with span("wait.pairs"):
            total = int(offs[-1])               # the one host sync per frame
        count("host.waits")
        count("splat.frames")
        count("splat.pairs", total)
        sp.set(pairs=total)
        expand = expand_pairs_plain if plain else expand_pairs
        keys, gids = expand(rect, depths.to(torch.float32), offs, total,
                            grid_x)

        keys, perm = torch.sort(keys, stable=True)
        gid = gids[perm]
        tiles = torch.arange(grid_x * grid_y + 1, device=keys.device,
                             dtype=torch.int64)
        starts = torch.searchsorted(keys >> 32, tiles)
    return TileBins(gid=gid, starts=starts, n_pairs=total)
