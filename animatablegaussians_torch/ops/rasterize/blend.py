"""Per-tile front-to-back alpha compositing (forward only).

Port of ``animatablegaussians_tpu/ops/rasterize/blend_pallas.py``
(``_fwd_chunk_kernel`` and ``_fwd_kernel``) and of its pure-JAX oracle
``blend_ref.py``. The CUDA kernel is ``csrc/blend.cu``;
``blend_tiles_plain`` is its plain PyTorch version, ``blend_ref``'s
cumulative-product form. ``blend_tiles`` runs the plain version for tensors
on the CPU and the kernel for tensors on a CUDA device; it never falls back
from one to the other.

A tile's list is the range ``gid[starts[t]:starts[t+1]]`` of the sorted
pair list (``binning.TileBins``); rows are the packed ``(N, 10)`` per-Gaussian
``[x y ca cb cc op r g b depth]`` of ``api._pack_rows``. Outputs are
image-shaped: colour (H, W, 3), depth (H, W) and final transmittance
(H, W), which is 1 where nothing contributed.
"""

from __future__ import annotations

from typing import Tuple

import torch

ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
ALPHA_CLAMP = 0.99
TILE = 16
ROW = 10
# elements of one (tiles, pixels, pairs) block in the plain version: about
# ten float32 temporaries of this size are live at once (~0.7 GB)
_PLAIN_BLOCK_ELEMS = 1 << 24


def _untile(out_t, grid_x: int, grid_y: int, img_h: int, img_w: int):
    """(T, P, C) per-tile pixels -> (H, W, C) image crop."""
    c = out_t.shape[-1]
    img = out_t.reshape(grid_y, grid_x, TILE, TILE, c).permute(0, 2, 1, 3, 4)
    return img.reshape(grid_y * TILE, grid_x * TILE, c)[:img_h, :img_w]


def _tile_batches(counts: list, order: list):
    """Group tiles (in ascending-count order) so each group's padded
    (tiles, pixels, max count) block stays under the element budget."""
    batch, kmax = [], 0
    for t in order:
        k = counts[t]
        if k == 0:
            continue
        if batch and (len(batch) + 1) * max(kmax, k) * TILE * TILE \
                > _PLAIN_BLOCK_ELEMS:
            yield batch, kmax
            batch, kmax = [], 0
        batch.append(t)
        kmax = max(kmax, k)
    if batch:
        yield batch, kmax


def blend_tiles_plain(rows, gid, starts, grid_x: int, grid_y: int,
                      img_w: int, img_h: int):
    """``blend_ref.blend_tiles_ref`` over ragged tile ranges, in batches of
    tiles of similar count so memory stays bounded at full scale."""
    dev = rows.device
    n_tiles = grid_x * grid_y
    P = TILE * TILE
    out = torch.zeros((n_tiles, P, 5), dtype=torch.float32, device=dev)
    out[:, :, 4] = 1.0
    counts_t = starts[1:] - starts[:-1]
    counts = counts_t.tolist()
    order = torch.argsort(counts_t.cpu(), stable=True).tolist()
    lp = torch.arange(P, device=dev)
    for batch, kmax in _tile_batches(counts, order):
        tb = torch.tensor(batch, device=dev)
        k = torch.arange(kmax, device=dev)
        idx = starts[tb][:, None] + k[None, :]                  # (B, K)
        kmask = k[None, :] < counts_t[tb][:, None]
        g = gid[torch.clamp(idx, max=gid.shape[0] - 1)]
        data = rows[g.long()]                                   # (B, K, 10)
        x, y = data[..., 0], data[..., 1]
        ca, cb, cc, op = data[..., 2], data[..., 3], data[..., 4], data[..., 5]
        pxx = ((tb % grid_x) * TILE)[:, None] + lp[None] % TILE   # (B, P)
        pxy = ((tb // grid_x) * TILE)[:, None] + lp[None] // TILE
        dx = x[:, None, :] - pxx.to(torch.float32)[:, :, None]   # (B, P, K)
        dy = y[:, None, :] - pxy.to(torch.float32)[:, :, None]
        cb_, ca_, cc_ = cb[:, None], ca[:, None], cc[:, None]
        power = -0.5 * (ca_ * dx * dx + cc_ * dy * dy) - cb_ * dx * dy
        alpha = torch.clamp(op[:, None] * torch.exp(power), max=ALPHA_CLAMP)
        use = kmask[:, None, :] & (alpha >= ALPHA_MIN) & (power <= 0.0)
        alpha = torch.where(use, alpha, torch.zeros_like(alpha))
        pinc = torch.cumprod(1.0 - alpha, dim=2)
        pexc = torch.cat([torch.ones_like(pinc[..., :1]), pinc[..., :-1]], 2)
        contrib = use & (pinc >= T_EPS)
        w = torch.where(contrib, alpha * pexc, torch.zeros_like(alpha))
        rgb = torch.bmm(w, data[..., 6:9])                       # (B, P, 3)
        depth = torch.sum(w * data[:, None, :, 9], dim=2)
        t_fin = torch.amin(torch.where(contrib, pinc, torch.ones_like(pinc)),
                           dim=2)
        out[tb] = torch.cat([rgb, depth[..., None], t_fin[..., None]], -1)
    img = _untile(out, grid_x, grid_y, img_h, img_w)
    return img[..., :3], img[..., 3], img[..., 4]


def blend_tiles(rows, gid, starts, grid_x: int, grid_y: int, img_w: int,
                img_h: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``blend_tiles_plain`` on the CPU, ``csrc/blend.cu`` on a GPU."""
    if rows.device.type == "cpu":
        return blend_tiles_plain(rows, gid, starts, grid_x, grid_y, img_w,
                                 img_h)
    if rows.device.type != "cuda":
        raise ValueError(f"blend_tiles: unsupported device {rows.device}")
    from animatablegaussians_torch.utils import cuda_build

    n_tiles = grid_x * grid_y
    if (rows.dtype != torch.float32 or rows.dim() != 2
            or rows.shape[1] != ROW or gid.dtype != torch.int32
            or starts.dtype != torch.int64 or starts.shape != (n_tiles + 1,)
            or img_w > grid_x * TILE or img_h > grid_y * TILE):
        raise ValueError("blend_tiles: want rows (N, 10) float32, gid int32, "
                         "starts (T+1,) int64 for a grid covering the image")
    if not (gid.device == starts.device == rows.device):
        raise ValueError("blend_tiles: inputs on different devices")
    rows, gid, starts = rows.contiguous(), gid.contiguous(), starts.contiguous()
    dev = rows.device
    color = torch.empty((img_h, img_w, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((img_h, img_w), dtype=torch.float32, device=dev)
    t_final = torch.empty((img_h, img_w), dtype=torch.float32, device=dev)
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.ag_blend_forward(
            rows.data_ptr(), gid.data_ptr(), starts.data_ptr(), grid_x,
            grid_y, img_w, img_h, color.data_ptr(), depth.data_ptr(),
            t_final.data_ptr(), cuda_build.stream_of(rows))
    cuda_build.check(err, "blend_tiles")
    blend_tiles.launches += 1
    return color, depth, t_final


blend_tiles.launches = 0  # kernel launches; reset by whoever counts them
