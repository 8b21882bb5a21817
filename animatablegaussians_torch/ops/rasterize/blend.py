"""Per-tile front-to-back alpha compositing and its gradient.

Port of ``animatablegaussians_tpu/ops/rasterize/blend_pallas.py``
(``_fwd_chunk_kernel`` and ``_fwd_kernel``; ``_bwd_chunk_kernel`` and
``_bwd_kernel`` with the scatter-add to rows of ``api.py`` ``_sc_bwd``)
and of its pure-JAX oracle ``blend_ref.py``. The CUDA kernels are
``csrc/blend.cu`` (forward) and ``csrc/blend_bwd.cu`` (backward);
``blend_tiles_plain`` and ``blend_backward_plain`` are their plain PyTorch
versions, ``blend_ref``'s cumulative-product form and the analytic VJP of
``_bwd_kernel``. The wrappers ``blend_tiles`` and ``blend_backward`` run
the plain version for tensors on the CPU and the kernel for tensors on a
CUDA device; they never fall back from one to the other. ``BlendTiles``
is the ``torch.autograd.Function`` that joins the two.

A tile's list is the range ``gid[starts[t]:starts[t+1]]`` of the sorted
pair list (``binning.TileBins``); rows are the packed ``(N, 10)`` per-Gaussian
``[x y ca cb cc op r g b depth]`` of ``api._pack_rows``. Outputs are
image-shaped: colour (H, W, 3), depth (H, W) and final transmittance
(H, W), which is 1 where nothing contributed.
"""

from __future__ import annotations

from typing import Tuple

import torch

from animatablegaussians_torch.utils.profiling import count, span

ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
ALPHA_CLAMP = 0.99
TILE = 16
ROW = 10
# elements of one (tiles, pixels, pairs) block in the plain versions: about
# ten float32 temporaries of this size are live at once in the forward
# (~0.7 GB), about twenty in the backward (~1.3 GB)
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


def _tile_view(img, grid_x: int, grid_y: int):
    """(H, W, C) image -> (T, P, C) per-tile pixels, zero past the image
    edge (the inverse of ``_untile``)."""
    h, w, c = img.shape
    img = torch.nn.functional.pad(img, (0, 0, 0, grid_x * TILE - w,
                                        0, grid_y * TILE - h))
    return img.reshape(grid_y, TILE, grid_x, TILE, c).permute(
        0, 2, 1, 3, 4).reshape(grid_x * grid_y, TILE * TILE, c)


def _batches(rows, gid, starts, grid_x: int):
    """Yield, per batch of tiles of similar count: the tile ids (B,), the
    pair gids (B, K), the mask of real pairs (B, K), their rows (B, K, 10)
    and the per-pair geometry the blend and its gradient share, as (B, P,
    K) tensors: dx, dy, G = exp(power), alpha (zeroed where unused), op G
    and ``use``."""
    dev = rows.device
    P = TILE * TILE
    counts_t = starts[1:] - starts[:-1]
    counts = counts_t.tolist()
    order = torch.argsort(counts_t.cpu(), stable=True).tolist()
    lp = torch.arange(P, device=dev)
    for batch, kmax in _tile_batches(counts, order):
        tb = torch.tensor(batch, device=dev)
        k = torch.arange(kmax, device=dev)
        idx = starts[tb][:, None] + k[None, :]                  # (B, K)
        kmask = k[None, :] < counts_t[tb][:, None]
        g = gid[torch.clamp(idx, max=gid.shape[0] - 1)].long()
        data = rows[g]                                          # (B, K, 10)
        x, y = data[..., 0], data[..., 1]
        ca, cb, cc, op = data[..., 2], data[..., 3], data[..., 4], data[..., 5]
        pxx = ((tb % grid_x) * TILE)[:, None] + lp[None] % TILE   # (B, P)
        pxy = ((tb // grid_x) * TILE)[:, None] + lp[None] // TILE
        dx = x[:, None, :] - pxx.to(torch.float32)[:, :, None]   # (B, P, K)
        dy = y[:, None, :] - pxy.to(torch.float32)[:, :, None]
        cb_, ca_, cc_ = cb[:, None], ca[:, None], cc[:, None]
        power = -0.5 * (ca_ * dx * dx + cc_ * dy * dy) - cb_ * dx * dy
        G = torch.exp(power)
        alpha_raw = op[:, None] * G
        alpha = torch.clamp(alpha_raw, max=ALPHA_CLAMP)
        use = kmask[:, None, :] & (alpha >= ALPHA_MIN) & (power <= 0.0)
        alpha = torch.where(use, alpha, torch.zeros_like(alpha))
        yield tb, g, kmask, data, dict(dx=dx, dy=dy, G=G, alpha=alpha,
                                       alpha_raw=alpha_raw, use=use)


def _transmittance(alpha, use):
    """(pinc, pexc, contrib, w) of ``blend_ref``'s cumulative-product form."""
    pinc = torch.cumprod(1.0 - alpha, dim=2)
    pexc = torch.cat([torch.ones_like(pinc[..., :1]), pinc[..., :-1]], 2)
    contrib = use & (pinc >= T_EPS)
    w = torch.where(contrib, alpha * pexc, torch.zeros_like(alpha))
    return pinc, pexc, contrib, w


def blend_tiles_plain(rows, gid, starts, grid_x: int, grid_y: int,
                      img_w: int, img_h: int):
    """``blend_ref.blend_tiles_ref`` over ragged tile ranges, in batches of
    tiles of similar count so memory stays bounded at full scale."""
    n_tiles = grid_x * grid_y
    P = TILE * TILE
    out = torch.zeros((n_tiles, P, 5), dtype=torch.float32,
                      device=rows.device)
    out[:, :, 4] = 1.0
    for tb, _, _, data, geo in _batches(rows, gid, starts, grid_x):
        pinc, _, contrib, w = _transmittance(geo["alpha"], geo["use"])
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
    if rows.data_ptr() % 8:
        raise ValueError("blend_tiles: rows must be 8-byte aligned (the "
                         "kernel stages them with 8-byte copies)")
    dev = rows.device
    color = torch.empty((img_h, img_w, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((img_h, img_w), dtype=torch.float32, device=dev)
    t_final = torch.empty((img_h, img_w), dtype=torch.float32, device=dev)
    order = torch.empty((n_tiles,), dtype=torch.int32, device=dev)  # scratch
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.ag_blend_forward(
            rows.data_ptr(), gid.data_ptr(), starts.data_ptr(),
            order.data_ptr(), grid_x, grid_y, img_w, img_h, color.data_ptr(),
            depth.data_ptr(), t_final.data_ptr(), cuda_build.stream_of(rows))
    cuda_build.check(err, "blend_tiles")
    count("blend.fwd.launches")
    return color, depth, t_final


def blend_backward_plain(rows, gid, starts, grid_x: int, grid_y: int,
                         img_w: int, img_h: int, color, depth, t_final,
                         g_color, g_depth, g_tfinal):
    """The VJP of ``blend_tiles`` with respect to ``rows``: the analytic
    gradient of ``_bwd_kernel`` (blend_pallas.py:189-240) over the same
    tile batches as ``blend_tiles_plain``, index-added into (N, 10).
    ``color``, ``depth`` and ``t_final`` are the forward's outputs (colour
    before the background blend), ``g_*`` their cotangents."""
    res = _tile_view(torch.cat([color, depth[..., None], t_final[..., None]],
                               -1), grid_x, grid_y)              # (T, P, 5)
    cot = _tile_view(torch.cat([g_color, g_depth[..., None],
                                g_tfinal[..., None]], -1), grid_x, grid_y)
    grad = torch.zeros((rows.shape[0], ROW), dtype=torch.float32,
                       device=rows.device)
    for tb, g, kmask, data, geo in _batches(rows, gid, starts, grid_x):
        alpha, G, dx, dy = geo["alpha"], geo["G"], geo["dx"], geo["dy"]
        _, pexc, contrib, w = _transmittance(alpha, geo["use"])
        one_minus = 1.0 - alpha
        r, c = res[tb], cot[tb]                                  # (B, P, 5)
        direct = torch.zeros_like(alpha)
        suffix_dot = torch.zeros_like(alpha)
        for i in range(4):
            ck = data[:, None, :, 6 + i]                         # (B, 1, K)
            gi = c[..., i:i + 1]
            prefix = torch.cumsum(w * ck, dim=2)
            direct = direct + ck * gi
            suffix_dot = suffix_dot + (r[..., i:i + 1] - prefix) * gi
        galpha = (pexc * direct - suffix_dot / one_minus
                  - c[..., 4:5] * r[..., 4:5] / one_minus)
        # contributing pairs only, and the clamp gate (jax.grad semantics)
        keep = contrib & (geo["alpha_raw"] < ALPHA_CLAMP)
        galpha = torch.where(keep, galpha, torch.zeros_like(galpha))
        ca, cb, cc, op = (data[:, None, :, i] for i in (2, 3, 4, 5))
        gpower = galpha * op * G
        terms = [
            -gpower * (ca * dx + cb * dy),
            -gpower * (cc * dy + cb * dx),
            -0.5 * dx * dx * gpower,
            -dx * dy * gpower,
            -0.5 * dy * dy * gpower,
            galpha * G,
        ] + [w * c[..., i:i + 1] for i in range(4)]
        per_pair = torch.stack([t.sum(dim=1) for t in terms], -1)  # (B, K, 10)
        grad.index_add_(0, g[kmask], per_pair[kmask])
    return grad


def blend_backward(rows, gid, starts, grid_x: int, grid_y: int, img_w: int,
                   img_h: int, color, depth, t_final, g_color, g_depth,
                   g_tfinal) -> torch.Tensor:
    """``blend_backward_plain`` on the CPU, ``csrc/blend_bwd.cu`` on a
    GPU. Returns grad_rows (N, 10) float32."""
    if rows.device.type == "cpu":
        return blend_backward_plain(rows, gid, starts, grid_x, grid_y, img_w,
                                    img_h, color, depth, t_final, g_color,
                                    g_depth, g_tfinal)
    if rows.device.type != "cuda":
        raise ValueError(f"blend_backward: unsupported device {rows.device}")
    from animatablegaussians_torch.utils import cuda_build

    n_tiles = grid_x * grid_y
    images = (color, depth, t_final, g_color, g_depth, g_tfinal)
    shapes = [(img_h, img_w, 3), (img_h, img_w), (img_h, img_w)] * 2
    if (rows.dtype != torch.float32 or rows.dim() != 2
            or rows.shape[1] != ROW or gid.dtype != torch.int32
            or starts.dtype != torch.int64 or starts.shape != (n_tiles + 1,)
            or img_w > grid_x * TILE or img_h > grid_y * TILE
            or any(a.dtype != torch.float32 or tuple(a.shape) != s
                   for a, s in zip(images, shapes))):
        raise ValueError("blend_backward: want rows (N, 10) float32, gid "
                         "int32, starts (T+1,) int64, and float32 (H, W, 3), "
                         "(H, W), (H, W) totals and cotangents")
    if any(a.device != rows.device for a in (gid, starts) + images):
        raise ValueError("blend_backward: inputs on different devices")
    rows, gid, starts = rows.contiguous(), gid.contiguous(), starts.contiguous()
    images = [a.contiguous() for a in images]
    grad = torch.zeros((rows.shape[0], ROW), dtype=torch.float32,
                       device=rows.device)
    lib = cuda_build.load()
    with torch.cuda.device(rows.device):
        err = lib.ag_blend_backward(
            rows.data_ptr(), gid.data_ptr(), starts.data_ptr(), grid_x,
            grid_y, img_w, img_h, *(a.data_ptr() for a in images),
            grad.data_ptr(), cuda_build.stream_of(rows))
    cuda_build.check(err, "blend_backward")
    count("blend.bwd.launches")
    return grad


class BlendTiles(torch.autograd.Function):
    """``blend_tiles`` with ``blend_backward`` as its gradient (both plain
    with ``plain=True``): rows (N, 10) -> colour (H, W, 3), depth (H, W),
    T_final (H, W). Only ``rows`` gets a gradient; the sorted pair list is
    integer bookkeeping, as in the JAX package's custom_vjps."""

    @staticmethod
    def forward(ctx, rows, gid, starts, grid_x: int, grid_y: int,
                img_w: int, img_h: int, plain: bool = False):
        fwd = blend_tiles_plain if plain else blend_tiles
        color, depth, t_final = fwd(rows, gid, starts, grid_x, grid_y,
                                    img_w, img_h)
        ctx.save_for_backward(rows, gid, starts, color, depth, t_final)
        ctx.args = (grid_x, grid_y, img_w, img_h)
        ctx.plain = plain
        return color, depth, t_final

    @staticmethod
    def backward(ctx, g_color, g_depth, g_tfinal):
        with span("splat.blend_bwd"):
            rows, gid, starts, color, depth, t_final = ctx.saved_tensors
            g_color, g_depth, g_tfinal = (
                torch.zeros_like(out) if g is None else g
                for g, out in ((g_color, color), (g_depth, depth),
                               (g_tfinal, t_final)))
            bwd = blend_backward_plain if ctx.plain else blend_backward
            grad = bwd(rows, gid, starts, *ctx.args, color, depth, t_final,
                       g_color, g_depth, g_tfinal)
        return (grad,) + (None,) * 7
