"""Plain PyTorch Gaussian splatting: projection, tile binning and
front-to-back alpha blending, differentiable by autograd.

The arithmetic of the 3DGS rasterizer (``diff_gaussian_rasterization``'s
``preprocessCUDA``, ``duplicateWithKeys`` and ``renderCUDA``): EWA
Jacobian with the 1.3 FoV clamp, the +0.3 px low-pass, radius ceil(3
sigma), the 0.2 near cull, 16x16 tiles, pairs sorted by (tile, depth),
alpha = min(0.99, op G) kept where >= 1/255 and the power <= 0, and a pixel
stops once its transmittance would fall below 1e-4. The blend is the
cumulative-product form over each tile's depth-sorted list; autograd
gives its gradient, so no hand-written backward is needed here.
"""

from __future__ import annotations

import torch

TILE = 16
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
ALPHA_CLAMP = 0.99
BLOCK_ELEMS = 1 << 24   # (tiles x pixels x pairs) elements of one block


def projection(extr, intr, img_w: int, img_h: int, znear=0.1, zfar=100.0):
    K = intr
    nfx, nfy = znear / K[0, 0], znear / K[1, 1]
    left, right = -(img_w - K[0, 2]) * nfx, K[0, 2] * nfx
    bottom, top = (K[1, 2] - img_h) * nfy, K[1, 2] * nfy
    P = torch.zeros((4, 4), dtype=torch.float32, device=extr.device)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    extr = extr.to(torch.float32)
    return extr, P @ extr


def quat_to_mat(q):
    w, x, y, z = q.unbind(-1)
    s = 2.0 / torch.sum(q * q, dim=-1)
    return torch.stack([
        1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w),
        s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w),
        s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y),
    ], dim=-1).reshape(q.shape[:-1] + (3, 3))


def preprocess(means, scales, rots, extr, intr, img_w: int, img_h: int):
    """-> (means2d (N, 2), depth (N,), conic (N, 3), radius (N,) int,
    valid (N,) bool)."""
    V, P = projection(extr, intr, img_w, img_h)
    hom = torch.cat([means, torch.ones_like(means[:, :1])], dim=1)
    t = hom @ V.T
    c = hom @ P.T
    p_w = 1.0 / (c[:, 3] + 1e-7)
    means2d = torch.stack([((c[:, 0] * p_w + 1.0) * img_w - 1.0) * 0.5,
                           ((c[:, 1] * p_w + 1.0) * img_h - 1.0) * 0.5], 1)
    tz = t[:, 2]
    tan_x, tan_y = img_w / (2.0 * intr[0, 0]), img_h / (2.0 * intr[1, 1])
    fx, fy = img_w / (2.0 * tan_x), img_h / (2.0 * tan_y)
    tzs = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    tx = torch.clamp(t[:, 0] / tzs, -1.3 * tan_x, 1.3 * tan_x) * tzs
    ty = torch.clamp(t[:, 1] / tzs, -1.3 * tan_y, 1.3 * tan_y) * tzs
    zero = torch.zeros_like(tz)
    J = torch.stack([fx / tzs, zero, -fx * tx / tzs ** 2,
                     zero, fy / tzs, -fy * ty / tzs ** 2], 1).reshape(-1, 2, 3)
    R = quat_to_mat(rots)
    M = R * scales[:, None, :]
    cov3 = M @ M.transpose(1, 2)
    T = J @ V[:3, :3][None]
    cov2 = T @ cov3 @ T.transpose(1, 2)
    a = cov2[:, 0, 0] + 0.3
    b = cov2[:, 0, 1]
    cc = cov2[:, 1, 1] + 0.3
    det = a * cc - b * b
    inv = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    conic = torch.stack([cc * inv, -b * inv, a * inv], 1)
    mid = 0.5 * (a + cc)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))
    valid = (tz > 0.2) & (det > 0.0) & (radius > 0)
    radius = torch.where(valid, radius, torch.zeros_like(radius)).long()
    return means2d, tz, conic, radius, valid


@torch.no_grad()
def bin_tiles(means2d, depth, radius, valid, img_w: int, img_h: int):
    """-> (gid (P,) Gaussian of each (Gaussian, tile) pair in (tile,
    depth) order, starts (T+1,) tile t's pairs gid[starts[t]:starts[t+1]],
    n_pairs)."""
    gx, gy = -(-img_w // TILE), -(-img_h // TILE)
    r = radius.to(means2d.dtype)

    def edge(v, hi):
        return torch.clamp(torch.floor(v / TILE), 0, hi).long()

    x, y = means2d[:, 0], means2d[:, 1]
    x0, y0 = edge(x - r, gx), edge(y - r, gy)
    x1, y1 = edge(x + r + TILE - 1, gx), edge(y + r + TILE - 1, gy)
    wdt = x1 - x0
    cnt = torch.where(valid, wdt * (y1 - y0), torch.zeros_like(wdt))
    n_pairs = int(cnt.sum())
    g = torch.repeat_interleave(torch.arange(cnt.shape[0],
                                             device=cnt.device), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    d = torch.arange(n_pairs, device=cnt.device) - first[g]
    tile = (y0[g] + d // wdt[g]) * gx + x0[g] + d % wdt[g]
    # depth > 0 for every binned Gaussian, so a stable sort by depth and
    # then by tile gives (tile, depth) order with ties by Gaussian id
    order = torch.sort(depth[g], stable=True).indices
    order = order[torch.sort(tile[order], stable=True).indices]
    gid, tile = g[order], tile[order]
    starts = torch.searchsorted(tile, torch.arange(gx * gy + 1,
                                                   device=tile.device))
    return gid, starts, n_pairs


def blend(rows, gid, starts, img_w: int, img_h: int):
    """rows (N, 9) [x y ca cb cc op r g b] per Gaussian -> colour (H, W, 3)
    and final transmittance (H, W) (1 where nothing contributed)."""
    dev = rows.device
    gx, gy = -(-img_w // TILE), -(-img_h // TILE)
    P = TILE * TILE
    counts_t = starts[1:] - starts[:-1]
    counts = counts_t.tolist()
    order = sorted((t for t in range(gx * gy) if counts[t]),
                   key=lambda t: counts[t])
    lp = torch.arange(P, device=dev)
    parts_rgb, parts_t, parts_id = [], [], []
    i = 0
    while i < len(order):
        kmax = counts[order[i]]
        j = i
        while j < len(order) and (j - i + 1) * max(kmax, counts[order[j]]) \
                * P <= BLOCK_ELEMS:
            kmax = max(kmax, counts[order[j]])
            j += 1
        j = max(j, i + 1)
        kmax = max(counts[t] for t in order[i:j])
        tb = torch.tensor(order[i:j], device=dev)
        k = torch.arange(kmax, device=dev)
        idx = starts[tb][:, None] + k[None]
        kmask = k[None] < counts_t[tb][:, None]
        g = gid[torch.clamp(idx, max=gid.shape[0] - 1)]
        d = rows[g]                                          # (B, K, 9)
        px = ((tb % gx) * TILE)[:, None] + lp[None] % TILE
        py = ((tb // gx) * TILE)[:, None] + lp[None] // TILE
        dx = d[:, None, :, 0] - px.float()[:, :, None]       # (B, P, K)
        dy = d[:, None, :, 1] - py.float()[:, :, None]
        power = (-0.5 * (d[:, None, :, 2] * dx * dx + d[:, None, :, 4]
                         * dy * dy) - d[:, None, :, 3] * dx * dy)
        alpha = torch.clamp(d[:, None, :, 5] * torch.exp(power),
                            max=ALPHA_CLAMP)
        use = kmask[:, None] & (alpha >= ALPHA_MIN) & (power <= 0.0)
        alpha = torch.where(use, alpha, torch.zeros_like(alpha))
        pinc = torch.cumprod(1.0 - alpha, dim=2)
        pexc = torch.cat([torch.ones_like(pinc[..., :1]), pinc[..., :-1]], 2)
        contrib = use & (pinc >= T_EPS)
        w = torch.where(contrib, alpha * pexc, torch.zeros_like(alpha))
        parts_rgb.append(torch.bmm(w, d[..., 6:9]))
        parts_t.append(torch.amin(torch.where(contrib, pinc,
                                              torch.ones_like(pinc)), dim=2))
        parts_id.append(tb)
        i = j
    rgb = torch.zeros((gx * gy, P, 3), device=dev)
    tfin = torch.ones((gx * gy, P), device=dev)
    if parts_id:
        ids = torch.cat(parts_id)
        rgb = rgb.index_put((ids,), torch.cat(parts_rgb))
        tfin = tfin.index_put((ids,), torch.cat(parts_t))

    def untile(a):
        c = a.shape[-1]
        a = a.reshape(gy, gx, TILE, TILE, c).permute(0, 2, 1, 3, 4)
        return a.reshape(gy * TILE, gx * TILE, c)[:img_h, :img_w]

    return untile(rgb), untile(tfin[..., None])[..., 0]


def render(means, scales, rots, opacity, colors, bg, extr, intr,
           img_w: int, img_h: int, keep=None):
    """-> (image (H, W, 3) over ``bg``, alpha (H, W), n_pairs)."""
    m2, depth, conic, radius, valid = preprocess(means, scales, rots, extr,
                                                 intr, img_w, img_h)
    if keep is not None:
        valid = valid & keep
    op = torch.where(valid, opacity.reshape(-1), torch.zeros_like(depth))
    rows = torch.cat([m2, conic, op[:, None], colors], 1)
    gid, starts, n_pairs = bin_tiles(m2.detach(), depth.detach(), radius,
                                     valid, img_w, img_h)
    rgb, tfin = blend(rows, gid, starts, img_w, img_h)
    return rgb + tfin[..., None] * bg.reshape(1, 1, 3), 1.0 - tfin, n_pairs
