"""NeRF ray utilities: ray generation, AABB near/far, the training-time
random ray sampler (host, numpy), stratified sampling, hierarchical PDF
sampling and volume integration (device, PyTorch). A port of
``animatablegaussians_tpu/utils/nerf.py`` (ref: utils/nerf_util.py:49-330).

The host functions are numpy copies of the JAX package's. The ray draw
takes a ``numpy.random.Generator``. ``get_bound_2d_mask`` casts the
projected corners to int as the JAX package does, including a corner
behind the camera whose projection is not finite (numpy warns then).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


# ---------------------------------------------------------------------------
# host (numpy)
# ---------------------------------------------------------------------------

def gen_uv(img_w: int, img_h: int) -> np.ndarray:
    x, y = np.meshgrid(np.arange(img_w), np.arange(img_h))
    return np.stack([x, y], axis=-1)


def get_rays(uv: np.ndarray, extr: np.ndarray, intr: np.ndarray):
    """Pixel uv -> world ray directions and origins (ref:
    nerf_util.py:83-99)."""
    inv_extr = np.linalg.inv(extr)
    cam_loc = inv_extr[:3, 3]
    pix = np.concatenate([uv.astype(np.float64),
                          np.ones((uv.shape[0], 1))], -1)
    cam_pts = np.einsum("ij,nj->ni", np.linalg.inv(intr), pix)
    world = np.einsum("ij,nj->ni", inv_extr[:3, :3], cam_pts) + inv_extr[:3, 3]
    d = world - cam_loc[None]
    d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-8
    return d.astype(np.float32), np.repeat(cam_loc[None], uv.shape[0],
                                           0).astype(np.float32)


def get_near_far(bounds: np.ndarray, ray_o: np.ndarray, ray_d: np.ndarray):
    """Ray / AABB intersection -> (near, far, mask_at_box) (ref:
    nerf_util.py:49-80)."""
    bounds = bounds + np.array([-0.01, 0.01])[:, None]
    nom = bounds[None] - ray_o[:, None]
    d_int = (nom / (ray_d[:, None] + 1e-9)).reshape(-1, 6)
    p_int = d_int[..., None] * ray_d[:, None] + ray_o[:, None]
    mn, mx = bounds[0], bounds[1]
    eps = 1e-6
    ok = np.ones(p_int.shape[:2], bool)
    for a in range(3):
        ok &= (p_int[..., a] >= mn[a] - eps) & (p_int[..., a] <= mx[a] + eps)
    mask = ok.sum(-1) == 2
    p_pairs = p_int[mask][ok[mask]].reshape(-1, 2, 3)
    ro, rd = ray_o[mask], ray_d[mask]
    nrm = np.linalg.norm(rd, axis=1)
    d0 = np.linalg.norm(p_pairs[:, 0] - ro, axis=1) / nrm
    d1 = np.linalg.norm(p_pairs[:, 1] - ro, axis=1) / nrm
    return np.minimum(d0, d1), np.maximum(d0, d1), mask


def get_bound_corners(bounds: np.ndarray) -> np.ndarray:
    mn, mx = bounds
    return np.array([[x, y, z] for x in (mn[0], mx[0])
                     for y in (mn[1], mx[1]) for z in (mn[2], mx[2])])


def get_bound_2d_mask(bounds, K, pose, H, W) -> np.ndarray:
    """The filled convex hull of the projected AABB corners (ref:
    nerf_util.py:35-46)."""
    import cv2 as cv
    corners = get_bound_corners(bounds)
    cam = corners @ pose[:3, :3].T + pose[:3, 3]
    pix = cam @ K.T
    pix = pix[:, :2] / np.maximum(pix[:, 2:], 1e-8)
    mask = np.zeros((H, W), np.uint8)
    hull = cv.convexHull(pix.astype(np.int32))
    cv.fillConvexPoly(mask, hull, 1)
    return mask


def sample_rays_for_training(color_img, mask_img, extr, intr, live_bounds,
                             sample_num: int = 1024,
                             inside_ratio: float = 0.5,
                             unsample_region_mask: Optional[np.ndarray] = None,
                             depth_img: Optional[np.ndarray] = None,
                             rng: Optional[np.random.Generator] = None):
    """Exactly ``sample_num`` random rays, about half inside the mask,
    clipped to the AABB (ref: nerf_util.py:260-330)."""
    rng = rng or np.random.default_rng()
    img_h, img_w = color_img.shape[:2]
    if depth_img is None:
        depth_img = np.zeros((img_h, img_w), np.float32)
    bound_mask = get_bound_2d_mask(live_bounds, intr, extr, img_h, img_w) > 0
    if unsample_region_mask is not None:
        bound_mask &= unsample_region_mask < 1e-6
    uv_img = gen_uv(img_w, img_h)
    m = mask_img.astype(bool)
    inside_uv = uv_img[m & bound_mask]
    outside_uv = uv_img[(~m) & bound_mask]

    uvs, ros, rds, nears, fars = [], [], [], [], []
    count = 0
    while count < sample_num:
        rest = sample_num - count
        n_in = min(int(rest * inside_ratio) + 1, len(inside_uv))
        n_out = min(rest - n_in + 1, len(outside_uv)) if rest > n_in else 0
        pick = [inside_uv[rng.choice(len(inside_uv), max(n_in, 1),
                                     replace=False)]]
        if n_out > 0 and len(outside_uv):
            pick.append(outside_uv[rng.choice(len(outside_uv), n_out,
                                              replace=False)])
        uv_ = np.concatenate(pick, 0)
        rd_, ro_ = get_rays(uv_, extr, intr)
        near_, far_, ok = get_near_far(live_bounds, ro_, rd_)
        uvs.append(uv_[ok])
        ros.append(ro_[ok])
        rds.append(rd_[ok])
        nears.append(near_)
        fars.append(far_)
        count += int(ok.sum())

    uv = np.concatenate(uvs)[:sample_num]
    ray_o = np.concatenate(ros)[:sample_num]
    ray_d = np.concatenate(rds)[:sample_num]
    near = np.concatenate(nears)[:sample_num].astype(np.float32)
    far = np.concatenate(fars)[:sample_num].astype(np.float32)

    color_gt = color_img[uv[:, 1], uv[:, 0]].copy()
    mask_gt = mask_img[uv[:, 1], uv[:, 0]].astype(np.float32)
    color_gt[mask_gt < 1e-6] = 0
    depth_gt = depth_img[uv[:, 1], uv[:, 0]]
    x = (uv[:, 0] + 0.5 - intr[0, 2]) * depth_gt / intr[0, 0]
    y = (uv[:, 1] + 0.5 - intr[1, 2]) * depth_gt / intr[1, 1]
    dist = np.sqrt(x * x + y * y + depth_gt * depth_gt).astype(np.float32)

    return dict(uv=uv, ray_o=ray_o, ray_d=ray_d, near=near, far=far,
                color_gt=color_gt, mask_gt=mask_gt, depth_gt=depth_gt,
                dist=dist)


# ---------------------------------------------------------------------------
# device (PyTorch)
# ---------------------------------------------------------------------------

def sample_pts_on_rays(ray_o, ray_d, near, far, n_samples: int = 64,
                       perturb: bool = False,
                       generator: Optional[torch.Generator] = None,
                       t_rand: Optional[torch.Tensor] = None):
    """Uniform depth samples with optional stratified jitter (ref:
    nerf_util.py:102-131): (R, 3), (R,), (R,) -> pts (R, S, 3), z (R, S).
    The jitter's U(0, 1) draws are ``t_rand`` (R, S) when given, else drawn
    from ``generator``."""
    t = torch.linspace(0.0, 1.0, n_samples, device=near.device)
    z = near[..., None] * (1.0 - t) + far[..., None] * t
    if perturb:
        if t_rand is None:
            t_rand = torch.rand(z.shape, generator=generator,
                                device=z.device)
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], -1)
        lower = torch.cat([z[..., :1], mids], -1)
        z = lower + (upper - lower) * t_rand
    pts = ray_o[..., None, :] + ray_d[..., None, :] * z[..., None]
    return pts, z


def sample_pdf(bins, weights, n_samples: int,
               generator: Optional[torch.Generator] = None,
               det: bool = False, u: Optional[torch.Tensor] = None):
    """Hierarchical PDF sampling (ref: nerf_util.py:135-179). ``u``, when
    given, replaces the uniform draws."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    shape = cdf.shape[:-1] + (n_samples,)
    if u is None:
        if det:
            u = torch.linspace(0.0, 1.0, n_samples,
                               device=cdf.device).expand(shape)
        else:
            u = torch.rand(shape, generator=generator, device=cdf.device)
    u = u.contiguous()
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(idx - 1, min=0)
    above = torch.clamp(idx, max=cdf.shape[-1] - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    nb = bins.shape[-1] - 1
    bins_g0 = torch.gather(bins, -1, torch.clamp(below, max=nb))
    bins_g1 = torch.gather(bins, -1, torch.clamp(above, max=nb))
    denom = torch.where(cdf_g1 - cdf_g0 < 1e-5, torch.ones_like(cdf_g0),
                        cdf_g1 - cdf_g0)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)


def raw2outputs(raw, z_vals, white_bkgd: bool = False):
    """Alpha compositing of per-sample (rgb, alpha) (ref:
    nerf_util.py:197-223): raw (R, S, 4) -> rgb, disp, acc, weights,
    depth."""
    rgb = raw[..., :-1]
    alpha = raw[..., -1]
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]),
                   1.0 - alpha + 1e-10], -1), -1)[..., :-1]
    weights = alpha * trans
    rgb_map = torch.sum(weights[..., None] * rgb, -2)
    depth_map = torch.sum(weights * z_vals, -1)
    acc_map = torch.sum(weights, -1)
    disp_map = 1.0 / torch.clamp(
        depth_map / torch.clamp(acc_map, min=1e-10), min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, disp_map, acc_map, weights, depth_map
