"""Plain PyTorch avatar: pose map -> three DualStyleUNet heads -> masked
texel select -> [mean hands] -> LBS skin -> splat.

The equations of AnimatableGaussians' ``network/avatar.py`` (AvatarNet:
``get_positions``, ``get_others``, ``get_colors``, the view-direction
features, ``transform_cano2live``, ``generate_mean_hands`` and the hand
blend of ``render``), written from the published model for this check.
The texels are the masked ones of the canonical (H, 2H) front|back map,
packed in blocks of ``texel_block`` consecutive texels with the pad texels
masked out, the order in which the port keeps them, so that per-Gaussian
tensors and depth-sort ties line up. The canonical Gaussians come from
the canonical points here (scales from the 3 nearest neighbours, opacity
0.1, identity rotations), as ``GaussianModel.create_from_pcd`` makes them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from . import splat
from .cnn import DualStyleUNet

HEADS = (("position_net", 3), ("other_net", 8), ("color_net", 3))


def knn_mean_d2(points, k: int = 4, chunk: int = 1024):
    """(N,) mean squared distance to the k - 1 nearest other points."""
    sq = torch.sum(points * points, dim=1)
    out = []
    for q in torch.split(points, chunk):
        d2 = torch.sum(q * q, 1, keepdim=True) + sq[None] - 2.0 * q @ points.T
        out.append(torch.clamp(torch.topk(d2, k, dim=1, largest=False)
                               .values[:, 1:], min=0.0).mean(1))
    return torch.cat(out)


def normalize_quat(q, eps=1e-12):
    sq = torch.sum(q * q, dim=-1, keepdim=True)
    pos = sq > eps * eps
    return torch.where(pos, q / torch.sqrt(torch.where(pos, sq,
                                                       torch.ones_like(sq))),
                       torch.zeros_like(q))


def mat_to_quat(m):
    """(N, 3, 3) rotations -> (N, 4) unit wxyz, w >= 0 (Shepperd)."""
    m00, m01, m02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    m10, m11, m12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    m20, m21, m22 = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    mags = torch.clamp(torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                                    1 - m00 + m11 - m22,
                                    1 - m00 - m11 + m22], -1), min=0.0)
    cands = torch.stack([
        torch.stack([mags[:, 0], m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, mags[:, 1], m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, mags[:, 2], m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, mags[:, 3]], -1)], -2)
    cands = cands / (2.0 * torch.sqrt(torch.clamp(mags, min=1e-12)))[..., None]
    q = cands[torch.arange(m.shape[0], device=m.device), mags.argmax(-1)]
    return normalize_quat(torch.where(q[:, :1] < 0, -q, q))


def networks(model: dict, map_h: int) -> dict:
    """The avatar's networks by their checkpoint names: the three heads
    (512^2 pose map in, 1024^2 maps out at full size) and the
    view-direction encoder."""
    kw = dict(inp_size=map_h // 2, out_size=map_h,
              channel_max=int(model["channel_max"]),
              style_dim=int(model["style_dim"]), n_mlp=int(model["n_mlp"]),
              middle_size=int(model["middle_size"]),
              channel_multiplier=int(model["channel_multiplier"]),
              lr_mlp=float(model["lr_mlp"]))
    nets = {name: DualStyleUNet(out_ch=ch, **kw) for name, ch in HEADS}
    nets["viewdir_net"] = nn.Sequential(nn.Conv2d(1, 64, 4, 2, 1),
                                        nn.LeakyReLU(0.2),
                                        nn.Conv2d(64, 128, 4, 2, 1))
    return nets


def weight_holder(model: dict, map_h: int) -> nn.Module:
    """The networks on the meta device, for their weights' names and
    shapes."""
    with torch.device("meta"):
        holder = nn.Module()
        for name, module in networks(model, map_h).items():
            holder.add_module(name, module)
    return holder


class Gaussians(nn.Module):
    """The canonical Gaussians' raw parameters, as the checkpoint names
    them (``cano_gaussian.xyz``, ...)."""

    def __init__(self, points):
        super().__init__()
        n = points.shape[0]
        d2 = torch.clamp(knn_mean_d2(points), min=1e-7)
        rot = torch.zeros((n, 4), device=points.device)
        rot[:, 0] = 1.0
        self.xyz = nn.Parameter(points.clone())
        self.scaling = nn.Parameter(torch.log(torch.sqrt(d2))[:, None]
                                    .repeat(1, 3))
        self.rotation = nn.Parameter(rot)
        self.opacity = nn.Parameter(torch.full((n, 1), math.log(0.1 / 0.9),
                                               device=points.device))


class Avatar(nn.Module):
    def __init__(self, model: dict, cano_pos, cano_nml, lbs, device):
        """cano_pos, cano_nml (H, 2H, 3) numpy canonical maps; lbs
        (N_masked, J) weights of the masked texels in row-major order."""
        super().__init__()
        H, W = cano_pos.shape[:2]
        tb = int(model["texel_block"])
        self.S, self.tb, self.W = H, tb, W
        flat = (np.linalg.norm(cano_pos, axis=-1) > 0).reshape(-1)
        block = np.nonzero(flat.reshape(-1, tb).any(1))[0]
        t = (block[:, None] * tb + np.arange(tb)[None]).reshape(-1)
        valid = flat[t]
        lbs_pad = np.zeros((t.shape[0], lbs.shape[1]), np.float32)
        lbs_pad[valid] = lbs
        iy, ix = t // W, t % W
        b_iy, b_ix = (block * tb) // W, (block * tb) % W
        front = b_ix < H
        dual_row = b_iy * (H // tb) + np.where(front, b_ix, b_ix - H) // tb

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(a, dtype=dtype, device=device)

        self.n_points = t.shape[0]
        self.points = dev(cano_pos[iy, ix])
        self.nmls = dev(cano_nml[iy, ix])
        self.lbs = dev(lbs_pad)
        self.valid = dev(valid, torch.bool)
        self.dual_row = dev(dual_row, torch.long)
        self.front = dev(front, torch.bool)[:, None, None]
        # full-resolution texel index of each point, for the half-res maps
        self.texel = dev(t, torch.long)
        self.style_dim = int(model["style_dim"])
        with torch.device(device):
            for name, module in networks(model, H).items():
                setattr(self, name, module)
        self.cano_gaussian = Gaussians(self.points)

    # -- plumbing -------------------------------------------------------
    def half_map(self, vals):
        """(N, C) point values -> (H/2, W/2, C) map of the even texels."""
        c = vals.shape[1]
        full = torch.zeros((self.S * self.W, c), dtype=vals.dtype,
                           device=vals.device)
        full = full.index_put((self.texel,), vals)
        return full.reshape(self.S, self.W, c)[::2, ::2]

    def point_mats(self, mats):
        return (self.lbs @ mats.reshape(mats.shape[0], 16)).reshape(-1, 4, 4)

    def select(self, outs):
        """[(1, S, S, 2C)] head outputs -> (N, sum C) per point: front
        texels from the first C channels, back ones from the last C."""
        x = torch.cat([o[0] for o in outs], dim=-1)
        rows = x.reshape(-1, self.tb, x.shape[-1])[self.dual_row]
        vals, off = [], 0
        for o in outs:
            c2 = o.shape[-1]
            seg = rows[:, :, off:off + c2]
            vals.append(torch.where(self.front, seg[..., :c2 // 2],
                                    seg[..., c2 // 2:]))
            off += c2
        return torch.cat(vals, -1).reshape(self.n_points, -1)

    def constant_style(self):
        return torch.ones((1, self.style_dim), device=self.points.device) \
            / math.sqrt(self.style_dim)

    # -- heads ----------------------------------------------------------
    def view_features(self, items, noise=None):
        m = self.point_mats(items["cano2live_jnt_mats"])
        live = torch.einsum("nxy,ny->nx", m[:, :3, :3], self.points) \
            + m[:, :3, 3]
        nml = torch.einsum("nxy,ny->nx", m[:, :3, :3], self.nmls)
        extr = items["extr"]
        cam = -extr[:3, :3].T @ extr[:3, 3]
        vd = cam[None] - live
        vd = vd / torch.clamp(torch.linalg.norm(vd, dim=-1, keepdim=True),
                              min=1e-3)
        if noise is not None:
            vd = vd + 0.1 * noise
            vd = vd / torch.clamp(torch.linalg.norm(vd, dim=-1,
                                                    keepdim=True), min=1e-3)
        dots = self.half_map(torch.sum(nml * vd, -1, keepdim=True))[..., 0]
        half = dots.shape[1] // 2

        def enc(v):
            return self.viewdir_net(v[None, None]).permute(0, 2, 3, 1)

        return enc(dots[:, :half]), enc(dots[:, half:])

    def gaussians(self, items, noise=None):
        """One frame's canonical Gaussian attributes from the heads."""
        pose = items["smpl_pos_map"][..., :3][None]
        front, back = self.view_features(items, noise)
        style = self.constant_style()
        outs = [self.position_net(style, pose), self.other_net(style, pose),
                self.color_net(style, pose, front, back)]
        return self.attributes(self.select(outs))

    def attributes(self, sel):
        g = self.cano_gaussian
        return dict(positions=0.05 * sel[:, :3] + g.xyz,
                    opacity=torch.sigmoid(sel[:, 3:4] + g.opacity),
                    scales=torch.exp(sel[:, 4:7] + g.scaling),
                    rotations=normalize_quat(sel[:, 7:11] + g.rotation),
                    colors=sel[:, 11:14])

    @torch.no_grad()
    def mean_hands(self, pose_map):
        """The heads' canonical Gaussians at one fixed pose map, without
        view features."""
        style, pose = self.constant_style(), pose_map[..., :3][None]
        sel = self.select([self.position_net(style, pose),
                           self.other_net(style, pose)])
        g = self.cano_gaussian
        col = self.select([self.color_net(style, pose)])
        return dict(positions=0.05 * sel[:, :3] + g.xyz,
                    opacity=torch.sigmoid(sel[:, 3:4] + g.opacity),
                    scales=torch.exp(sel[:, 4:7] + g.scaling),
                    rotations=normalize_quat(sel[:, 7:11] + g.rotation),
                    colors=col)

    def hand_weight(self, items):
        x = self.points

        def unit(v):
            lo, hi = v.amin(0, keepdim=True), v.amax(0, keepdim=True)
            return (x - 0.5 * (lo + hi)) / (0.5 * (hi - lo))

        wl = torch.sigmoid(2.5 * (unit(items["left_cano_mano_v"])[:, :1]
                                  + 2.0))
        wr = torch.sigmoid(-2.5 * (unit(items["right_cano_mano_v"])[:, :1]
                                   - 2.0))
        below = (x[:, 1] < items["cano_smpl_center"][1])[:, None]
        wl = torch.where(below, torch.zeros_like(wl), wl)
        wr = torch.where(below, torch.zeros_like(wr), wr)
        s = torch.clamp(wl + wr, min=1.0)
        return wl / s + wr / s

    def skin(self, g, items):
        m = self.point_mats(items["cano2live_jnt_mats"])[:, :3, :]
        pos = torch.einsum("nxy,ny->nx", m[:, :, :3], g["positions"]) \
            + m[:, :, 3]
        rot = m[:, :, :3] @ splat.quat_to_mat(g["rotations"])
        return pos, mat_to_quat(rot)

    def posed(self, items, noise=None, hands=None):
        """-> (canonical attributes after the hand blend, skinned positions
        and rotations)."""
        g = self.gaussians(items, noise)
        if hands is not None:
            w = self.hand_weight(items)
            for k in ("positions", "opacity", "scales", "rotations"):
                g[k] = w * hands[k] + (1 - w) * g[k]
        return (g,) + self.skin(g, items)

    @torch.no_grad()
    def pair_count(self, items, img_w, img_h, hands=None) -> int:
        """The (Gaussian, tile) pairs the frame bins."""
        g, pos, rot = self.posed(items, hands=hands)
        m2, depth, _, radius, valid = splat.preprocess(
            pos, g["scales"], rot, items["extr"], items["intr"], img_w, img_h)
        return splat.bin_tiles(m2, depth, radius, valid & self.valid, img_w,
                               img_h)[2]

    def render(self, items, bg, img_w, img_h, noise=None, hands=None):
        """-> (image (H, W, 3), alpha (H, W), offset (N, 3), n_pairs)."""
        g, pos, rot = self.posed(items, noise, hands)
        offset = (g["positions"] - self.points) * self.valid[:, None]
        img, alpha, n_pairs = splat.render(
            pos, g["scales"], rot, g["opacity"], g["colors"], bg,
            items["extr"], items["intr"], img_w, img_h, keep=self.valid)
        return img, alpha, offset, n_pairs
