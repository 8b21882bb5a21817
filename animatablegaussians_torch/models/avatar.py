"""AvatarNet: pose map -> three DualStyleUNet heads -> masked-texel select
-> LBS skin -> tile splat, for the novel-pose render path and, with
``training=True``, under autograd for the train step.

Port of ``animatablegaussians_tpu/models/avatar.py:38-187,251-373,419-567``
as an ``nn.Module``. The point set is the JAX package's block-packed
masked-texel layout (``texel_block`` consecutive texels per block, with a
``valid`` mask for the pad texels), so per-Gaussian tensors compare index
for index with the JAX package and sort ties agree. Parameters live in the
module; ``utils/convert.params_from_jax`` carries the JAX parameters
across. The training-time view-direction jitter takes its (N, 3) normal
noise from the caller (``draws``), so a test can hand both packages the
same numbers. Not ported yet: mean hands (``hand_vals``) and pose-map
regeneration (``get_pose_map``). Random styles are refused: the shipped
configs turn them off (``configs/avatarrex_zzr/avatar.yaml:78``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from animatablegaussians_torch.models.gaussian_model import create_from_pcd
from animatablegaussians_torch.models.styleunet import DualStyleUNet
from animatablegaussians_torch.ops import quat as quat_ops
from animatablegaussians_torch.ops.rasterize import render as splat

# consecutive texels per block of the packed point set (the JAX package's
# default ``texel_block``)
TEXEL_BLOCK = 8


class AvatarNet(nn.Module):
    def __init__(self, opt, cano_smpl_map: np.ndarray,
                 init_pts_lbs: np.ndarray,
                 cano_nml_map: Optional[np.ndarray] = None,
                 device="cuda", seed: int = 0):
        """cano_smpl_map: (H, 2H, 3) canonical position map (front|back);
        init_pts_lbs: (N_valid, J) per-point LBS weights. Parameters are
        drawn from a ``torch.Generator`` seeded with ``seed``; the module
        lives on the card unless ``device`` says otherwise."""
        super().__init__()
        opt = dict(opt or {})
        if opt.get("random_style", False):
            raise NotImplementedError("random_style is not ported (the "
                                      "shipped configs set it false)")
        self.with_viewdirs = opt.get("with_viewdirs", True)
        self.map_h, self.map_w = cano_smpl_map.shape[:2]
        self.inp_size = self.map_h // 2
        self.out_size = S = self.map_h
        self.texel_block = tb = TEXEL_BLOCK
        if not (self.map_w == 2 * S and S % tb == 0):
            raise ValueError(f"AvatarNet needs an (H, 2H) map with H a "
                             f"multiple of {tb}")
        dev = torch.device(device)

        # block-packed masked texels (JAX avatar.py:69-100)
        mask = np.linalg.norm(np.asarray(cano_smpl_map), axis=-1) > 0.0
        flat = mask.reshape(-1)
        block_idx = np.nonzero(flat.reshape(-1, tb).any(axis=1))[0]
        t = (block_idx[:, None] * tb + np.arange(tb)[None]).reshape(-1)
        iy, ix = t // self.map_w, t % self.map_w
        valid_np = flat[t]
        self.n_points = int(t.shape[0])
        self.n_valid = int(valid_np.sum())
        lbs_np = np.asarray(init_pts_lbs, np.float32)
        if lbs_np.shape[0] != self.n_valid:
            raise ValueError(f"init_pts_lbs has {lbs_np.shape[0]} rows for "
                             f"{self.n_valid} masked texels")
        lbs_pad = np.zeros((self.n_points, lbs_np.shape[1]), np.float32)
        lbs_pad[valid_np] = lbs_np

        # half-res viewdir scatter layout (JAX avatar.py:115-130): even rows'
        # blocks contribute their even-x texels as one tb/2-run each
        hb = tb // 2
        blk_t0 = block_idx * tb
        blk_iy, blk_ix0 = blk_t0 // self.map_w, blk_t0 % self.map_w
        even = blk_iy % 2 == 0
        vd_src = (np.nonzero(even)[0][:, None] * tb
                  + np.arange(0, tb, 2)[None]).reshape(-1)
        vd_tgt = ((blk_iy[even] // 2) * (self.map_w // 2 // hb)
                  + blk_ix0[even] // tb)
        # direct CNN-output select layout (JAX avatar.py:140-152)
        front = blk_ix0 < S
        dual_row = blk_iy * (S // tb) + np.where(front, blk_ix0,
                                                 blk_ix0 - S) // tb

        def buf(name, a, dtype):
            self.register_buffer(name, torch.as_tensor(a, dtype=dtype),
                                 persistent=False)

        pos = np.asarray(cano_smpl_map, np.float32)
        buf("init_points", pos[iy, ix], torch.float32)
        buf("lbs", lbs_pad, torch.float32)
        buf("valid", valid_np, torch.bool)
        buf("valid_f", valid_np.astype(np.float32), torch.float32)
        buf("vd_half_src", vd_src, torch.int64)
        buf("vd_half_tgt", vd_tgt, torch.int64)
        buf("dual_row", dual_row, torch.int64)
        buf("dual_front", front[:, None, None], torch.bool)
        if self.with_viewdirs:
            if cano_nml_map is None:
                raise ValueError("with_viewdirs needs cano_nml_map")
            buf("cano_nmls", np.asarray(cano_nml_map, np.float32)[iy, ix],
                torch.float32)

        g = torch.Generator().manual_seed(seed)
        kw = dict(inp_size=self.inp_size, inp_ch=3, out_size=S,
                  style_dim=512, n_mlp=2,
                  channel_max=int(opt.get("channel_max", 512)), generator=g)
        self.color_net = DualStyleUNet(out_ch=3, **kw)
        self.position_net = DualStyleUNet(out_ch=3, **kw)
        self.other_net = DualStyleUNet(out_ch=8, **kw)
        self.style_dim = 512
        if self.with_viewdirs:
            self.viewdir_net = nn.Sequential(
                nn.Conv2d(1, 64, 4, 2, 1), nn.LeakyReLU(0.2),
                nn.Conv2d(64, 128, 4, 2, 1))
            with torch.no_grad():
                for conv, fan_in in ((self.viewdir_net[0], 1 * 16),
                                     (self.viewdir_net[2], 64 * 16)):
                    lim = 1.0 / math.sqrt(fan_in)
                    conv.weight.copy_(torch.rand(conv.weight.shape,
                                                 generator=g) * 2 * lim - lim)
                    conv.bias.zero_()
        colors = torch.rand((self.n_points, 3), generator=g)
        self.to(dev)
        self.cano_gaussian = create_from_pcd(self.init_points, colors.to(dev))

    def constant_style(self) -> torch.Tensor:
        return torch.ones((1, self.style_dim), device=self.lbs.device) \
            / math.sqrt(self.style_dim)

    # -- map <-> point-set plumbing ------------------------------------
    def _net_out_to_map(self, out, out_ch: int):
        """CNN output (1, S, S, 2C) -> (S, 2S, C) front|back map."""
        return torch.cat([out[0, :, :, :out_ch], out[0, :, :, out_ch:]],
                         dim=1)

    def _select_masked_dual(self, outs):
        """[(1, S, S, 2C_i)] raw head outputs -> (N, sum C_i) masked texels:
        front blocks take channels [:C_i], back blocks [C_i:] of the same
        block row."""
        tb, S = self.texel_block, self.out_size
        x = torch.cat([o[0] for o in outs], dim=-1)
        rows = x.reshape(S * S // tb, tb, x.shape[-1])[self.dual_row]
        vals, off = [], 0
        for o in outs:
            c2 = o.shape[-1]
            seg = rows[:, :, off:off + c2]
            vals.append(torch.where(self.dual_front, seg[:, :, :c2 // 2],
                                    seg[:, :, c2 // 2:]))
            off += c2
        return torch.cat(vals, dim=-1).reshape(self.n_points, -1)

    def _scatter_masked_half(self, vals):
        """(N,) point values -> (H/2, W/2) half-res map, zeros elsewhere."""
        hb = self.texel_block // 2
        hh, hw = self.map_h // 2, self.map_w // 2
        v = vals.reshape(self.n_points)[self.vd_half_src]
        out = torch.zeros((hh * hw // hb, hb), dtype=vals.dtype,
                          device=vals.device)
        out[self.vd_half_tgt] = v.reshape(-1, hb)
        return out.reshape(hh, hw)

    def _point_mats(self, jnt_mats):
        """(J, 4, 4) joint affines -> (N, 4, 4) LBS-blended per point."""
        return (self.lbs @ jnt_mats.reshape(jnt_mats.shape[0], 16)).reshape(
            -1, 4, 4)

    # -- view-direction conditioning (ref: avatar.py:126-147) -------------
    def _viewdir_half_map(self, items, noise=None):
        """One frame's normal.viewdir dots scattered to the (H/2, W/2) map;
        ``noise`` (N, 3) standard normal jitters the directions in training
        (JAX avatar.py:319-322)."""
        pt_mats = self._point_mats(items["cano2live_jnt_mats"])
        R = pt_mats[:, :3, :3]
        live_pts = (torch.einsum("nxy,ny->nx", R, self.init_points)
                    + pt_mats[:, :3, 3])
        live_nmls = torch.einsum("nxy,ny->nx", R, self.cano_nmls)
        extr = items["extr"]
        cam_pos = -extr[:3, :3].T @ extr[:3, 3]
        viewdirs = cam_pos[None] - live_pts
        viewdirs = viewdirs / torch.clamp(
            torch.linalg.norm(viewdirs, dim=-1, keepdim=True), min=1e-3)
        if noise is not None:
            viewdirs = viewdirs + 0.1 * noise
            viewdirs = viewdirs / torch.clamp(
                torch.linalg.norm(viewdirs, dim=-1, keepdim=True), min=1e-3)
        dots = torch.sum(live_nmls * viewdirs, dim=-1)
        return self._scatter_masked_half(dots)

    def _encode_viewdirs(self, vmaps):
        """(B, H/2, W/2) half-res dot maps -> two (B, h, w, 128) NHWC
        features (front/back)."""
        half = vmaps.shape[2] // 2

        def encode(v):
            return self.viewdir_net(v[:, None]).permute(0, 2, 3, 1)

        return encode(vmaps[:, :, :half]), encode(vmaps[:, :, half:])

    # -- skinning (ref: avatar.py:84-91) ---------------------------------
    def transform_cano2live(self, gaussian_vals: dict, items: dict) -> dict:
        pt_mats = self._point_mats(items["cano2live_jnt_mats"])
        m = pt_mats[:, :3, :]                                  # (N, 3, 4)
        p = gaussian_vals["positions"]
        positions = (m[:, :, 0] * p[:, 0:1] + m[:, :, 1] * p[:, 1:2]
                     + m[:, :, 2] * p[:, 2:3] + m[:, :, 3])
        q = quat_ops.quat_to_mat(gaussian_vals["rotations"])   # (N, 3, 3)
        rot = (m[:, :, 0, None] * q[:, None, 0, :]
               + m[:, :, 1, None] * q[:, None, 1, :]
               + m[:, :, 2, None] * q[:, None, 2, :])
        out = dict(gaussian_vals)
        out["positions"] = positions
        out["rotations"] = quat_ops.mat_to_quat(rot)
        return out

    # -- heads one at a time, for the pretrain step (ref: avatar.py:93-124) --
    def get_positions(self, pose_map):
        """(S, S, 3) pose map -> (N, 3) canonical positions."""
        out = self.position_net(self.constant_style(), pose_map[None])
        return 0.05 * self._select_masked_dual([out]) + self.cano_gaussian.xyz

    def get_others(self, pose_map):
        """(S, S, 3) pose map -> activated opacity (N, 1), scales (N, 3)
        and unit rotations (N, 4)."""
        out = self.other_net(self.constant_style(), pose_map[None])
        others = self._select_masked_dual([out])                # (N, 8)
        g = self.cano_gaussian
        return (torch.sigmoid(others[:, 0:1] + g.opacity),
                torch.exp(others[:, 1:4] + g.scaling),
                quat_ops.normalize(others[:, 4:8] + g.rotation))

    # -- render (ref: avatar.py:161-239) ----------------------------------
    def _head_outputs(self, pose_maps, front_vd, back_vd):
        """(B, S, S, 3) pose maps -> three raw (B, S, S, 2C) outputs. With
        the constant style the modulated convs share one weight across the
        batch, so B frames run as one batched conv stack."""
        style = self.constant_style()
        return (self.position_net(style, pose_maps),
                self.other_net(style, pose_maps),
                self.color_net(style, pose_maps, view_feature1=front_vd,
                               view_feature2=back_vd))

    def _finish_render(self, items, pos_out, other_out, color_out, bg,
                       img_w, img_h, full=True, plain=False):
        """Masked select -> Gaussian attributes -> LBS -> splat for ONE
        frame, from raw (1, S, S, 2C) head outputs."""
        sel = self._select_masked_dual([pos_out, other_out, color_out])
        g = self.cano_gaussian
        cano_pts = 0.05 * sel[:, :3] + g.xyz
        opacity = torch.sigmoid(sel[:, 3:4] + g.opacity)
        scales = torch.exp(sel[:, 4:7] + g.scaling)
        rotations = quat_ops.normalize(sel[:, 7:11] + g.rotation)
        colors = sel[:, 11:14]
        gaussian_vals = dict(positions=cano_pts, opacity=opacity,
                             scales=scales, rotations=rotations,
                             colors=colors)
        # pad points excluded: their CNN texels are garbage, not offsets
        offset = (cano_pts - self.init_points) * self.valid_f[:, None]
        gaussian_vals = self.transform_cano2live(gaussian_vals, items)
        img_w = int(items["img_w"]) if img_w is None else img_w
        img_h = int(items["img_h"]) if img_h is None else img_h
        out = splat(gaussian_vals["positions"], gaussian_vals["scales"],
                    gaussian_vals["rotations"],
                    gaussian_vals["opacity"].reshape(-1),
                    gaussian_vals["colors"], bg, items["extr"],
                    items["intr"], img_w, img_h, valid_mask=self.valid,
                    plain=plain)
        ret = dict(rgb_map=out["render"], mask_map=out["mask"],
                   depth_map=out["depth"], offset=offset,
                   pos_map=self._net_out_to_map(pos_out, 3),
                   n_pairs=out["n_pairs"])
        if full:
            ret.update(cano_tex_map=self._net_out_to_map(color_out, 3),
                       posed_gaussians=gaussian_vals)
        return ret

    def _bg(self, bg_color):
        return torch.as_tensor(bg_color, dtype=torch.float32,
                               device=self.lbs.device)

    def render(self, items: dict, bg_color=(0.0, 0.0, 0.0),
               img_w: Optional[int] = None, img_h: Optional[int] = None,
               training: bool = False, draws: Optional[dict] = None,
               plain: bool = False) -> dict:
        """One frame. ``items``: tensors on the module's device —
        smpl_pos_map (S, S, >=3), cano2live_jnt_mats (J, 4, 4), extr, intr.

        By default a novel-pose render without autograd. ``training=True``
        records the graph for the train step and leaves out the outputs it
        does not use; ``draws["viewdir_noise"]`` (N, 3), if given, jitters
        the view directions. ``plain=True`` splats through the kernels'
        plain versions."""
        grad = contextlib.nullcontext() if training else torch.no_grad()
        with grad:
            pose_map = items["smpl_pos_map"][..., :3]
            front_vd = back_vd = None
            if self.with_viewdirs:
                noise = (draws or {}).get("viewdir_noise") if training \
                    else None
                front_vd, back_vd = self._encode_viewdirs(
                    self._viewdir_half_map(items, noise)[None])
            pos_out, other_out, color_out = self._head_outputs(
                pose_map[None], front_vd, back_vd)
            return self._finish_render(items, pos_out, other_out, color_out,
                                       self._bg(bg_color), img_w, img_h,
                                       full=not training, plain=plain)

    @torch.no_grad()
    def render_sequence(self, items_seq: dict, bg_color=(0.0, 0.0, 0.0),
                        img_w: Optional[int] = None,
                        img_h: Optional[int] = None) -> dict:
        """F stacked frames: the three heads run as ONE batch-F conv stack,
        then a per-frame select/skin/splat loop (binning sizes are per
        frame). Returns rgb/mask/depth stacked (F, H, W[, 3])."""
        pose_maps = items_seq["smpl_pos_map"][..., :3]          # (F, S, S, 3)
        n_frames = pose_maps.shape[0]
        frames = [{k: v[f] for k, v in items_seq.items()}
                  for f in range(n_frames)]
        front_vd = back_vd = None
        if self.with_viewdirs:
            front_vd, back_vd = self._encode_viewdirs(torch.stack(
                [self._viewdir_half_map(it) for it in frames]))
        pos_out, other_out, color_out = self._head_outputs(
            pose_maps, front_vd, back_vd)
        bg = self._bg(bg_color)
        outs = [self._finish_render(it, pos_out[f:f + 1],
                                    other_out[f:f + 1], color_out[f:f + 1],
                                    bg, img_w, img_h, full=False)
                for f, it in enumerate(frames)]
        return {k: torch.stack([o[k] for o in outs])
                for k in ("rgb_map", "mask_map", "depth_map")}
