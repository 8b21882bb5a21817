"""TemplateNet: the SDF-NeRF geometry template with LBS canonicalisation,
a port of ``animatablegaussians_tpu/models/template.py`` (ref:
network/template.py:23-405) as an ``nn.Module``:

  * the embedded SDF MLP (geometric init, softplus beta = 100), the
    texture MLP and ``LaplaceDensity`` (ref: template.py:36-67);
  * live -> canonical inverse skinning: barycentric LBS weights from the
    nearest SMPL face, the inverse blended affines, then optionally the
    Newton root finding, which skips points whose strongest bone is one of
    the non-optimised 7, 8, 10, 11 (ref: template.py:226-286);
  * canonical -> live forward skinning through the weight volume;
  * rigid hands when ``with_hand`` is off (joints 25-39 / 40-54 take the
    wrists' 20 / 21), hand colour fields fused in when it is on (ref:
    template.py:146-214);
  * volume rendering with SMPL-guided near/far (ref: template.py:288-405).

The eikonal normal is ``torch.autograd.grad`` of the raw SDF with respect
to a ``requires_grad`` copy of the canonical points, with
``create_graph=True``, so the eikonal loss reaches the MLP's weights; it is
the body's normal, also after the hands are fused. The output's sign is
inverted (``sdf = -raw``, outside < 0), and ``fuse_hands`` takes the density
of ``-sdf``, as in the JAX package. The training draws (the stratified
jitter's U(0, 1) and the view directions' N(0, 1)) come from a
``torch.Generator`` or, for a test, from ``draws``.

Spans (``utils/profiling.span``, recorded only under a profiler):
``template.near_far``, ``template.live2cano`` (blending weights, the
inverse, the root finding), ``template.field`` (the SDF MLP, the eikonal
``autograd.grad``, the texture MLP, the density), ``template.hands`` and
``template.composite``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from animatablegaussians_torch.models.density import LaplaceDensity
from animatablegaussians_torch.models.hand_avatar import HandAvatar
from animatablegaussians_torch.models.mlp import MLPLinear, SdfMLP
from animatablegaussians_torch.models.volume import CanoBlendWeightVolume
from animatablegaussians_torch.ops import geometry3d as g3d
from animatablegaussians_torch.ops.embedder import get_embedder
from animatablegaussians_torch.ops.root_finding import root_finding
from animatablegaussians_torch.utils import nerf as nerf_util
from animatablegaussians_torch.utils.geometry import normalize_vert_bbox
from animatablegaussians_torch.utils.profiling import span

NONOPT_BONE_IDS = (7, 8, 10, 11)  # feet and toes skip the root finding


class TemplateNet(nn.Module):
    def __init__(self, opt: dict, weight_volume: CanoBlendWeightVolume,
                 device="cuda", seed: int = 0):
        super().__init__()
        self.opt = dict(opt or {})
        self.volume = weight_volume
        self.with_hand = self.opt.get("with_hand", False)
        self.use_root_finding = self.opt.get("use_root_finding", False)
        self.volume_type = self.opt.get("volume_type", "diff")

        self.pos_embedder, self.pos_dim = get_embedder(
            self.opt.get("multires", 6), 3)
        self.geo_mlp = SdfMLP(
            in_channels=self.pos_dim, out_channels=256 + 1,
            inter_channels=[512, 256, 256, 256, 256, 256], res_layers=[4],
            geometric_init=True, bias=0.7, weight_norm=True, device=device,
            seed=seed)
        if self.opt.get("use_viewdir", False):
            self.viewdir_embedder, self.viewdir_dim = get_embedder(
                self.opt.get("multires_viewdir", 4), 3)
        else:
            self.viewdir_embedder, self.viewdir_dim = None, 0
        self.tex_mlp = MLPLinear(
            in_channels=256 + self.viewdir_dim, out_channels=3,
            inter_channels=[256, 256, 256], last_op="sigmoid",
            device=device, seed=seed + 1)
        self.density = LaplaceDensity(beta_init=0.01, device=device)
        self.left_hand = HandAvatar(device=device, seed=seed + 2)
        self.right_hand = HandAvatar(device=device, seed=seed + 3)

        wv = (weight_volume.diff_weight_volume if self.volume_type == "diff"
              else weight_volume.ori_weight_volume)
        self.weight_volume_arr = wv                      # (X, Y, Z, J)
        self.grad_volume_arr = weight_volume.grad_volume.reshape(
            *wv.shape[:3], weight_volume.joint_num * 3)

    # -- canonical radiance field (ref: template.py:92-140) --------------
    @span("template.field")
    def forward_cano_body_nerf(self, xyz, viewdirs,
                               compute_grad: bool = False) -> dict:
        if compute_grad:
            with torch.enable_grad():
                xyz_g = xyz.detach().requires_grad_(True)
                feat = self.geo_mlp(self.pos_embedder(xyz_g))
                normal, = torch.autograd.grad(feat[..., 0].sum(), xyz_g,
                                              create_graph=True)
        else:
            feat = self.geo_mlp(self.pos_embedder(xyz))
        sdf_raw, geo_feat = feat[..., 0], feat[..., 1:]
        if self.viewdir_embedder is not None:
            vd = torch.zeros_like(xyz) if viewdirs is None else viewdirs
            geo_feat = torch.cat([geo_feat, self.viewdir_embedder(vd)], -1)
        ret = dict(sdf=-sdf_raw[..., None],
                   density=self.density(sdf_raw[..., None]),
                   color=self.tex_mlp(geo_feat), cano_xyz=xyz.detach())
        if compute_grad:
            ret["normal"] = normal
        return ret

    # -- skinning (ref: template.py:209-286) ------------------------------
    def _rigid_hand_mats(self, jnt_mats: torch.Tensor) -> torch.Tensor:
        if self.with_hand:
            return jnt_mats
        m = jnt_mats.clone()
        m[25:40] = jnt_mats[20:21]
        m[40:55] = jnt_mats[21:22]
        return m

    def transform_cano2live(self, cano_pts, items, normals=None):
        mats = self._rigid_hand_mats(items["cano2live_jnt_mats"])
        w = self.volume.forward_weight(cano_pts, volume_type=self.volume_type)
        posed, pt_mats = g3d.skinning(cano_pts, w, mats, return_pt_mats=True)
        if normals is None:
            return posed
        return posed, torch.einsum("nxy,ny->nx", pt_mats[:, :3, :3],
                                   normals)

    @span("template.live2cano")
    def transform_live2cano(self, posed_pts, items, normals=None,
                            near_thres: float = 0.08):
        mats = self._rigid_hand_mats(items["cano2live_jnt_mats"])
        pts_w, near_flag = g3d.calc_blending_weight(
            posed_pts.detach(), items["live_smpl_v"], items["smpl_faces"],
            items["smpl_lbs"], near_thres, method="barycentric")
        pt_mats = torch.einsum("nj,jxy->nxy", pts_w, mats)
        inv, _ = torch.linalg.inv_ex(pt_mats)   # no wait for the status
        cano_pts = (torch.einsum("nxy,ny->nx", inv[:, :3, :3], posed_pts)
                    + inv[:, :3, 3])
        cano_normals = None
        if normals is not None:
            cano_normals = torch.einsum("nxy,ny->nx", inv[:, :3, :3],
                                        normals)
        if self.use_root_finding:
            refined = root_finding(
                self.weight_volume_arr, self.grad_volume_arr, posed_pts,
                cano_pts, mats, self.volume.volume_bounds)
            argmax = torch.argmax(pts_w, dim=-1)
            nonopt = torch.zeros_like(argmax, dtype=torch.bool)
            for b in NONOPT_BONE_IDS:
                nonopt = nonopt | (argmax == b)
            cano_pts = torch.where(nonopt[:, None], cano_pts, refined)
        if normals is None:
            return cano_pts, near_flag
        return cano_pts, cano_normals, near_flag

    # -- hand fusion (ref: template.py:146-202) ---------------------------
    @span("template.hands")
    def fuse_hands(self, body_ret, posed_xyz, view_dirs, items,
                   space: str = "live") -> dict:
        mano_faces = items["mano_face_closed"]            # (F, 3)

        def one_hand(side):
            where = "live" if space == "live" else "cano"
            hv = items[f"{side}_{where}_mano_v"]
            hn = items[f"{side}_{where}_mano_n"]
            hf = torch.flip(mano_faces, [1]) if side == "left" else mano_faces
            dist, fidx, bary = g3d.nearest_face(posed_xyz, hv, hf)
            cano_hv = normalize_vert_bbox(items[f"{side}_cano_mano_v"],
                                          dim=0, per_axis=True)
            pts_cano = g3d.barycentric_interpolate(cano_hv, hf, fidx, bary)
            pts_live = g3d.barycentric_interpolate(hv, hf, fidx, bary)
            pts_n = g3d.barycentric_interpolate(hn, hf, fidx, bary)
            sdf = -torch.sign(torch.sum(pts_n * (posed_xyz - pts_live),
                                        -1)) * dist
            return pts_cano, sdf[:, None]

        l_cano, l_sdf = one_hand("left")
        r_cano, r_sdf = one_hand("right")
        zero_pose = torch.zeros((45,), device=posed_xyz.device)
        c_l = self.left_hand(l_cano, l_sdf, view_dirs, zero_pose)
        c_r = self.right_hand(r_cano, r_sdf, view_dirs, zero_pose)

        cano_xyz = body_ret["cano_xyz"]
        wl = torch.sigmoid(25 * (normalize_vert_bbox(
            items["left_cano_mano_v"], attris=cano_xyz, dim=0,
            per_axis=True)[:, 0:1] + 0.8))
        wr = torch.sigmoid(-25 * (normalize_vert_bbox(
            items["right_cano_mano_v"], attris=cano_xyz, dim=0,
            per_axis=True)[:, 0:1] - 0.8))
        below = (cano_xyz[:, 1] < items["cano_smpl_center"][1])[:, None]
        wl = torch.where(below, torch.zeros_like(wl), wl)
        wr = torch.where(below, torch.zeros_like(wr), wr)
        s = torch.clamp(wl + wr, min=1.0)
        wl, wr = wl / s, wr / s
        w = wl + wr

        sdf = wl * l_sdf + wr * r_sdf + (1 - w) * body_ret["sdf"]
        color = wl * c_l + wr * c_r + (1 - w) * body_ret["color"]
        out = dict(body_ret)
        out.update(sdf=sdf, color=color, density=self.density(-sdf))
        return out

    # -- volume rendering (ref: template.py:288-405) ----------------------
    def render_rays(self, items, ray_o, ray_d, near, far,
                    n_samples: int = 64, space: str = "live",
                    white_bkgd: bool = False, training: bool = False,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[dict] = None,
                    compute_normal: Optional[bool] = None) -> dict:
        """One ray batch (R, 3) / (R,) -> the maps. With ``training`` the
        depths are jittered and the view directions perturbed by 0.1
        N(0, 1): the draws are ``draws["t_rand"]`` (R, S) and
        ``draws["view_noise"]`` (R S, 3) when given, else drawn from
        ``generator``."""
        R = ray_o.shape[0]
        draws = draws or {}
        dev = ray_o.device
        pts, z_vals = nerf_util.sample_pts_on_rays(
            ray_o, ray_d, near, far, n_samples, perturb=training,
            generator=generator, t_rand=draws.get("t_rand"))
        dists = z_vals[:, 1:] - z_vals[:, :-1]
        dists = torch.cat([dists, dists[:, -1:]], -1)          # (R, S)

        flat = pts.reshape(R * n_samples, 3)
        if space == "live":
            cano_pts, _ = self.transform_live2cano(flat, items)
        else:
            cano_pts = flat

        viewdirs = ray_d / torch.linalg.norm(ray_d, dim=-1, keepdim=True)
        viewdirs = viewdirs[:, None].expand(pts.shape).reshape(
            R * n_samples, 3)
        if training:
            noise = draws.get("view_noise")
            if noise is None:
                noise = torch.randn(viewdirs.shape, generator=generator,
                                    device=dev)
            viewdirs = viewdirs + 0.1 * noise
            viewdirs = viewdirs / torch.linalg.norm(viewdirs, dim=-1,
                                                    keepdim=True)

        if compute_normal is None:
            compute_normal = training
        ret = self.forward_cano_body_nerf(cano_pts, viewdirs,
                                          compute_grad=compute_normal)
        if self.with_hand:
            ret = self.fuse_hands(ret, flat, viewdirs, items, space)

        with span("template.composite"):
            color = ret["color"].reshape(R, n_samples, 3)
            density = ret["density"].reshape(R, n_samples, 1)
            alpha = 1.0 - torch.exp(-density[..., 0] * dists)
            raw = torch.cat([color, alpha[..., None]], -1)
            rgb_map, _, acc_map, _, depth_map = nerf_util.raw2outputs(
                raw, z_vals, white_bkgd=white_bkgd)
        out = dict(rgb_map=rgb_map, acc_map=acc_map, depth_map=depth_map)
        if "normal" in ret:
            out["normal"] = ret["normal"].reshape(R, n_samples, 3)
        return out

    @span("template.near_far")
    def smpl_guided_near_far(self, items, ray_o, ray_d, near, far):
        """Near/far from the SMPL vertices' spheres, the AABB's where a ray
        misses them (ref: template.py:304-312)."""
        n, f, hit = g3d.near_far_smpl(items["live_smpl_v"], ray_o, ray_d)
        return torch.where(hit, n, near), torch.where(hit, f, far)
