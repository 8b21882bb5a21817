"""Plain PyTorch template step: AnimatableGaussians' SDF-NeRF template
(``network/template.py:23-405``) trained as ``main_template.py:18-144``
trains it, written for this check from the published model and its CUDA
extensions' semantics, in float32 with TF32 off (set here on import;
``set_tf32(True)`` makes the control).

One step on a ray batch of one frame:

* near/far: the union of the live SMPL vertices' spheres of radius 0.1
  along each ray (``near_far_smpl_kernel.cu``), near clamped at 0, the
  ray's box bounds where it meets no sphere;
* 64 stratified depths a ray (``nerf_util.py:102-131``);
* live -> canonical: LBS weights blended barycentrically on the nearest
  face of the live body (``nearest_face.py``; here the point's projection
  onto the face's plane where it falls inside the face, else the nearest
  of the three edges' closest points; the first face wins ties), the
  blended affine inverted, then 10 Newton iterations
  (``root_finding.cu``: lambda 0.1, the step clipped to +-0.01, the
  weights trilinear in the weight volume, their gradient the nearest
  voxel's of its Sobel gradient volume), which the points whose largest
  weight is bone 7, 8, 10 or 11 skip;
* the SDF MLP on the canonical points' embedding (softplus beta 100, the
  skip at layer 4, weight norm), the eikonal normal as the input
  gradient of its raw SDF with a graph (so the loss's backward is a
  double backward), the texture MLP and the Laplace density;
* each hand's field fused in (``template.py:146-202``), compositing,
  colour and mask L1 and the eikonal term; Adam on the Step schedule.

Departures from the published description, each the repository's reading
that the program follows too: the skip layer concatenates its input
without a 1/sqrt(2); the SDF's sign is flipped (``sdf = -raw``) and the
fused density is the Laplace density of ``-sdf``; the eikonal normal is
the body's raw SDF gradient also where the hands are fused; a 3x3 system
is solved here by its adjugate (Cramer's rule), where the CUDA extension
calls a batched LU; weight norm divides by the row's norm without the
program's 1e-12. The view directions reach no network (``use_viewdir``
is off and the hands have no view embedder), so their draws are taken
and not used.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEAR_FAR_RADIUS = 0.1
PAIRS_PER_BLOCK = 1 << 24
NONOPT_BONES = (7, 8, 10, 11)
NEWTON_ITERS, NEWTON_LAMBDA, NEWTON_CLIP = 10, 0.1, 0.01
SDF_LAYERS, SDF_SKIP = 7, 4
GROUPS = ("geo_mlp", "tex_mlp", "density", "left_hand", "right_hand")


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


set_tf32(False)


# -- geometry ---------------------------------------------------------------

def near_far(verts, ray_o, ray_d, near, far, block: int = 1024):
    """Each ray's entry and exit of the union of the vertices' spheres;
    the given near/far where it meets none."""
    r2 = NEAR_FAR_RADIUS ** 2
    outs = []
    for s in range(0, ray_o.shape[0], block):
        oc = verts[None] - ray_o[s:s + block, None]          # (n, V, 3)
        along = torch.sum(oc * ray_d[s:s + block, None], -1)
        off2 = torch.sum(oc * oc, -1) - along * along        # line distance
        half2 = r2 - off2
        hit = half2 > 0
        half = torch.sqrt(torch.clamp(half2, min=0.0))
        n = torch.where(hit, along - half, math.inf).amin(1).clamp(min=0)
        f = torch.where(hit, along + half, -math.inf).amax(1)
        any_hit = hit.any(1)
        outs.append((torch.where(any_hit, n, near[s:s + block]),
                     torch.where(any_hit, f, far[s:s + block])))
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def nearest_face(points, verts, faces):
    """(distance (N,), face (N,), barycentric weights (N, 3)) of each
    point's nearest face: the plane's distance where the point projects
    inside the face, else the nearest edge point's; the first face of
    equal distance wins."""
    tri = verts[faces.long()]
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    e0, e1 = b - a, c - a
    nrm = torch.linalg.cross(e0, e1)
    nn2 = torch.sum(nrm * nrm, -1)
    d00, d01, d11 = (torch.sum(e0 * e0, -1), torch.sum(e0 * e1, -1),
                     torch.sum(e1 * e1, -1))
    den = d00 * d11 - d01 * d01
    edges = [(a, b - a), (b, c - b), (c, a - c)]
    elen2 = [torch.sum(e * e, -1).clamp(min=1e-30) for _, e in edges]
    block = max(1, PAIRS_PER_BLOCK // max(1, faces.shape[0]))
    ds, ids, bcs = [], [], []
    for s in range(0, points.shape[0], block):
        p = points[s:s + block, None]                        # (m, 1, 3)
        ap = p - a
        d20, d21 = torch.sum(ap * e0, -1), torch.sum(ap * e1, -1)
        v = (d11 * d20 - d01 * d21) / den
        w = (d00 * d21 - d01 * d20) / den
        u = 1.0 - v - w
        inside = (u >= 0) & (v >= 0) & (w >= 0)
        h = torch.sum(ap * nrm, -1)
        best = torch.where(inside, h * h / nn2, math.inf)
        bary = torch.stack([u, v, w], -1)
        for k, (o, e) in enumerate(edges):
            t = torch.clamp(torch.sum((p - o) * e, -1) / elen2[k], 0.0, 1.0)
            q = o + t[..., None] * e
            dk = torch.sum((p - q) ** 2, -1)
            nearer = dk < best
            best = torch.where(nearer, dk, best)
            z = torch.zeros_like(t)
            pair = [1.0 - t, t]
            bk = torch.stack([pair[0], pair[1], z] if k == 0 else
                             [z, pair[0], pair[1]] if k == 1 else
                             [pair[1], z, pair[0]], -1)
            bary = torch.where(nearer[..., None], bk, bary)
        idx = torch.argmin(best, 1)                          # first of ties
        ds.append(torch.sqrt(best.gather(1, idx[:, None])[:, 0]))
        ids.append(idx)
        bcs.append(bary[torch.arange(len(idx), device=idx.device), idx])
    return torch.cat(ds), torch.cat(ids), torch.cat(bcs)


def interpolate(attrs, faces, idx, bary):
    return torch.sum(attrs[faces.long()[idx]] * bary[..., None], 1)


def inv3(m):
    """The inverse of each 3x3 matrix by its adjugate."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e,
                      f * g - d * i, a * i - c * g, c * d - a * f,
                      d * h - e * g, b * g - a * h, a * e - b * d], -1)
    det = a * co[..., 0] + b * co[..., 3] + c * co[..., 6]
    return (co / det[..., None]).reshape(m.shape)


def sobel_gradient(vol, voxel):
    """(J, X, Y, Z) -> (J, 3, X, Y, Z): the central difference along each
    axis over 2 voxels, smoothed by [1, 2, 1] / 4 along the two others,
    with zeros beyond the border (``network/volume.py:9-40``)."""
    p = F.pad(vol, (1, 1, 1, 1, 1, 1))
    out = []
    for ax in range(3):
        lo = [slice(None)] * 4
        hi = [slice(None)] * 4
        lo[1 + ax], hi[1 + ax] = slice(0, -2), slice(2, None)
        g = p[tuple(hi)] - p[tuple(lo)]
        for other in (o for o in range(3) if o != ax):
            s = [slice(None)] * 4
            parts = []
            for k in range(3):
                s[1 + other] = slice(k, g.shape[1 + other] - 2 + k)
                parts.append(g[tuple(s)])
            g = (parts[0] + 2 * parts[1] + parts[2]) / 4
        out.append(g / (2 * voxel[ax]))
    return torch.stack(out, 1)


class Volume:
    """The weight volume (X, Y, Z, J) over ``bounds``: the weights and
    their Sobel gradient, channels last, read at a point by the voxel
    coordinate ``clamp((x - lo) / (hi - lo), 0, 1) (res - 1)``: the
    weights as the sum of the eight corners' weights times their
    trilinear factors, the gradient at the nearest voxel (half to even)."""

    def __init__(self, weights, bounds):
        self.lo, self.hi = bounds[0], bounds[1]
        self.res = torch.tensor(weights.shape[:3], device=weights.device)
        voxel = (self.hi - self.lo) / (self.res - 1).float()
        self.joints = weights.shape[3]
        self.w = weights.reshape(-1, self.joints)
        g = sobel_gradient(weights.permute(3, 0, 1, 2), voxel)
        self.g = g.permute(2, 3, 4, 0, 1).reshape(-1, self.joints * 3)

    def _flat(self, i):
        ny, nz = int(self.res[1]), int(self.res[2])
        return (i[:, 0] * ny + i[:, 1]) * nz + i[:, 2]

    def weights_and_grads(self, x):
        u = torch.clamp((x - self.lo) / (self.hi - self.lo), 0.0, 1.0) * \
            (self.res - 1).float()
        top = self.res - 1
        near = torch.minimum(torch.round(u).long(), top)
        base = torch.minimum(torch.floor(u).long(), top)
        f = u - base.float()
        w = 0.0
        for corner in range(8):
            bit = torch.tensor([(corner >> 2) & 1, (corner >> 1) & 1,
                                corner & 1], device=x.device)
            idx = torch.minimum(base + bit, top)
            fac = torch.prod(torch.where(bit.bool(), f, 1 - f), 1)
            w = w + fac[:, None] * self.w[self._flat(idx)]
        g = self.g[self._flat(near)].reshape(-1, self.joints, 3)
        return w, g


def root_finding(volume: Volume, xt, xc, mats):
    r, t = mats[:, :3, :3], mats[:, :3, 3]
    for _ in range(NEWTON_ITERS):
        w, g = volume.weights_and_grads(xc)
        each = torch.einsum("jxy,ny->njx", r, xc) + t        # (N, J, 3)
        fwd = torch.einsum("nj,njx->nx", w, each)
        jac = torch.einsum("nj,jxy->nxy", w, r) + NEWTON_LAMBDA * \
            torch.einsum("njx,njy->nxy", each, g)
        step = torch.einsum("nxy,ny->nx", inv3(jac), fwd - xt)
        xc = xc - torch.clamp(step, -NEWTON_CLIP, NEWTON_CLIP)
    return xc


@torch.no_grad()
def live_to_cano(items, volume: Volume, pts, root: bool = True):
    mats = items["cano2live_jnt_mats"]
    _, fid, bary = nearest_face(pts, items["live_smpl_v"],
                                items["smpl_faces"])
    w = interpolate(items["smpl_lbs"], items["smpl_faces"], fid, bary)
    blend = torch.einsum("nj,jxy->nxy", w, mats)
    inv = inv3(blend[:, :3, :3])
    cano = torch.einsum("nxy,ny->nx", inv, pts - blend[:, :3, 3])
    if not root:
        return cano
    refined = root_finding(volume, pts, cano, mats)
    keep = torch.isin(w.argmax(1), torch.tensor(NONOPT_BONES,
                                                device=pts.device))
    return torch.where(keep[:, None], cano, refined)


# -- the networks -------------------------------------------------------------

def embed(x, multires: int):
    return torch.cat([x] + [f(x * 2.0 ** k) for k in range(multires)
                            for f in (torch.sin, torch.cos)], -1)


def linear(params, key: str, x, weight_norm: bool = False):
    v = params[key + ".weight"]
    if weight_norm:
        v = params[key + ".g"][:, None] * v / v.norm(dim=1, keepdim=True)
    return F.linear(x, v, params[key + ".bias"])


def sdf_mlp(params, x):
    inp = x
    for l in range(SDF_LAYERS):
        if l == SDF_SKIP:
            x = torch.cat([x, inp], -1)
        x = linear(params, f"geo_mlp.layers.{l}", x, weight_norm=True)
        if l < SDF_LAYERS - 1:
            x = F.softplus(x, beta=100.0, threshold=20.0)
    return x


def relu_mlp(params, prefix: str, x, n_layers: int):
    for l in range(n_layers):
        x = linear(params, f"{prefix}.layers.{l}", x)
        x = torch.relu(x) if l < n_layers - 1 else torch.sigmoid(x)
    return x


def laplace_density(params, sdf):
    beta = params["density.beta"].abs() + 1e-4
    return (0.5 + 0.5 * sdf.sign() * torch.expm1(-sdf.abs() / beta)) / beta


def box_normalize(verts, x):
    lo, hi = verts.amin(0), verts.amax(0)
    return (x - 0.5 * (lo + hi)) / (0.5 * (hi - lo))


def hand_field(params, side: str, items, pts):
    """(canonical point in the hand's box, hand SDF (N, 1), colour (N, 3))
    of one hand at the live points."""
    faces = items["mano_face_closed"]
    if side == "left":
        faces = faces.flip(1)
    live = items[f"{side}_live_mano_v"]
    with torch.no_grad():
        dist, fid, bary = nearest_face(pts, live, faces)
    cano = interpolate(box_normalize(items[f"{side}_cano_mano_v"],
                                     items[f"{side}_cano_mano_v"]),
                       faces, fid, bary)
    on = interpolate(live, faces, fid, bary)
    nrm = interpolate(items[f"{side}_live_mano_n"], faces, fid, bary)
    sdf = (-torch.sign(torch.sum(nrm * (pts - on), -1)) * dist)[:, None]
    pose = torch.zeros(15, 4, device=pts.device)
    pose[:, 0] = 1.0                        # the zero pose's quaternions
    feat = torch.cat([embed(cano, 4), sdf,
                      pose.reshape(1, 60).expand(pts.shape[0], 60)], -1)
    return sdf, relu_mlp(params, f"{side}_hand.tex_mlp", feat, 6)


# -- the step -----------------------------------------------------------------

def loss_terms(params, volume: Volume, items, draws, cfg: dict):
    """-> {color, mask, eikonal, total} of one step on ``items``' rays with
    ``draws`` (``t_rand`` (R, S))."""
    m, tr = cfg["model"], cfg["train"]
    lw = tr["loss_weight"]
    n_s = int(tr["n_samples"])
    ray_o, ray_d = items["ray_o"], items["ray_d"]
    near, far = near_far(items["live_smpl_v"], ray_o, ray_d, items["near"],
                         items["far"])
    t = torch.linspace(0.0, 1.0, n_s, device=ray_o.device)
    z = near[:, None] * (1 - t) + far[:, None] * t
    mid = 0.5 * (z[:, 1:] + z[:, :-1])
    lower = torch.cat([z[:, :1], mid], 1)
    upper = torch.cat([mid, z[:, -1:]], 1)
    z = lower + (upper - lower) * draws["t_rand"]
    pts = (ray_o[:, None] + ray_d[:, None] * z[..., None]).reshape(-1, 3)

    cano = live_to_cano(items, volume, pts,
                        root=bool(m["use_root_finding"]))
    xg = cano.detach().requires_grad_(True)
    raw = sdf_mlp(params, embed(xg, int(m["multires"])))
    normal, = torch.autograd.grad(raw[:, 0].sum(), xg, create_graph=True)
    sdf = -raw[:, :1]
    color = relu_mlp(params, "tex_mlp", raw[:, 1:], 4)
    density = laplace_density(params, raw[:, :1])
    if m["with_hand"]:
        l_sdf, l_col = hand_field(params, "left", items, pts)
        r_sdf, r_col = hand_field(params, "right", items, pts)
        wl = torch.sigmoid(25 * (box_normalize(
            items["left_cano_mano_v"], cano)[:, :1] + 0.8))
        wr = torch.sigmoid(-25 * (box_normalize(
            items["right_cano_mano_v"], cano)[:, :1] - 0.8))
        below = cano[:, 1:2] < items["cano_smpl_center"][1]
        wl = torch.where(below, 0.0, wl)
        wr = torch.where(below, 0.0, wr)
        s = torch.clamp(wl + wr, min=1.0)
        wl, wr = wl / s, wr / s
        rest = 1 - wl - wr
        sdf = wl * l_sdf + wr * r_sdf + rest * sdf
        color = wl * l_col + wr * r_col + rest * color
        density = laplace_density(params, -sdf)

    R = ray_o.shape[0]
    dz = z[:, 1:] - z[:, :-1]
    dz = torch.cat([dz, dz[:, -1:]], 1)
    alpha = 1 - torch.exp(-density.reshape(R, n_s) * dz)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1 - alpha + 1e-10], 1), 1)[:, :-1]
    weight = alpha * trans
    rgb = torch.sum(weight[..., None] * color.reshape(R, n_s, 3), 1)
    acc = torch.sum(weight, 1)
    out = dict(color=torch.abs(rgb - items["color_gt"]).mean(),
               mask=torch.abs(acc - items["mask_gt"]).mean(),
               eikonal=((normal.norm(dim=-1) - 1) ** 2).mean())
    out["total"] = (lw["color"] * out["color"] + lw["mask"] * out["mask"]
                    + lw["eikonal"] * out["eikonal"])
    return out


class Adam:
    """Adam (0.9, 0.999, eps 1e-8 outside the square root) at the Step
    schedule: update k takes lr = max(initial factor^(k // interval),
    min)."""

    def __init__(self, params: dict, sched: dict):
        self.params = list(params.values())
        self.s, self.t = sched, 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    def lr(self, k: int) -> float:
        s = self.s
        return max(s["initial"] * s["factor"] ** (k // s["interval"]),
                   s["min"])

    @torch.no_grad()
    def step(self):
        lr = self.lr(self.t)
        self.t += 1
        for p, m, v in zip(self.params, self.m, self.v):
            if p.grad is None:
                continue
            m.mul_(0.9).add_(p.grad, alpha=0.1)
            v.mul_(0.999).addcmul_(p.grad, p.grad, value=0.001)
            mh = m / (1 - 0.9 ** self.t)
            vh = v / (1 - 0.999 ** self.t)
            p.sub_(lr * mh / (vh.sqrt() + 1e-8))


def group_of(name: str) -> str:
    return name.split(".")[0]


def flat_groups(tensors: dict) -> dict:
    """Name -> tensor, flattened and joined by group in name order."""
    out = {}
    for k in sorted(tensors):
        out.setdefault(group_of(k), []).append(tensors[k].reshape(-1))
    return {g: torch.cat(v) for g, v in out.items()}


def train(weights: dict, volume: Volume, batches: list, draws: list,
          cfg: dict) -> dict:
    """The reference's steps from ``weights`` over ``batches`` with
    ``draws``: {"loss": [terms of each step], "grad": the first step's
    gradient by group, "delta": each group's change after the steps}."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items()}
    opt = Adam(params, cfg["train"]["lr"]["network"])
    out = dict(loss=[])
    for i, (items, d) in enumerate(zip(batches, draws)):
        for p in params.values():
            p.grad = None
        terms = loss_terms(params, volume, items, d, cfg)
        terms["total"].backward()
        out["loss"].append({k: float(v.detach()) for k, v in terms.items()})
        if i == 0:
            out["grad"] = flat_groups({k: p.grad if p.grad is not None
                                       else torch.zeros_like(p)
                                       for k, p in params.items()})
        opt.step()
    out["delta"] = flat_groups({k: p.detach() - weights[k]
                                for k, p in params.items()})
    return out
