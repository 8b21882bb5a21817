"""Build ``cano_weight_volume.npz``: the diffused LBS-weight volume, the
barycentric ("ori") volume and the signed-distance volume over a 128^3
canonical grid. A port of ``animatablegaussians_tpu/tools/
gen_weight_volume.py`` (ref: gen_data/gen_weight_volume.py:19-170, whose
external screened-Poisson binary the JAX package replaces by a diffusion):

  * area-weighted samples of the template surface, with barycentric LBS
    weights from the nearest SMPL-X face;
  * "diff": the samples' weights scattered to the grid by inverse-distance
    weighting of the 8 nearest samples, then 10 Jacobi smoothing sweeps and
    a normalisation;
  * "ori": each grid point's barycentric weights from its nearest SMPL-X
    face;
  * "sdf": the signed distance to the template, the sign from the
    interpolated vertex normals at the closest point.

Without ``template.ply`` the canonical SMPL-X is the template. The nearest-
face and KNN searches and the smoothing run on ``device``, chunked.

    python -m animatablegaussians_torch.tools.gen_weight_volume \\
        -c <template.yaml> [--res 128] [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np
import torch

RES = 128


def sample_surface(verts: np.ndarray, faces: np.ndarray, count: int,
                   rng=None):
    """Area-weighted surface sampling (ref: utils/geo_util.py:39-80)."""
    rng = rng or np.random.default_rng(0)
    tri = verts[faces]
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    fidx = rng.choice(len(faces), size=count, p=area / area.sum())
    r1 = np.sqrt(rng.random(count))
    r2 = rng.random(count)
    a, b, c = tri[fidx, 0], tri[fidx, 1], tri[fidx, 2]
    pts = (1 - r1)[:, None] * a + (r1 * (1 - r2))[:, None] * b \
        + (r1 * r2)[:, None] * c
    return pts.astype(np.float32), fidx


def make_grid(bounds: np.ndarray, res: int = RES) -> np.ndarray:
    xs = [np.linspace(bounds[0, i], bounds[1, i], res) for i in range(3)]
    g = np.meshgrid(*xs, indexing="ij")
    return np.stack(g, -1).reshape(-1, 3).astype(np.float32)


@torch.no_grad()
def knn_scatter_weights(grid: torch.Tensor, surf_pts: torch.Tensor,
                        surf_w: torch.Tensor, k: int = 8,
                        chunk: int = 4096) -> torch.Tensor:
    """Inverse-distance-weighted mean of the ``k`` nearest samples'
    weights at each grid point: (G, 3), (M, 3), (M, J) -> (G, J)."""
    outs = []
    for s in range(0, grid.shape[0], chunk):
        q = grid[s:s + chunk]
        d = [q[:, i:i + 1] - surf_pts[None, :, i] for i in range(3)]
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]      # (c, M)
        del d
        neg, idx = torch.topk(-d2, k, dim=1)
        del d2
        inv = 1.0 / torch.clamp(torch.sqrt(-neg), min=1e-6)
        outs.append(torch.sum(surf_w[idx] * inv[..., None], 1)
                    / torch.sum(inv, 1)[:, None])
    return torch.cat(outs)


@torch.no_grad()
def jacobi_smooth(vol: torch.Tensor, iters: int = 10,
                  lam: float = 0.5) -> torch.Tensor:
    """Diffusion sweeps over a (X, Y, Z, J) volume with periodic
    neighbours, the Poisson-diffusion analogue."""
    v = vol
    for _ in range(iters):
        nb = (torch.roll(v, 1, 0) + torch.roll(v, -1, 0)
              + torch.roll(v, 1, 1) + torch.roll(v, -1, 1)
              + torch.roll(v, 1, 2) + torch.roll(v, -1, 2)) / 6.0
        v = (1 - lam) * v + lam * nb
    return v


@torch.no_grad()
def signed_distance(grid: torch.Tensor, verts: np.ndarray,
                    faces: np.ndarray, chunk=None) -> torch.Tensor:
    """Signed point-to-mesh distance, the sign from the interpolated vertex
    normals at the closest point (igl.signed_distance's replacement; ref:
    gen_weight_volume.py:160-166)."""
    from animatablegaussians_torch.ops.geometry3d import (
        barycentric_interpolate, nearest_face)
    from animatablegaussians_torch.tools.gen_pos_maps import vertex_normals

    dev = grid.device
    vn = torch.as_tensor(vertex_normals(verts, faces), dtype=torch.float32,
                         device=dev)
    vj = torch.as_tensor(verts, dtype=torch.float32, device=dev)
    fj = torch.as_tensor(faces, dtype=torch.int64, device=dev)
    d, fi, bc = nearest_face(grid, vj, fj, chunk=chunk)
    n = barycentric_interpolate(vn, fj, fi, bc)
    surf = barycentric_interpolate(vj, fj, fi, bc)
    return torch.sign(torch.sum(n * (grid - surf), -1)) * d


def build_weight_volume(template_v: np.ndarray, template_f: np.ndarray,
                        smpl_v: np.ndarray, smpl_f: np.ndarray,
                        smpl_lbs: np.ndarray, res: int = RES,
                        n_surface: int = 100_000, device="cuda") -> dict:
    """The npz's arrays."""
    from animatablegaussians_torch.ops.geometry3d import calc_blending_weight

    dev = torch.device(device)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    mn = template_v.min(0) - 0.1
    mx = template_v.max(0) + 0.1
    bounds = np.stack([mn, mx]).astype(np.float32)
    grid = t(make_grid(bounds, res))
    sv, sf, sl = t(smpl_v), t(smpl_f, torch.int64), t(smpl_lbs)

    surf_pts, _ = sample_surface(template_v, template_f, n_surface)
    surf_pts = t(surf_pts)
    with torch.no_grad():
        surf_w, _ = calc_blending_weight(surf_pts, sv, sf, sl,
                                         method="barycentric")
    diff = knn_scatter_weights(grid, surf_pts, surf_w)
    diff = jacobi_smooth(diff.reshape(res, res, res, -1), iters=10)
    diff = diff / torch.clamp(diff.sum(-1, keepdim=True), min=1e-8)
    with torch.no_grad():
        ori, _ = calc_blending_weight(grid, sv, sf, sl, method="barycentric")
    sdf = signed_distance(grid, template_v, template_f)

    def out(x, *shape):
        return x.reshape(*shape).cpu().numpy().astype(np.float32)

    return dict(diff_weight_volume=out(diff, res, res, res, -1),
                ori_weight_volume=out(ori, res, res, res, -1),
                sdf_volume=out(sdf, res, res, res),
                volume_bounds=bounds,
                center=(0.5 * (mn + mx)).astype(np.float32),
                smpl_bounds=np.stack([smpl_v.min(0),
                                      smpl_v.max(0)]).astype(np.float32))


def main(argv=None, device="cuda") -> str:
    """Run the tool on ``argv`` (default: the command line) on ``device``
    (``--device`` overrides it); returns the npz's path."""
    from argparse import ArgumentParser
    from animatablegaussians_torch.config import load_config
    from animatablegaussians_torch.data import get_dataset_class
    from animatablegaussians_torch.tools.gen_pos_maps import _template_mesh
    from animatablegaussians_torch.utils.device import resolve

    ap = ArgumentParser()
    ap.add_argument("-c", "--config_path", required=True)
    ap.add_argument("--res", type=int, default=RES)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve(args.device or device)
    opt = load_config(args.config_path).to_dict()
    ds_cls = get_dataset_class(opt["train"].get(
        "dataset", "MvRgbDatasetAvatarReX"))
    dataset = ds_cls(**opt["train"]["data"])
    mesh = _template_mesh(dataset.data_dir)
    smpl_f = np.asarray(dataset.smpl_model.faces, np.int64)
    tv, tf = mesh if mesh is not None else (dataset.cano_smpl["vertices"],
                                            smpl_f)
    data = build_weight_volume(
        tv, tf, dataset.cano_smpl["vertices"], smpl_f,
        dataset.smpl_model.data.lbs_weights.cpu().numpy(), res=args.res,
        device=dev)
    path = os.path.join(dataset.data_dir, "cano_weight_volume.npz")
    np.savez(path, **data)
    print(f"# Wrote {path}")
    return path


if __name__ == "__main__":
    main()
