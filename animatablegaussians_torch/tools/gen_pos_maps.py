"""Bake the canonical position / normal maps and the per-frame pose maps
that the avatar CLI reads. A port of
``animatablegaussians_tpu/tools/gen_pos_maps.py`` (ref:
gen_data/gen_pos_maps.py:45-162):

  * orthographic front / back renders of the template mesh
    (``template.ply`` when it exists, else the canonical SMPL-X; the back
    view flipped) at ``map_size``^2 through the software rasterizer
    (``utils/mesh_renderer.py``): ``smpl_pos_map/cano_smpl_pos_map.exr``
    and ``cano_smpl_nml_map.exr``, (S, 2S, 3) each;
  * the texels' LBS weights, from the weight volume when the template and
    ``cano_weight_volume.npz`` exist, else barycentric from the nearest
    SMPL-X face: ``init_pts_lbs.npy``;
  * per frame, the texels skinned without the root and downsampled to half
    resolution: ``smpl_pos_map/%08d.exr``.

The LBS queries and the skinning run on ``device``.

    python -m animatablegaussians_torch.tools.gen_pos_maps -c <config.yaml>
        [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np
import torch

MAP_SIZE = 1024


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (the sum of the incident faces' cross
    products, normalised)."""
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    return vn / np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)


def bake_cano_maps(verts: np.ndarray, faces: np.ndarray,
                   map_size: int = MAP_SIZE):
    """Front / back orthographic position and normal maps, (S, 2S, 3)
    each (ref: gen_pos_maps.py:92-124)."""
    from animatablegaussians_torch.utils.mesh_renderer import Renderer
    from animatablegaussians_torch.utils.visualize import (
        calc_cano_back_mv, calc_cano_front_mv)

    center = 0.5 * (verts.min(0) + verts.max(0))
    dup_v = verts[faces.reshape(-1)].astype(np.float32)
    dup_n = vertex_normals(verts, faces)[faces.reshape(-1)].astype(
        np.float32)
    r = Renderer(map_size, map_size, shader_name="vertex_attribute")
    maps = {}
    for attr_name, attr in (("pos", dup_v), ("nml", dup_n)):
        r.set_model(dup_v, attr)
        r.set_camera(calc_cano_front_mv(center))
        front = r.render()[:, :, :3]
        r.set_camera(calc_cano_back_mv(center))
        back = r.render()[:, ::-1, :3]                  # cv2.flip(img, 1)
        maps[attr_name] = np.concatenate([front, back], axis=1)
    return maps["pos"], maps["nml"]


def interpolate_lbs(query_pts: np.ndarray, smpl_v: np.ndarray,
                    smpl_f: np.ndarray, smpl_lbs: np.ndarray,
                    device="cuda") -> np.ndarray:
    """Barycentric LBS weights from the nearest SMPL face (ref:
    gen_data/gen_pos_maps.py:24-39)."""
    from animatablegaussians_torch.ops.geometry3d import calc_blending_weight

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    w, _ = calc_blending_weight(t(query_pts), t(smpl_v),
                                t(smpl_f, torch.int64), t(smpl_lbs),
                                method="barycentric")
    return w.cpu().numpy()


def _template_mesh(data_dir: str):
    """(verts, faces) of ``template.ply`` in ``data_dir``, else None."""
    path = os.path.join(data_dir, "template.ply")
    if not os.path.exists(path):
        return None
    from animatablegaussians_torch.utils.ply import read_ply
    props, tfaces = read_ply(path)
    tv = np.stack([props["x"], props["y"], props["z"]], -1).astype(
        np.float32)
    return tv, np.asarray(tfaces, np.int64)


def generate(data_dir: str, dataset, smpl_model, map_size: int = MAP_SIZE,
             device="cuda") -> str:
    """The whole bake over a built dataset (it holds the batched SMPL-X
    results); returns the output directory."""
    from animatablegaussians_torch.utils import exr

    dev = torch.device(device)
    out_dir = os.path.join(data_dir, "smpl_pos_map")
    os.makedirs(out_dir, exist_ok=True)
    mesh = _template_mesh(data_dir)
    if mesh is None:
        cano_v = dataset.cano_smpl["vertices"]
        faces = np.asarray(smpl_model.faces, np.int64)
    else:
        cano_v, faces = mesh

    pos_map, nml_map = bake_cano_maps(cano_v, faces, map_size)
    exr.write_exr(os.path.join(out_dir, "cano_smpl_pos_map.exr"), pos_map)
    exr.write_exr(os.path.join(out_dir, "cano_smpl_nml_map.exr"), nml_map)
    mask = np.linalg.norm(pos_map, axis=-1) > 0.0
    cano_pts = pos_map[mask]

    vol_path = os.path.join(data_dir, "cano_weight_volume.npz")
    if mesh is not None and os.path.exists(vol_path):
        from animatablegaussians_torch.models.volume import \
            CanoBlendWeightVolume
        vol = CanoBlendWeightVolume(vol_path, device=dev)
        with torch.no_grad():
            pts_lbs = vol.forward_weight(
                torch.as_tensor(cano_pts, device=dev)).cpu().numpy()
    else:
        pts_lbs = interpolate_lbs(
            cano_pts, dataset.cano_smpl["vertices"],
            np.asarray(smpl_model.faces, np.int64),
            smpl_model.data.lbs_weights.cpu().numpy(), device=dev)
    np.save(os.path.join(out_dir, "init_pts_lbs.npy"), pts_lbs)

    # per-frame skinning without the root -> half-resolution pose maps
    # (ref: gen_pos_maps.py:141-162); the dataset holds the matrices
    lbs = torch.as_tensor(pts_lbs, device=dev)
    pts = torch.as_tensor(cano_pts, device=dev)
    for i, pose_idx in enumerate(dataset.pose_list):
        mats = torch.as_tensor(dataset.cano2live_jnt_mats_woRoot[i],
                               device=dev)
        with torch.no_grad():
            pt_mats = torch.einsum("nj,jxy->nxy", lbs, mats)
            live = (torch.einsum("nxy,ny->nx", pt_mats[:, :3, :3], pts)
                    + pt_mats[:, :3, 3])
        live_map = np.zeros((map_size, 2 * map_size, 3), np.float32)
        live_map[mask] = live.cpu().numpy()
        exr.write_exr(os.path.join(out_dir, "%08d.exr" % pose_idx),
                      live_map[::2, ::2])               # nearest x0.5
    return out_dir


def main(argv=None, device="cuda") -> str:
    """Run the tool on ``argv`` (default: the command line) on ``device``
    (``--device`` overrides it); returns the output directory."""
    from argparse import ArgumentParser
    from animatablegaussians_torch.config import load_config
    from animatablegaussians_torch.data import get_dataset_class
    from animatablegaussians_torch.utils.device import resolve

    ap = ArgumentParser()
    ap.add_argument("-c", "--config_path", required=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve(args.device or device)
    opt = load_config(args.config_path).to_dict()
    ds_cls = get_dataset_class(opt["train"].get(
        "dataset", "MvRgbDatasetAvatarReX"))
    data_kw = dict(opt["train"]["data"])
    data_kw["load_smpl_pos_map"] = False
    dataset = ds_cls(**data_kw)
    out = generate(dataset.data_dir, dataset, dataset.smpl_model,
                   device=dev)
    print(f"# Wrote {out}")
    return out


if __name__ == "__main__":
    main()
