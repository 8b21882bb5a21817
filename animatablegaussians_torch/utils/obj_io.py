"""OBJ / PLY mesh I/O (ref: utils/obj_io.py): a numpy copy of
``animatablegaussians_tpu/utils/obj_io.py``.

Minimal, dependency-free readers/writers for the mesh formats the pipeline
touches: OBJ (v/vn/f with 1-based, possibly slashed indices) and PLY
through the port's ``utils/ply.py``."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from animatablegaussians_torch.utils.ply import read_ply, write_ply


def load_obj(path: str) -> dict:
    """Returns dict(vertices (V,3), faces (F,3) int, normals (V,3) or None,
    uvs or None)."""
    verts, normals, uvs, faces = [], [], [], []
    with open(path) as fp:
        for line in fp:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vn "):
                normals.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                uvs.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1
                       for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return dict(
        vertices=np.asarray(verts, np.float32),
        faces=np.asarray(faces, np.int64) if faces else None,
        normals=np.asarray(normals, np.float32) if normals else None,
        uvs=np.asarray(uvs, np.float32) if uvs else None)


def save_obj(path: str, vertices: np.ndarray,
             faces: Optional[np.ndarray] = None,
             normals: Optional[np.ndarray] = None) -> None:
    with open(path, "w") as fp:
        for v in np.asarray(vertices):
            fp.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if normals is not None:
            for n in np.asarray(normals):
                fp.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        if faces is not None:
            for f in np.asarray(faces) + 1:
                fp.write(f"f {f[0]} {f[1]} {f[2]}\n")


def load_mesh(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Vertices + faces from .obj or .ply."""
    if path.endswith(".obj"):
        m = load_obj(path)
        return m["vertices"], m["faces"]
    props, faces = read_ply(path)
    verts = np.stack([props["x"], props["y"], props["z"]], -1).astype(
        np.float32)
    return verts, faces


def save_mesh_as_ply(path: str, vertices, faces=None, normals=None,
                     colors=None) -> None:
    """(ref: utils/obj_io.py save_mesh_as_ply)."""
    vertices = np.asarray(vertices)
    props = dict(x=vertices[:, 0], y=vertices[:, 1], z=vertices[:, 2])
    if normals is not None:
        normals = np.asarray(normals)
        props.update(nx=normals[:, 0], ny=normals[:, 1], nz=normals[:, 2])
    if colors is not None:
        colors = (np.clip(np.asarray(colors), 0, 1) * 255).astype(np.uint8)
        props.update(red=colors[:, 0], green=colors[:, 1],
                     blue=colors[:, 2])
    write_ply(path, props,
              faces=None if faces is None else np.asarray(faces, np.int32))
