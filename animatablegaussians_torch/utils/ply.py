"""Minimal binary-little-endian and ASCII PLY I/O (no plyfile
dependency), a numpy copy of ``animatablegaussians_tpu/utils/ply.py``.

Vertex elements with float/uchar/int properties and an optional face
element with ``vertex_indices`` lists: enough for 3DGS Gaussian PLYs (ref:
gaussians/obj_io.py:24-99) and template meshes.
"""

from __future__ import annotations

import io
from typing import Dict, Optional, Tuple

import numpy as np

_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1",
    "short": "<i2", "ushort": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
}
_NAMES = {"<f4": "float", "<f8": "double", "u1": "uchar", "i1": "char",
          "<i2": "short", "<u2": "ushort", "<i4": "int", "<u4": "uint"}


def write_ply(path: str, vertex_props: Dict[str, np.ndarray],
              faces: Optional[np.ndarray] = None) -> None:
    """vertex_props: name -> (N,) arrays (order preserved)."""
    names = list(vertex_props)
    n = len(vertex_props[names[0]])
    lines = ["ply", "format binary_little_endian 1.0",
             f"element vertex {n}"]
    cols = []
    for name in names:
        arr = np.asarray(vertex_props[name])
        dt = np.dtype(arr.dtype).newbyteorder("<") if arr.dtype != np.uint8 \
            else np.dtype("u1")
        if dt.str not in _NAMES:
            arr = arr.astype(np.float32)
            dt = np.dtype("<f4")
        lines.append(f"property {_NAMES[dt.str]} {name}")
        cols.append(arr.astype(dt))
    if faces is not None:
        lines.append(f"element face {len(faces)}")
        lines.append("property list uchar int vertex_indices")
    lines.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        rec = np.rec.fromarrays(cols, names=names)
        f.write(rec.tobytes())
        if faces is not None:
            faces = np.asarray(faces, dtype="<i4")
            counts = np.full((len(faces), 1), faces.shape[1], dtype="u1")
            buf = io.BytesIO()
            for i in range(len(faces)):
                buf.write(counts[i].tobytes())
                buf.write(faces[i].tobytes())
            f.write(buf.getvalue())


def read_ply(path: str) -> Tuple[Dict[str, np.ndarray], Optional[np.ndarray]]:
    """Returns (vertex property dict, faces or None)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii").splitlines()
    body = data[header_end:]

    fmt = next(l for l in header if l.startswith("format")).split()[1]
    elements = []  # (name, count, [(prop_name, dtype_str) or ("__list__",...)])
    cur = None
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "element":
            cur = {"name": parts[1], "count": int(parts[2]), "props": []}
            elements.append(cur)
        elif parts[0] == "property" and cur is not None:
            if parts[1] == "list":
                cur["props"].append(("__list__", parts[2], parts[3], parts[4]))
            else:
                cur["props"].append((parts[2], _DTYPES[parts[1]]))

    if fmt == "ascii":
        return _read_ascii(header, body, elements)

    off = 0
    verts: Dict[str, np.ndarray] = {}
    faces = None
    for el in elements:
        if el["props"] and el["props"][0][0] == "__list__":
            _, cnt_t, idx_t, _ = el["props"][0]
            cnt_dt = np.dtype(_DTYPES[cnt_t])
            idx_dt = np.dtype(_DTYPES[idx_t])
            out = []
            for _ in range(el["count"]):
                c = int(np.frombuffer(body, cnt_dt, 1, off)[0])
                off += cnt_dt.itemsize
                out.append(np.frombuffer(body, idx_dt, c, off))
                off += c * idx_dt.itemsize
            faces = np.asarray(out)
        else:
            dt = np.dtype([(n, t) for n, t in el["props"]])
            rec = np.frombuffer(body, dt, el["count"], off)
            off += dt.itemsize * el["count"]
            if el["name"] == "vertex":
                for n, _ in el["props"]:
                    verts[n] = np.ascontiguousarray(rec[n])
            elif el["name"] == "face":
                pass
    return verts, faces


def _read_ascii(header, body, elements):
    rows = body.decode("ascii").split("\n")
    ri = 0
    verts, faces = {}, None
    for el in elements:
        if el["props"] and el["props"][0][0] == "__list__":
            out = []
            for _ in range(el["count"]):
                vals = rows[ri].split(); ri += 1
                c = int(vals[0])
                out.append([int(v) for v in vals[1:1 + c]])
            faces = np.asarray(out)
        else:
            names = [n for n, _ in el["props"]]
            arr = np.array([rows[ri + i].split() for i in range(el["count"])],
                           dtype=np.float64)
            ri += el["count"]
            if el["name"] == "vertex":
                for j, n in enumerate(names):
                    verts[n] = arr[:, j].astype(np.float32)
    return verts, faces
