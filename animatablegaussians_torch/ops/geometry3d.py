"""Point/mesh geometry: the nearest face with barycentric weights, the
SMPL-sphere near/far bounds, LBS blending-weight queries and forward
skinning. A port of ``animatablegaussians_tpu/ops/geometry3d.py``, which
replaces the reference's CUDA ``posevocab_custom_ops`` (ref:
utils/posevocab_custom_ops/nearest_face.py:18-61, near_far_smpl.py:18-27)
and ``utils/smpl_util.py:10-84``.

Each query is a dense (chunk x faces) or (chunk x vertices) computation in
plain PyTorch, chunked over the queries, except the nearest face on a GPU:
``nearest_face`` runs ``nearest_face_plain`` for tensors on the CPU and
the CUDA kernel ``csrc/nearest_face.cu`` for tensors on a CUDA device,
with the same bits; it never falls back from one to the other.
``nearest_face`` and ``near_far_smpl`` run under ``torch.no_grad()``:
their callers feed them data, never a parameter (the JAX model stops the
gradient at their input), and autograd would otherwise keep every chunk's
(chunk, F) intermediates. ``argmin`` / ``argmax`` ties go to the first
index, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch

from animatablegaussians_torch.utils.profiling import count, span


def _closest_vw(p, a, b, c):
    """Barycentric (v, w) of the closest point of triangle (a, b, c) to p,
    and the edges ab, ac (Ericson, Real-Time Collision Detection §5.1.5,
    branch-free). The regions are tested in the JAX package's order, first
    true wins: vertex A, B, C, edge AB, AC, BC, else the interior."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = torch.sum(ab * ap, -1)
    d2 = torch.sum(ac * ap, -1)
    bp = p - b
    d3 = torch.sum(ab * bp, -1)
    d4 = torch.sum(ac * bp, -1)
    del bp
    cp = p - c
    d5 = torch.sum(ab * cp, -1)
    d6 = torch.sum(ac * cp, -1)
    del cp, ap

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    eps = 1e-12
    denom = torch.clamp(va + vb + vc, min=eps)
    v = vb / denom                                       # interior
    w = vc / denom
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    one = torch.ones((), dtype=v.dtype, device=v.device)

    # apply the regions last to first, so that the first true one wins
    r_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    w_bc = (d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6), min=eps)
    v = torch.where(r_bc, 1.0 - w_bc, v)
    w = torch.where(r_bc, w_bc, w)
    del r_bc, w_bc
    r_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    w_ac = d2 / torch.clamp(d2 - d6, min=eps)
    v = torch.where(r_ac, zero, v)
    w = torch.where(r_ac, w_ac, w)
    del r_ac, w_ac
    r_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    v_ab = d1 / torch.clamp(d1 - d3, min=eps)
    v = torch.where(r_ab, v_ab, v)
    w = torch.where(r_ab, zero, w)
    del r_ab, v_ab
    r_c = (d6 >= 0) & (d5 <= d6)
    v = torch.where(r_c, zero, v)
    w = torch.where(r_c, one, w)
    r_b = (d3 >= 0) & (d4 <= d3)
    v = torch.where(r_b, one, v)
    w = torch.where(r_b, zero, w)
    r_a = (d1 <= 0) & (d2 <= 0)
    v = torch.where(r_a, zero, v)
    w = torch.where(r_a, zero, w)
    return v, w, ab, ac


def closest_point_triangle(p, a, b, c):
    """Closest point on triangle (a, b, c) to p, all broadcastable
    (..., 3). Returns (closest (..., 3), (u, v, w) (..., 3), the
    barycentric coordinates of the closest point)."""
    v, w, ab, ac = _closest_vw(p, a, b, c)
    u = 1.0 - v - w
    closest = a + v[..., None] * ab + w[..., None] * ac
    return closest, torch.stack([u, v, w], dim=-1)


# (query, face) pairs per chunk of nearest_face when no chunk is given:
# ~30 float32 intermediates of this many elements are alive at once
PAIRS_PER_CHUNK = 2 ** 25


@torch.no_grad()
def nearest_face_plain(points: torch.Tensor, verts: torch.Tensor,
                       faces: torch.Tensor, chunk: Optional[int] = None):
    """``nearest_face`` in plain PyTorch, ``chunk`` query points at a time,
    by default as many as make ``PAIRS_PER_CHUNK`` (query, face) pairs.
    Ties go to the first face, a NaN distance before any other."""
    n_pts, n_faces = points.shape[0], faces.shape[0]
    if chunk is None:
        chunk = max(1, PAIRS_PER_CHUNK // max(1, n_faces))
    tri = verts[faces.long()]                            # (F, 3, 3)
    a, b, c = tri[None, :, 0], tri[None, :, 1], tri[None, :, 2]
    ds, idxs, bcs = [], [], []
    for s in range(0, n_pts, chunk):
        p = points[s:s + chunk, None, :]                 # (n, 1, 3)
        v, w, ab, ac = _closest_vw(p, a, b, c)           # (n, F)
        closest = a + v[..., None] * ab + w[..., None] * ac
        d2 = torch.sum((closest - p) ** 2, -1)
        del closest
        idx = torch.argmin(d2, dim=1, keepdim=True)      # first of ties
        vm = torch.gather(v, 1, idx)[:, 0]
        wm = torch.gather(w, 1, idx)[:, 0]
        ds.append(torch.sqrt(torch.gather(d2, 1, idx)[:, 0]))
        idxs.append(idx[:, 0])
        bcs.append(torch.stack([1.0 - vm - wm, vm, wm], dim=-1))
        del v, w, d2
    return torch.cat(ds), torch.cat(idxs), torch.cat(bcs)


def _nearest_face_kernel(points: torch.Tensor, verts: torch.Tensor,
                         faces: torch.Tensor):
    """``csrc/nearest_face.cu``: three launches on the current stream
    (stage the faces, search every pair, finish), outputs and scratch
    allocated here. A vertex index outside [0, V) stops the kernel with
    a CUDA error, as the plain version's gather does on the card."""
    from animatablegaussians_torch.utils import cuda_build

    n, n_faces = points.shape[0], faces.shape[0]
    if (points.dtype != torch.float32 or verts.dtype != torch.float32
            or points.dim() != 2 or points.shape[1] != 3
            or verts.dim() != 2 or verts.shape[1] != 3
            or faces.dim() != 2 or faces.shape[1] != 3
            or faces.dtype not in (torch.int32, torch.int64)):
        raise ValueError("nearest_face: want points (N, 3) and verts (V, 3) "
                         "float32, faces (F, 3) int32 or int64")
    if not (verts.device == faces.device == points.device):
        raise ValueError("nearest_face: inputs on different devices")
    if n_faces == 0:
        raise ValueError("nearest_face: no faces")
    if max(n, n_faces, verts.shape[0]) >= 2 ** 31:
        raise ValueError("nearest_face: 2^31 or more points, vertices or "
                         "faces")
    points, verts = points.contiguous(), verts.contiguous()
    faces = faces.long()
    dev = points.device
    staged = torch.empty((n_faces, 16), dtype=torch.float32, device=dev)
    keys = torch.empty((n,), dtype=torch.int64, device=dev)
    dist = torch.empty((n,), dtype=torch.float32, device=dev)
    index = torch.empty((n,), dtype=torch.int64, device=dev)
    bary = torch.empty((n, 3), dtype=torch.float32, device=dev)
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.ag_nearest_face(
            points.data_ptr(), n, verts.data_ptr(), verts.shape[0],
            faces.data_ptr(), faces.stride(0), faces.stride(1), n_faces,
            staged.data_ptr(), keys.data_ptr(), dist.data_ptr(),
            index.data_ptr(), bary.data_ptr(), cuda_build.stream_of(points))
    cuda_build.check(err, "nearest_face")
    count("nearest_face.launches")
    return dist, index, bary


@torch.no_grad()
def nearest_face(points: torch.Tensor, verts: torch.Tensor,
                 faces: torch.Tensor, chunk: Optional[int] = None):
    """For each query point: the distance (not squared) to the nearest
    face, its index and the barycentric weights of the closest surface
    point, by brute force over every face (ref: nearest_face.py:30-61):
    ``nearest_face_plain`` on the CPU (``chunk`` points at a time),
    ``csrc/nearest_face.cu`` on a GPU (``chunk`` unused).

    points (N, 3), verts (V, 3), faces (F, 3) int -> ((N,), (N,) int64,
    (N, 3)). One ``nearest_face`` span a call (args ``points``, ``faces``,
    ``pairs``); the counters ``nearest_face.calls`` and
    ``nearest_face.pairs`` add the call and its (point, face) pairs, and
    ``nearest_face.launches`` a call that ran the kernel."""
    n_pts, n_faces = points.shape[0], faces.shape[0]
    count("nearest_face.calls")
    count("nearest_face.pairs", n_pts * n_faces)
    with span("nearest_face") as sp:
        sp.set(points=n_pts, faces=n_faces, pairs=n_pts * n_faces)
        if points.device.type == "cpu":
            return nearest_face_plain(points, verts, faces, chunk)
        if points.device.type != "cuda":
            raise ValueError(f"nearest_face: unsupported device "
                             f"{points.device}")
        return _nearest_face_kernel(points, verts, faces)


def barycentric_interpolate(vert_attrs: torch.Tensor, faces: torch.Tensor,
                            face_ids: torch.Tensor,
                            bary: torch.Tensor) -> torch.Tensor:
    """(V, C) attrs + (N,) face ids + (N, 3) barycentric -> (N, C)
    (ref: utils/geo_util.py:26-36)."""
    tri_attrs = vert_attrs[faces.long()[face_ids]]       # (N, 3, C)
    return torch.sum(tri_attrs * bary[..., None], dim=1)


@torch.no_grad()
def near_far_smpl(verts: torch.Tensor, rays_o: torch.Tensor,
                  rays_d: torch.Tensor, radius: float = 0.1,
                  chunk: int = 2048):
    """Per-ray near/far as the union of the vertices' spheres of radius r
    (ref: near_far_smpl.py:18-27, near_far_smpl_kernel.cu); rays_d
    normalized. Returns (near (R,), far (R,), hit (R,) bool)."""
    nears, fars, hits = [], [], []
    for s in range(0, rays_o.shape[0], chunk):
        oo, dd = rays_o[s:s + chunk], rays_d[s:s + chunk]
        oc = verts[None] - oo[:, None]                   # (n, V, 3)
        b = torch.sum(oc * dd[:, None], -1)
        c = torch.sum(oc * oc, -1) - radius ** 2
        del oc
        disc = b * b - c
        valid = disc > 0
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        inf = torch.full((), float("inf"), device=b.device)
        near = torch.where(valid, b - sq, inf).amin(dim=1)
        far = torch.where(valid, b + sq, -inf).amax(dim=1)
        nears.append(torch.clamp(near, min=0.0))
        fars.append(far)
        hits.append(valid.any(dim=1))
    return torch.cat(nears), torch.cat(fars), torch.cat(hits)


def calc_blending_weight(query_pts: torch.Tensor, smpl_v: torch.Tensor,
                         smpl_f: torch.Tensor, smpl_lbs: torch.Tensor,
                         near_thres: float = 0.08, method: str = "NN"):
    """LBS weights of arbitrary points from the SMPL surface: the nearest
    vertex's ("NN") or the barycentric blend on the nearest face (ref:
    utils/smpl_util.py:10-55). Returns (weights (N, J), near (N,) bool)."""
    if method == "NN":
        d2 = torch.sum((query_pts[:, None] - smpl_v[None]) ** 2, -1)
        idx = torch.argmin(d2, dim=1)
        w = smpl_lbs[idx]
        near = torch.gather(d2, 1, idx[:, None])[:, 0] < near_thres ** 2
    else:
        dist, fidx, bary = nearest_face(query_pts, smpl_v, smpl_f)
        w = barycentric_interpolate(smpl_lbs, smpl_f, fidx, bary)
        near = dist < near_thres
    return w, near


def skinning(points: torch.Tensor, lbs: torch.Tensor,
             jnt_mats: torch.Tensor, return_pt_mats: bool = False):
    """Forward LBS: blend the per-joint affines and apply them (ref:
    utils/smpl_util.py:58-73). points (N, 3), lbs (N, J), mats (J, 4, 4)."""
    pt_mats = torch.einsum("nj,jxy->nxy", lbs, jnt_mats)
    out = (torch.einsum("nxy,ny->nx", pt_mats[:, :3, :3], points)
           + pt_mats[:, :3, 3])
    if return_pt_mats:
        return out, pt_mats
    return out


def skinning_normal(normals: torch.Tensor, lbs: torch.Tensor,
                    jnt_mats: torch.Tensor) -> torch.Tensor:
    """(ref: utils/smpl_util.py:76-81)."""
    pt_mats = torch.einsum("nj,jxy->nxy", lbs, jnt_mats)
    return torch.einsum("nxy,ny->nx", pt_mats[:, :3, :3], normals)
