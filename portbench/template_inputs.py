"""The template cell's inputs, made from the seed: a human-sized closed
body at SMPL-X's counts with its 55 joints' LBS weights, two closed hands
at MANO's vertex count, frame 0's pose, the ``diff`` weight volume, the
ring of cameras, and the template network's initial weights.

No subject's capture, SMPL-X or MANO archive is in the repository; each
input stands in for one (``portbench/configs/avatarrex_zzr_template.json``
lists them under ``assumed``):

* the body is ten closed ellipsoids in the T-pose (head, torso, upper
  arms, forearms with the hands, thighs, shins with the feet), 1.7 m tall
  at the seed's scale, with 20,908 faces and 10,475 vertices as SMPL-X has:
  a closed surface of F faces has F / 2 + 2 vertices a component, so ten
  components use 10,474 and one vertex sits unreferenced inside the
  pelvis (SMPL-X's own mesh is open at the eyes and the mouth);
* its LBS weights fall off with the distance to SMPL-X's 55 joints
  (a softmax of -d^2 / (2 sigma^2)), and the weight volume holds the same
  function on its grid, in place of ``gen_weight_volume``'s diffusion;
* each hand is one closed ellipsoid of 778 vertices and 1,552 faces
  (MANO's vertex count, closed: 2 V - 4 faces) at the end of its forearm,
  the left one the right one mirrored, so that its face list is the
  right hand's and turns inward, as MANO's closed list does on SMPL-X's
  left hand;
* the pose turns each joint about the view axis by 0.1 N(0, 1) rad about
  its own centre, down SMPL-X's kinematic tree.

Geometry is made in numpy float64 from a ``numpy.random.Generator`` of the
seed, so a seed gives the same body on every device; the weight volume
and the network's weights are made on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import inputs
from .inputs import seed_of

# SMPL-X's kinematic tree: the parent of each of its 55 joints
PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
           18, 19, 15, 15, 15, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34,
           35, 20, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50,
           21, 52, 53)
# the joints' T-pose centres (metres, y up, the subject's left at +x):
# pelvis, hips, spine, knees, ankles, feet, neck, collars, head,
# shoulders, elbows, wrists, jaw, eyes; then each hand's five fingers of
# three joints
_BODY_JOINTS = (
    (0, 0, 0), (0.09, -0.08, 0), (-0.09, -0.08, 0), (0, 0.1, 0),
    (0.1, -0.48, 0), (-0.1, -0.48, 0), (0, 0.22, 0), (0.1, -0.88, 0),
    (-0.1, -0.88, 0), (0, 0.34, 0), (0.1, -0.93, 0.1), (-0.1, -0.93, 0.1),
    (0, 0.5, 0), (0.07, 0.44, 0), (-0.07, 0.44, 0), (0, 0.62, 0),
    (0.18, 0.45, 0), (-0.18, 0.45, 0), (0.45, 0.45, 0), (-0.45, 0.45, 0),
    (0.7, 0.45, 0), (-0.7, 0.45, 0), (0, 0.6, 0.05), (0.03, 0.67, 0.08),
    (-0.03, 0.67, 0.08))


def _finger_joints(sign: float):
    return [(sign * (0.76 + 0.03 * k), 0.45, -0.04 + 0.02 * f)
            for f in range(5) for k in range(3)]


JOINTS = np.array(list(_BODY_JOINTS) + _finger_joints(1.0)
                  + _finger_joints(-1.0), np.float64)
HEIGHT = 1.72          # the joints' body, feet to the top of the head
# (centre, radii, long axis, longitude segments, latitude rings + 1)
PARTS = (
    ((0, 0.17, 0), (0.17, 0.33, 0.11), "y", 60, 37),        # torso
    ((0, 0.63, 0.01), (0.09, 0.12, 0.1), "y", 48, 25),      # head
    ((0.31, 0.45, 0), (0.16, 0.05, 0.05), "x", 32, 25),     # upper arms
    ((-0.31, 0.45, 0), (0.16, 0.05, 0.05), "x", 32, 25),
    ((0.62, 0.45, 0), (0.22, 0.04, 0.045), "x", 32, 33),    # forearms
    ((-0.62, 0.45, 0), (0.22, 0.04, 0.045), "x", 32, 33),
    ((0.1, -0.3, 0), (0.08, 0.25, 0.08), "y", 36, 25),      # thighs
    ((-0.1, -0.3, 0), (0.08, 0.25, 0.08), "y", 36, 25),
    ((0.1, -0.72, 0.02), (0.06, 0.27, 0.07), "y", 32, 25),  # shins
    ((-0.1, -0.72, 0.02), (0.06, 0.27, 0.07), "y", 32, 25),
)
HAND = ((0.8, 0.45, 0.0), (0.095, 0.025, 0.05), "x", 24, 33)


def ellipsoid(centre, radii, axis: str, n_lon: int, n_lat: int):
    """A closed UV ellipsoid: (verts (n_lon (n_lat - 1) + 2, 3), faces
    (2 n_lon (n_lat - 1), 3)), every face wound outward."""
    th = np.pi * np.arange(1, n_lat) / n_lat
    ph = 2 * np.pi * np.arange(n_lon) / n_lon
    ring = np.stack([np.sin(th)[:, None] * np.cos(ph)[None],
                     np.cos(th)[:, None] * np.ones_like(ph)[None],
                     np.sin(th)[:, None] * np.sin(ph)[None]], -1)
    unit = np.concatenate([[[0, 1, 0]], ring.reshape(-1, 3), [[0, -1, 0]]])
    if axis == "x":                       # the long axis along x: a turn
        unit = np.stack([unit[:, 1], -unit[:, 0], unit[:, 2]], -1)
    verts = unit * np.asarray(radii) + np.asarray(centre)
    faces = []
    last = len(unit) - 1

    def at(i, j):
        return 1 + i * n_lon + j % n_lon
    for j in range(n_lon):
        faces.append((0, at(0, j), at(0, j + 1)))
        faces.append((last, at(n_lat - 2, j + 1), at(n_lat - 2, j)))
        for i in range(n_lat - 2):
            faces.append((at(i, j), at(i + 1, j), at(i + 1, j + 1)))
            faces.append((at(i, j), at(i + 1, j + 1), at(i, j + 1)))
    faces = np.array(faces, np.int64)
    return verts, _outward(verts, faces, np.asarray(centre, np.float64))


def _outward(verts, faces, centre):
    """``faces`` wound so that each normal points away from ``centre``
    (an ellipsoid is star-shaped about it)."""
    a, b, c = (verts[faces[:, k]] for k in range(3))
    n = np.cross(b - a, c - a)
    inward = np.sum(n * ((a + b + c) / 3 - centre), -1) < 0
    faces = faces.copy()
    faces[inward] = faces[inward][:, ::-1]
    return faces


def split_faces(verts, faces, n: int, among: int):
    """Adds ``n`` vertices, each at the centroid of one of the first
    ``among`` faces (spread evenly over them), whose face it splits in
    three: a closed surface stays closed, with 2 n more faces."""
    pick = np.linspace(0, among - 1, n).round().astype(np.int64)
    if len(np.unique(pick)) != n:
        raise ValueError("more splits than faces to split")
    base = len(verts)
    tri = faces[pick]
    mids = verts[tri].mean(1)
    ids = base + np.arange(n)
    faces = faces.copy()
    faces[pick] = np.stack([tri[:, 0], tri[:, 1], ids], -1)
    extra = np.concatenate([np.stack([tri[:, 1], tri[:, 2], ids], -1),
                            np.stack([tri[:, 2], tri[:, 0], ids], -1)])
    return np.concatenate([verts, mids]), np.concatenate([faces, extra])


def fit(parts, n_faces: int):
    """``parts`` with each part's segments and rings cut in proportion
    where together they would make more than ``n_faces`` faces (smaller
    meshes for tests); as they are otherwise."""
    nominal = sum(2 * n_lon * (n_lat - 1) for *_, n_lon, n_lat in parts)
    if nominal <= n_faces:
        return parts
    r = 0.9 * math.sqrt(n_faces / nominal)
    return [(c, rad, ax, max(4, int(n_lon * r)), max(3, int(n_lat * r)))
            for c, rad, ax, n_lon, n_lat in parts]


def closed_mesh(parts, n_verts: int, n_faces: int):
    """The parts' ellipsoids as one mesh of exactly ``n_verts`` vertices
    and ``n_faces`` faces: faces spread over the mesh split to reach the
    face count, the vertices left over placed at the first part's centre,
    referenced by no face."""
    parts = fit(parts, n_faces)
    vs, fs, at = [], [], 0
    for centre, radii, axis, n_lon, n_lat in parts:
        v, f = ellipsoid(centre, radii, axis, n_lon, n_lat)
        vs.append(v)
        fs.append(f + at)
        at += len(v)
    verts, faces = np.concatenate(vs), np.concatenate(fs)
    more = n_faces - len(faces)
    if more < 0 or more % 2:
        raise ValueError(f"the parts make {len(faces)} faces, not a count "
                         f"an even number below {n_faces}")
    verts, faces = split_faces(verts, faces, more // 2, len(faces))
    spare = n_verts - len(verts)
    if spare < 0:
        raise ValueError(f"the parts use {len(verts)} vertices, more than "
                         f"{n_verts}")
    verts = np.concatenate([verts, np.tile(np.asarray(parts[0][0],
                                                      np.float64),
                                           (spare, 1))])
    return verts, faces


def vertex_normals(verts, faces):
    """Area-weighted unit vertex normals of a mesh."""
    a, b, c = (verts[faces[:, k]] for k in range(3))
    fn = np.cross(b - a, c - a)
    n = np.zeros_like(verts)
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)


def lbs_weights(points, joints, sigma: float):
    """(N, J) weights: a softmax over the joints of -d^2 / (2 sigma^2)."""
    d2 = np.sum((points[:, None] - joints[None]) ** 2, -1)
    z = -d2 / (2 * sigma ** 2)
    z -= z.max(1, keepdims=True)
    w = np.exp(z)
    return w / w.sum(1, keepdims=True)


def pose_mats(joints, angles):
    """(J, 4, 4) canonical -> live joint matrices: joint j turned by
    ``angles[j]`` about z through its own centre, after its parents."""
    out = np.zeros((len(joints), 4, 4))
    for j, p in enumerate(PARENTS):
        c, s = math.cos(angles[j]), math.sin(angles[j])
        r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        local = np.eye(4)
        local[:3, :3] = r
        local[:3, 3] = joints[j] - r @ joints[j]
        out[j] = local if p < 0 else out[p] @ local
    return out


def skin(points, weights, mats):
    m = np.einsum("nj,jxy->nxy", weights, mats)
    return np.einsum("nxy,ny->nx", m[:, :3, :3], points) + m[:, :3, 3]


def body(cfg: dict, seed: int) -> dict:
    """The seed's subject in frame 0's pose, as numpy arrays (float32,
    faces int64): the canonical and live body (``cano_v``, ``live_v``,
    ``faces``, ``lbs``), both hands (``{side}_{cano,live}_mano_{v,n}``,
    ``mano_face_closed``), ``joints``, ``cano2live_jnt_mats``,
    ``cano_smpl_center``, ``volume_bounds`` and ``live_bounds``."""
    b = cfg["body"]
    rng = np.random.default_rng(seed_of(seed, 10))
    scale = float(b["height_m"]) / HEIGHT * (1 + 0.03 * rng.uniform(-1, 1))
    parts = [(np.asarray(c) * scale,
              np.asarray(r) * scale * (1 + 0.05 * rng.uniform(-1, 1, 3)),
              ax, n_lon, n_lat) for c, r, ax, n_lon, n_lat in PARTS]
    joints = JOINTS * scale
    cano_v, faces = closed_mesh(parts, int(b["n_verts"]),
                                int(b["n_faces"]))
    sigma = float(b["lbs_sigma"]) * scale
    lbs = lbs_weights(cano_v, joints, sigma)
    angles = float(b["pose_angle"]) * rng.standard_normal(len(joints))
    mats = pose_mats(joints, angles)
    live_v = skin(cano_v, lbs, mats)

    n_mano = int(b["mano_verts"])
    (hc, hr, hax, h_lon, h_lat), = fit([HAND], 2 * n_mano - 4)
    rv, rf = ellipsoid(np.asarray(hc) * scale * np.array([-1, 1, 1]),
                       np.asarray(hr) * scale, hax, h_lon, h_lat)
    n_split = n_mano - len(rv)
    rv, rf = split_faces(rv, rf, n_split, len(rf))
    if len(rf) != int(b["mano_faces"]):
        raise ValueError(f"the hand has {len(rf)} faces")
    lv = rv * np.array([-1.0, 1.0, 1.0])       # mirrored: rf turns inward
    out = dict(cano_v=cano_v, live_v=live_v, faces=faces, lbs=lbs,
               joints=joints, cano2live_jnt_mats=mats, mano_face_closed=rf,
               cano_smpl_center=0.5 * (cano_v.min(0) + cano_v.max(0)))
    for side, hv, hf in (("left", lv, rf[:, ::-1]), ("right", rv, rf)):
        live = skin(hv, lbs_weights(hv, joints, sigma), mats)
        out[f"{side}_cano_mano_v"] = hv
        out[f"{side}_cano_mano_n"] = vertex_normals(hv, hf)
        out[f"{side}_live_mano_v"] = live
        out[f"{side}_live_mano_n"] = vertex_normals(live, hf)
    pad, lpad = float(b["volume_pad"]), float(b["live_bounds_pad"])
    out["volume_bounds"] = np.stack([cano_v.min(0) - pad,
                                     cano_v.max(0) + pad])
    out["live_bounds"] = np.stack([live_v.min(0) - lpad,
                                   live_v.max(0) + lpad])
    out = {k: v.astype(np.int64 if v.dtype.kind in "iu" else np.float32)
           for k, v in out.items()}
    out["sigma"] = sigma
    return out


def weight_volume(subject: dict, res: int, device,
                  chunk: int = 1 << 18) -> torch.Tensor:
    """(res, res, res, J) LBS weights on the grid over the subject's
    ``volume_bounds`` (voxel 0 and res - 1 on the bounds), the function
    of the body's weights, made on ``device``."""
    lo, hi = (torch.as_tensor(subject["volume_bounds"][k], device=device)
              for k in (0, 1))
    t = torch.linspace(0.0, 1.0, res, device=device)
    g = torch.stack(torch.meshgrid(t, t, t, indexing="ij"), -1).reshape(
        -1, 3) * (hi - lo) + lo
    joints = torch.as_tensor(subject["joints"], device=device)
    inv = -0.5 / subject["sigma"] ** 2
    out = torch.empty((g.shape[0], joints.shape[0]), device=device)
    for s in range(0, g.shape[0], chunk):
        d2 = torch.sum((g[s:s + chunk, None] - joints[None]) ** 2, -1)
        out[s:s + chunk] = torch.softmax(d2 * inv, dim=1)
    return out.reshape(res, res, res, -1)


def ring_cameras(cfg: dict):
    """-> (extr (n, 4, 4), intr (3, 3)) of the configuration's used
    cameras: ``camera.count`` on a ring about the body's vertical axis,
    those of ``train.used_cam_ids``."""
    cam = cfg["camera"]
    extr, intr = inputs.ring_cameras(
        int(cam["count"]), int(cam["img_w"]), int(cam["img_h"]),
        float(cam["train_dist"]), float(cam["train_focal"]))
    return extr[list(cfg["train"]["used_cam_ids"])], intr


# -- the network's initial weights --------------------------------------------

SDF_HIDDEN = (512, 256, 256, 256, 256, 256)
SDF_SKIP = (4,)
TEX_HIDDEN = (256, 256, 256)
HAND_HIDDEN = (64, 64, 64, 64, 64)
SDF_BIAS = 0.7
BETA_INIT = 0.01


def embed_dim(multires: int) -> int:
    return 3 * (1 + 2 * multires)


def layer_dims(n_in: int, hidden, n_out: int, skip=()):
    chans = [n_in] + list(hidden) + [n_out]
    return [(chans[l] + (n_in if l in skip else 0), chans[l + 1])
            for l in range(len(chans) - 1)]


def network_layers(cfg: dict) -> dict:
    """Each MLP's (in, out) layer widths: ``geo_mlp`` (the SDF, 256
    features and the SDF), ``tex_mlp`` and each hand's ``tex_mlp``."""
    m = cfg["model"]
    pos = embed_dim(int(m.get("multires", 6)))
    view = embed_dim(int(m["multires_viewdir"])) if m.get("use_viewdir") \
        else 0
    hand = embed_dim(4) + 1 + 15 * 4
    return {"geo_mlp": layer_dims(pos, SDF_HIDDEN, 257, SDF_SKIP),
            "tex_mlp": layer_dims(256 + view, TEX_HIDDEN, 3),
            "left_hand.tex_mlp": layer_dims(hand, HAND_HIDDEN, 3),
            "right_hand.tex_mlp": layer_dims(hand, HAND_HIDDEN, 3)}


def network_weights(cfg: dict, seed: int, device) -> dict:
    """The template network's initial weights from the seed, named as the
    program's ``TemplateNet`` names them ((out, in) weights): the SDF
    MLP's geometric initialisation (a sphere of radius 0.7; layer 0 reads
    only xyz, the skip layer not the embedding) with weight norm's ``g``
    at each row's norm, the other MLPs' uniform +-1/sqrt(in), and the
    Laplace density's beta 0.01 (network/mlp.py, network/density.py).
    One normal and one uniform draw on the device, split in order."""
    layers = network_layers(cfg)
    g = torch.Generator(device=device).manual_seed(seed_of(seed, 12))
    n_norm = sum(i * o for i, o in layers["geo_mlp"])
    n_unif = sum(i * o + o for k, dims in layers.items() if k != "geo_mlp"
                 for i, o in dims)
    normal = torch.randn(n_norm, generator=g, device=device)
    unif = 2 * torch.rand(n_unif, generator=g, device=device) - 1
    out, at = {}, 0
    geo = layers["geo_mlp"]
    n_pos = geo[0][0]
    for l, (i, o) in enumerate(geo):
        z = normal[at:at + i * o].view(o, i)
        at += i * o
        if l == len(geo) - 1:
            w = math.sqrt(math.pi) / math.sqrt(i) + 1e-4 * z
            b = torch.full((o,), -SDF_BIAS, device=device)
        else:
            w = z * (math.sqrt(2) / math.sqrt(o))
            if l == 0:
                w = torch.cat([w[:, :3], torch.zeros_like(w[:, 3:])], 1)
            elif l in SDF_SKIP:
                w = torch.cat([w[:, :i - (n_pos - 3)],
                               torch.zeros_like(w[:, i - (n_pos - 3):])], 1)
            b = torch.zeros((o,), device=device)
        out[f"geo_mlp.layers.{l}.weight"] = w
        out[f"geo_mlp.layers.{l}.bias"] = b
        out[f"geo_mlp.layers.{l}.g"] = torch.sqrt(torch.sum(w * w, 1)
                                                  + 1e-12)
    at = 0
    for key, dims in layers.items():
        if key == "geo_mlp":
            continue
        for l, (i, o) in enumerate(dims):
            lim = 1.0 / math.sqrt(i)
            out[f"{key}.layers.{l}.weight"] = unif[at:at + i * o].view(
                o, i) * lim
            at += i * o
            out[f"{key}.layers.{l}.bias"] = unif[at:at + o] * lim
            at += o
    out["density.beta"] = torch.tensor(BETA_INIT, device=device)
    return out
