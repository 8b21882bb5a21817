"""The inputs of every cell, made from the seed: the canonical body, the
network weights, the poses, the cameras and the training images.

The canonical map is a synthetic body (two ellipsoid halves, front and
back, in a (H, 2H) map), as no subject's template is in the repository;
its masked texels are the Gaussians. A pose is a rotation of each joint's
band about the view axis, drawn from the seed, with a root translation
along x; its pose map is the canonical points skinned without the root
and scattered to the half-resolution map. Weights follow the initialisers
of the published network (unit normals under equalized learning rates,
modulation biases at 1, the rest 0) and are drawn on the device in two
calls, one for the normal and one for the uniform draws; the position and
other heads' ToRGB weights are drawn at a small share of the unit scale
(the configuration's ``init.head_rgb_scale``), so that both heads move
every image by a little. Both the program and the
plain reference are handed the same tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import cnn


def seed_of(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of draws of a run's seed."""
    return (int(seed) * 1_000_003 + stream * 7_919) % (2 ** 63 - 1)


def cano_map(map_h: int, n_joints: int, fill: float = 0.35):
    """-> (positions (H, 2H, 3), normals (H, 2H, 3), lbs (N, J)) of a
    synthetic body; the same for every seed."""
    rng = np.random.default_rng(0)
    H, W = map_h, 2 * map_h
    v, u = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, H),
                       indexing="ij")
    pos = np.zeros((H, W, 3), np.float32)
    nml = np.zeros((H, W, 3), np.float32)
    r2 = (u / fill) ** 2 + (v / 0.9) ** 2
    inside = r2 < 1.0
    z = np.sqrt(np.clip(1.0 - r2, 0.0, None)) * 0.15
    for side, sign in ((0, 1.0), (1, -1.0)):
        p = np.stack([u * 0.4, -v * 0.9, sign * (z + 0.05)],
                     axis=-1).astype(np.float32)
        n = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-6)
        sl = slice(side * H, (side + 1) * H)
        pos[:, sl][inside] = p[inside]
        nml[:, sl][inside] = n[inside]
    mask = np.linalg.norm(pos, axis=-1) > 0
    ys = pos[mask][:, 1]
    centers = np.linspace(ys.min() - 1e-3, ys.max() + 1e-3, n_joints)
    w = np.exp(-((ys[:, None] - centers[None]) ** 2) / 0.02) \
        + 1e-4 * rng.random((ys.shape[0], n_joints))
    return pos, nml, (w / w.sum(1, keepdims=True)).astype(np.float32)


def hand_items(cano_pos: np.ndarray, n_verts: int) -> dict:
    """Stand-ins for the two MANO hands in the canonical pose: the
    ``n_verts`` points of largest x (left) and smallest x (right), and the
    body's bounding-box centre."""
    pts = cano_pos[np.linalg.norm(cano_pos, axis=-1) > 0.0]
    order = np.argsort(pts[:, 0], kind="stable")
    return dict(left_cano_mano_v=pts[order[-n_verts:]],
                right_cano_mano_v=pts[order[:n_verts]],
                cano_smpl_center=0.5 * (pts.min(0) + pts.max(0)))


def joint_mats(n_poses: int, n_joints: int, angle: float, shift: float,
               seed: int, device):
    """-> (mats (P, J, 4, 4), mats without the root translation, root x
    (P,)): each joint rotated about z by angle N(0, 1), the root moved
    along x by U(-shift, shift)."""
    g = torch.Generator(device=device).manual_seed(seed_of(seed, 1))
    a = angle * torch.randn((n_poses, n_joints), generator=g, device=device)
    tx = shift * (2 * torch.rand((n_poses,), generator=g, device=device) - 1)
    m = torch.eye(4, device=device).repeat(n_poses, n_joints, 1, 1)
    m[..., 0, 0], m[..., 0, 1] = torch.cos(a), -torch.sin(a)
    m[..., 1, 0], m[..., 1, 1] = torch.sin(a), torch.cos(a)
    wo_root = m.clone()
    m[..., 0, 3] = tx[:, None]
    return m, wo_root, tx


def pose_maps(cano_pos: np.ndarray, lbs, mats_wo_root):
    """(P, H/2, H/2, 6) front|back pose maps: the masked texels of the
    (H, 2H) canonical map skinned by each pose's joint matrices without
    the root, at the even rows and columns."""
    dev = mats_wo_root.device
    H, W = cano_pos.shape[:2]
    mask = torch.as_tensor(np.linalg.norm(cano_pos, axis=-1) > 0,
                           device=dev)
    pts = torch.as_tensor(cano_pos, device=dev)[mask]
    w = torch.as_tensor(lbs, device=dev)
    out = []
    for mats in mats_wo_root:
        m = (w @ mats.reshape(-1, 16)).reshape(-1, 4, 4)
        full = torch.zeros((H, W, 3), device=dev)
        full[mask] = torch.einsum("nxy,ny->nx", m[:, :3, :3], pts) \
            + m[:, :3, 3]
        half = full[::2, ::2]
        out.append(torch.cat([half[:, :H // 2], half[:, H // 2:]], -1))
    return torch.stack(out)


def _rodrigues(v):
    v = np.asarray(v, np.float64)
    th = np.linalg.norm(v)
    if th < 1e-12:
        return np.eye(3)
    k = v / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(th) * K + (1 - math.cos(th)) * K @ K


def _t(r=None, t3=None):
    m = np.eye(4)
    if r is not None:
        m[:3, :3] = r
    if t3 is not None:
        m[:3, 3] = t3
    return m


def free_view(center, rot_y: float, rot_x: float = 0.0,
              dist: float = 2.5) -> np.ndarray:
    """The animation CLI's orbit camera (world -> view) around ``center``:
    the body flipped upright, turned by rot_y about y and rot_x about x,
    ``dist`` in front of it."""
    return (_t(t3=np.array([0.0, 0.0, dist])) @ _t(_rodrigues([rot_x, 0, 0]))
            @ _t(_rodrigues([0, rot_y, 0])) @ _t(_rodrigues([math.pi, 0, 0]))
            @ _t(t3=-np.asarray(center, np.float64))).astype(np.float32)


def ring_cameras(n: int, img_w: int, img_h: int, dist: float,
                 focal: float):
    """-> (extr (n, 4, 4), intr (3, 3)) of n cameras on a ring about the
    body's vertical axis, every one looking at its centre."""
    extr = np.stack([free_view(np.zeros(3), 2 * math.pi * i / n, 0.0, dist)
                     for i in range(n)])
    intr = np.array([[focal, 0, img_w / 2], [0, focal, img_h / 2],
                     [0, 0, 1]], np.float32)
    return extr, intr


def train_images(n: int, img_w: int, img_h: int, seed: int, device):
    """-> (colour (n, H, W, 3), mask (n, H, W), boundary band (n, H, W)):
    uniform colours, an elliptic silhouette whose radii vary with the
    seed, and the band within 5 pixels of its edge."""
    g = torch.Generator(device=device).manual_seed(seed_of(seed, 2))
    color = torch.rand((n, img_h, img_w, 3), generator=g, device=device)
    r = 0.5 + 0.1 * torch.rand((n, 2), generator=g, device=device)
    yy = torch.linspace(-1, 1, img_h, device=device)[None, :, None]
    xx = torch.linspace(-1, 1, img_w, device=device)[None, None, :]
    mask = ((xx / (0.6 * r[:, 0, None, None])) ** 2
            + (yy / (1.5 * r[:, 1, None, None])) ** 2 < 1.0).float()
    m = mask[:, None]
    grow = torch.nn.functional.max_pool2d(m, 11, 1, 5)
    shrink = -torch.nn.functional.max_pool2d(-m, 11, 1, 5)
    return color, mask, (grow - shrink)[:, 0]


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def weight_spec(model, head_rgb: float) -> list:
    """(name, shape, kind, factor) of every network weight the reference
    ``Avatar`` holds outside its canonical Gaussians: kind "normal" (times
    factor), "uniform" (in +-factor), "const" (factor) or "zero";
    ``head_rgb`` scales the position and other heads' ToRGB weights."""
    spec = []
    for mod_name, mod in model.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            if name.startswith("cano_gaussian."):
                continue
            shape = tuple(p.shape)
            if isinstance(mod, cnn.EqualLinear) and p_name == "weight":
                spec.append((name, shape, "normal", 1.0 / mod.lr_mul))
            elif isinstance(mod, cnn.EqualLinear):
                spec.append((name, shape, "const", mod.bias_init))
            elif isinstance(mod, torch.nn.Conv2d) and p_name == "weight":
                fan_in = shape[1] * shape[2] * shape[3]
                spec.append((name, shape, "uniform", 1.0 / math.sqrt(fan_in)))
            elif p_name == "weight" and p.dim() >= 4:
                # equalized-lr convolutions; the position and other heads'
                # ToRGBs small, as near the end of the reference's pretrain
                # their outputs stay near the canonical Gaussians
                small = ".to_rgbs" in name and not name.startswith(
                    "color_net")
                spec.append((name, shape, "normal",
                             head_rgb if small else 1.0))
            else:
                spec.append((name, shape, "zero", 0.0))
    for name, b in model.named_buffers():
        if ".noises." in name:
            spec.append((name, tuple(b.shape), "normal", 1.0))
    return spec


def make_weights(spec: list, seed: int, device) -> dict:
    """The tensors of ``spec`` from the seed, on the device: one normal
    and one uniform draw, split in the spec's order."""
    g = torch.Generator(device=device).manual_seed(seed_of(seed, 3))
    sizes = {k: sum(math.prod(s) for _, s, kind, _ in spec if kind == k)
             for k in ("normal", "uniform")}
    flat = dict(normal=torch.randn(sizes["normal"], generator=g,
                                   device=device),
                uniform=2 * torch.rand(sizes["uniform"], generator=g,
                                       device=device) - 1)
    at = dict(normal=0, uniform=0)
    out = {}
    for name, shape, kind, f in spec:
        n = math.prod(shape)
        if kind in flat:
            out[name] = flat[kind][at[kind]:at[kind] + n].view(shape) * f
            at[kind] += n
        else:
            out[name] = torch.full(shape, float(f) if kind == "const"
                                   else 0.0, device=device)
    return out


def lpips_weights(seed: int, device) -> dict:
    """VGG16 trunk weights N(0, 1 / fan_in), zero biases, and |N(0, 1)| / C
    lin weights, from the seed (no weight file is in the repository)."""
    from .reference.train import LIN, vgg_shapes
    g = torch.Generator(device=device).manual_seed(seed_of(seed, 4))
    shapes = vgg_shapes()
    n = sum(math.prod(s) for s in shapes) + sum(LIN)
    flat = torch.randn(n, generator=g, device=device)
    out, at = {}, 0
    for i, s in enumerate(shapes):
        k = math.prod(s)
        out[f"convs.{i}.weight"] = flat[at:at + k].view(s) / math.sqrt(
            s[1] * s[2] * s[3])
        out[f"convs.{i}.bias"] = torch.zeros(s[0], device=device)
        at += k
    for i, c in enumerate(LIN):
        out[f"lins.{i}"] = flat[at:at + c].abs() / c
        at += c
    return out
