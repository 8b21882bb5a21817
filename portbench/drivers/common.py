"""What the drivers share: the program's avatar built from the cell's
configuration and loaded with the seed's weights, the plain reference
built from the same inputs, the pose pool, and the set-up clock."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import inputs
from ..reference import avatar as ref_avatar


@contextlib.contextmanager
def part(ctx, name: str):
    """Adds the block's seconds, up to the end of its device work, to the
    set-up part ``name``."""
    t = time.perf_counter()
    yield
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    ctx.parts[name] = ctx.parts.get(name, 0.0) + time.perf_counter() - t


def canonical(ctx):
    """-> (positions, normals, lbs) of the configuration's canonical map,
    cached on ``ctx``."""
    if getattr(ctx, "cano", None) is None:
        m = ctx.cfg["model"]
        ctx.cano = inputs.cano_map(int(m["map_h"]), int(m["n_joints"]))
    return ctx.cano


def weights(ctx) -> dict:
    """The seed's network weights on the device."""
    m = ctx.cfg["model"]
    holder = ref_avatar.weight_holder(m, int(m["map_h"]))
    spec = inputs.weight_spec(holder, float(ctx.cfg["init"]["head_rgb_scale"]))
    return inputs.make_weights(spec, ctx.seed, ctx.device)


def program_avatar(ctx):
    """The program's ``AvatarNet`` for the configuration, holding the
    seed's weights. Its canonical Gaussians are its own, made from the
    canonical points."""
    from animatablegaussians_torch.models.avatar import AvatarNet
    m = ctx.cfg["model"]
    with part(ctx, "fixture"):
        pos, nml, lbs = canonical(ctx)
        opt = {k: m[k] for k in ("with_viewdirs", "random_style",
                                 "channel_max", "texel_block")}
        net = AvatarNet(opt, pos, lbs, cano_nml_map=nml, device=ctx.device,
                        seed=0)
    with part(ctx, "weights"):
        w = weights(ctx)
        missing, unexpected = net.load_state_dict(w, strict=False)
        left = [k for k in missing if not k.startswith("cano_gaussian.")]
        if unexpected or left:
            raise RuntimeError(f"the program's avatar does not take the "
                               f"benchmark's weights: unexpected "
                               f"{unexpected[:4]}, not given {left[:4]}")
        del w
    return net


def reference_avatar(ctx, tf32: bool = False):
    """The plain reference avatar with the seed's weights. ``tf32``: the
    control, the same model with TF32 convolutions and matrix products."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    m = ctx.cfg["model"]
    pos, nml, lbs = canonical(ctx)
    model = ref_avatar.Avatar(m, pos, nml, lbs, ctx.device)
    missing, unexpected = model.load_state_dict(weights(ctx), strict=False)
    if unexpected or [k for k in missing
                      if not k.startswith("cano_gaussian.")]:
        raise RuntimeError("the reference avatar does not take its weights")
    return model


def precision(cfg) -> None:
    """The configuration's precision: float32, TF32 as it says."""
    tf32 = bool(cfg["precision"]["allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


class PosePool:
    """``n`` poses from the seed on the device: joint matrices, pose maps
    (from the matrices without the root), and each pose's body centre."""

    def __init__(self, ctx, n: int):
        m, t = ctx.cfg["model"], ctx.traffic
        pos, _, lbs = canonical(ctx)
        self.mats, wo_root, tx = inputs.joint_mats(
            n, int(m["n_joints"]), float(t["pose_angle"]),
            float(t.get("root_shift", 0.0)), ctx.seed, ctx.device)
        self.maps = inputs.pose_maps(pos, lbs, wo_root)
        pts = pos[np.linalg.norm(pos, axis=-1) > 0]
        centre = 0.5 * (pts.min(0) + pts.max(0))
        self.centres = np.tile(centre, (n, 1))
        self.centres[:, 0] += tx.cpu().numpy()
        self.n = n


def order(ctx, n: int, stream: int) -> list:
    """A permutation of range(n) from the seed."""
    g = torch.Generator().manual_seed(inputs.seed_of(ctx.seed, stream))
    return torch.randperm(n, generator=g).tolist()


def to_u8(img: torch.Tensor) -> np.ndarray:
    """The image as ``(clamp(0, 1) * 255).astype(uint8)`` on the host, as
    the animation CLI hands it to the encoder."""
    from animatablegaussians_torch.testing.animate import _to_u8
    return _to_u8(img)


def ref_u8(img: torch.Tensor) -> np.ndarray:
    return (img.clamp(0, 1).cpu().numpy() * 255).astype(np.uint8)
