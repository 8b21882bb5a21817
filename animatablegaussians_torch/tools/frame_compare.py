"""One frame against a reference render of the same avatar, allowing the
few pixels where an alpha decision flips.

Two renders that differ only by float rounding (two frameworks, a kernel
and its plain version, a batch-F and a batch-1 CNN) can round a Gaussian's
alpha at a pixel to opposite sides of the blend's 1/255 cutoff, or a
pixel's transmittance to opposite sides of its 1e-4 stop. Such a pixel
differs by that one contribution: its alpha ``a`` (at most ``FLIP_ALPHA``
within rounding) times the transmittance in front of it (at most 1) times
the difference between the contribution's value and what lies behind it.
Colour composites the Gaussians' colours and the background, depth the
Gaussians' view-space depths over a background of 0, so that difference is
at most the span of those values (``contribution_span``). A flipped pixel
(any channel off by more than its tolerance) is therefore held to
``FLIP_ALPHA`` times the span plus the tolerance in every channel, and the
flipped pixels of a frame to ``FLIP_SHARE`` of its covered pixels (alpha
above 1/255 in the reference). Every other pixel is held to the tolerance.

``tests/test_torch_animate.py`` uses this rule for the port against the
JAX package on the CPU and, in its ``gpu`` test, for the card's frames
against the plain path.
"""

from __future__ import annotations

import numpy as np
import torch

# the alpha of the one contribution that flips: at the blend's cutoff
FLIP_ALPHA = 1.0 / 255
# flipped pixels per covered pixel of the reference, about twice the
# largest reading: the CPU parity test (tests/test_torch_animate.py, the
# port against the JAX package) flips 0 to 5 pixels of a 128x128 frame with
# 3,413 to 3,610 covered, at most 1.41e-3; the card against the plain path
# on the H100 flipped none in 26 frames with 8-10% of 1024x1024 covered
# (PERF.md)
FLIP_SHARE = 3e-3
COVERED = 1.0 / 255


def contribution_span(positions, colors, extr, bg) -> dict:
    """The most one contribution can move a pixel per unit of its alpha:
    for colour the largest per-channel span of the Gaussians' colours, the
    background and 0 (a composite cut at the transmittance stop); for
    depth the largest view-space depth of a Gaussian in front of the
    camera. ``positions`` (N, 3) world space, ``colors`` (N, 3), ``extr``
    (4, 4), ``bg`` (3,), tensors or arrays."""
    pos = torch.as_tensor(positions, dtype=torch.float64)
    col = torch.as_tensor(colors, dtype=torch.float64).reshape(-1, 3)
    extr = torch.as_tensor(extr, dtype=torch.float64, device=pos.device)
    bg = torch.as_tensor(bg, dtype=torch.float64, device=col.device)
    z = pos @ extr[2, :3] + extr[2, 3]
    vals = torch.cat([col, bg.reshape(1, 3), torch.zeros_like(bg)[None]])
    span = vals.amax(0) - vals.amin(0)
    return {"color": float(span.max()),
            "depth": float(z[z > 0].max()) if bool((z > 0).any()) else 0.0}


def _host(x) -> torch.Tensor:
    """A float32 CPU tensor of ``x`` (a tensor on any device, or an array,
    copied so that a read-only array is not wrapped)."""
    x = x if torch.is_tensor(x) else torch.from_numpy(np.array(x))
    return x.detach().to("cpu", torch.float32)


def flip_diff(out: dict, ref: dict, atol: dict, span: dict) -> dict:
    """``out`` against ``ref`` (``rgb_map`` (H, W, 3), ``mask_map`` (H, W)
    and, where both have it, ``depth_map`` (H, W)): the flipped pixels
    (any channel off by more than ``atol``), their share of the covered
    pixels, per channel the largest error over the other pixels and over
    the flipped ones with its limit, the covered share of the frame and
    the mean alpha."""
    pair = {"color": "rgb_map", "alpha": "mask_map", "depth": "depth_map"}
    err = {}
    for k, key in pair.items():
        if key in out and key in ref:
            e = (_host(out[key]) - _host(ref[key])).abs()
            err[k] = (e.amax(-1) if k == "color" else e).reshape(-1)
    bad = torch.zeros_like(err["alpha"], dtype=torch.bool)
    for k, e in err.items():
        bad |= e > atol[k]
    zero = torch.zeros(())
    rest = {k: float(torch.where(bad, zero, e).max()) for k, e in err.items()}
    flip = {k: float(torch.where(bad, e, zero).max()) for k, e in err.items()}
    limit = {k: FLIP_ALPHA * (1.0 if k == "alpha" else span[k]) + atol[k]
             for k in err}
    alpha = _host(ref["mask_map"])
    n_cov = int((alpha > COVERED).sum())
    return dict(rest=rest, flip=flip, limit=limit, n_flip=int(bad.sum()),
                n_covered=n_cov, share=int(bad.sum()) / max(n_cov, 1),
                in_view=n_cov / alpha.numel(),
                mean_alpha=float(alpha.mean()))


def flips_ok(diffs: list, atol: dict) -> bool:
    """Every frame: the unflipped pixels within ``atol``, the flipped ones
    within their limits and at most ``FLIP_SHARE`` of the covered pixels."""
    return all(all(v <= atol[k] for k, v in d["rest"].items())
               and all(v <= d["limit"][k] for k, v in d["flip"].items())
               and d["n_flip"] <= FLIP_SHARE * d["n_covered"]
               for d in diffs)


def flip_summary(diffs: list, atol: dict) -> str:
    """One line: the worst unflipped error per channel, the flipped pixels'
    count, share and worst error per channel, each beside its limit."""
    keys = diffs[0]["rest"]
    worst = {k: max(d["rest"][k] for d in diffs) for k in keys}
    fl = {k: max(d["flip"][k] for d in diffs) for k in keys}
    lim = {k: min(d["limit"][k] for d in diffs) for k in keys}
    return (", ".join(f"{k} {v:.3e} (atol {atol[k]:g})"
                      for k, v in worst.items())
            + f" but for {sum(d['n_flip'] for d in diffs)} flipped pixels "
            f"in {len(diffs)} frames (at most "
            f"{max(d['share'] for d in diffs):.2e} of a frame's covered "
            f"pixels, limit {FLIP_SHARE:g}; "
            + ", ".join(f"{k} off by {fl[k]:.3e} (limit {lim[k]:.3e})"
                        for k in keys) + ")")
