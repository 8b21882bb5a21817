"""Time the animation route's PCA fit (``data/mv_rgb_dataset._fit_pca``)
at the shipped configs' size on one CUDA card.

    python -m animatablegaussians_torch.tools.pca_fit_bench

The shipped configs fit ``n_pca`` 20 components over 2001 poses of a
1024x1024 front pose map with ~265k masked texels (797k values a pose).
No such capture is in the repository, so the frames are made from a seed:
a mean map plus a random multiple of one of four modes, on the first
``--texels`` texels in raster order. Prints the stacked X's size, the
fit's seconds (of them the host's seconds making the frames), the peak
device memory, the card's name and power limit, and checks that the fit's
variances are finite and descending.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=2001)
    ap.add_argument("--texels", type=int, default=265_667)
    ap.add_argument("--map", type=int, default=1024)
    ap.add_argument("--components", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from animatablegaussians_torch.data.mv_rgb_dataset import _fit_pca

    dev = torch.device(device)
    rng = np.random.default_rng(args.seed)
    side = args.map
    mask = (np.arange(side * side) < args.texels).reshape(side, side, 1)
    base = (rng.standard_normal((side, side, 3)) * mask).astype(np.float32)
    modes = (rng.standard_normal((4, side, side, 3)) * mask).astype(
        np.float32)
    coef = rng.standard_normal(args.poses).astype(np.float32)
    made = [0.0]

    def front(i):
        t = time.perf_counter()
        m = base + coef[i] * modes[i % 4]
        made[0] += time.perf_counter() - t
        return m

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pca = _fit_pca(front, list(range(args.poses)), args.components, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    var = pca["explained_variance"]
    ok = bool(np.isfinite(pca["components"]).all() and np.isfinite(var).all()
              and (np.diff(var) <= 0).all())
    res = dict(poses=args.poses, values=int(pca["mean"].shape[0]),
               x_gb=args.poses * pca["mean"].shape[0] * 4 / 1e9,
               fit_s=fit_s, frames_s=made[0], ok=ok,
               peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                         if dev.type == "cuda" else None))
    card = (subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip() if dev.type == "cuda" else "cpu")
    print(f"[pca_fit] {res['poses']} poses x {res['values']} values "
          f"(X {res['x_gb']:.2f} GB in float32), {args.components} "
          f"components: fit {fit_s:.3f} s, of which making the frames on "
          f"the host {made[0]:.3f} s; peak device memory "
          + (f"{res['peak_gib']:.2f} GiB" if res["peak_gib"] is not None
             else "not measured")
          + f"; variances finite and descending: {ok} ({card})")
    if not ok:
        raise SystemExit("pca_fit: the fit's variances are not finite and "
                         "descending")
    return res


if __name__ == "__main__":
    main()
