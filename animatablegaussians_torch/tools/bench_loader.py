"""Loader-fed train throughput at the full-width fixture's size.

Port of ``animatablegaussians_tpu/tools/bench_loader.py``. The bare train
step (``chip_smoke.py`` phase 9) feeds one item that already lies on the
card; real training decodes a 1500x2048 JPEG, its mask and an EXR pose
map per item and has to hide that host work behind the card's (the
reference hides it in torch DataLoader workers, ref:
main_avatar.py:273-277, num_workers=8). This tool measures that:

  1. ``build_dataset`` writes a synthetic on-disk dataset at AvatarReX
     sizes (colour JPEG 1500x2048 at quality 90 with photographic noise,
     mask JPEG, pose-map EXR 512^2 x 6), with cv2 as the JAX tool does, so
     the two write the same files;
  2. ``DiskDataset.__getitem__`` does the per-item host work: the JPEG
     decodes (``data/native_io``, the data path's one codec), the mask's
     boundary band, the EXR read, the float32 conversion;
  3. ``timed_loop`` runs the train step (``avatar_trainer.make_train_step``
     at B = 1, ``make_train_step_batched`` at ``--batch`` B) fed by
     ``data/loader.PrefetchLoader`` (a thread pool reading ahead of the
     card) on ``tools/render_fixture``'s full-width AvatarNet with its loss
     weights, LPIPS weights and 512 crop, and reports it/s, ms/step and the
     mean time a step waited on the loader.

    python -m animatablegaussians_torch.tools.bench_loader [--frames 24]
        [--steps 40] [--threads 8] [--batch B] [--root DIR]

``--batch 0`` (the default) runs the B = 1 step on loader batches of one.
The dataset is written under ``build/loader_ds`` of the checkout unless
``--root`` names another directory, once per size. ``main(argv, device=)``
returns the readings; the tests run the pieces on the CPU at a tiny size.

Two things of the JAX tool are left out: its ``vs_baseline``, a ratio to a
5 it/s figure that no H100 run measured, and its ``assert n_overflow ==
0``: the port bins from each frame's exact pair count
(``ops/rasterize/binning.py``) and never drops a pair.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from animatablegaussians_torch.data import native_io
from animatablegaussians_torch.utils import exr, synthetic

DEFAULT_ROOT = Path(__file__).resolve().parents[2] / "build" / "loader_ds"
WARMUP_STEPS = 6


def build_dataset(root: str, n_frames: int, img_w: int, img_h: int,
                  map_h: int, seed: int = 0) -> None:
    """Synthetic frames at AvatarReX scale, written once and reused."""
    import cv2

    stamp = os.path.join(root, f"done_{n_frames}_{img_w}x{img_h}_{map_h}")
    if os.path.exists(stamp):
        return
    os.makedirs(root, exist_ok=True)
    pos, _, _ = synthetic.make_cano_map(map_h=map_h)
    rng = np.random.default_rng(seed)
    metas = {}
    for f in range(n_frames):
        items = synthetic.make_items(img_w=img_w, img_h=img_h, seed=f,
                                     cano_pos_map=pos)
        # photographic-complexity colour content (flat synthetics would
        # make the JPEG decode unrealistically cheap)
        noise = rng.standard_normal((img_h // 8, img_w // 8, 3))
        tex = cv2.resize(noise, (img_w, img_h),
                         interpolation=cv2.INTER_CUBIC)
        color = np.clip(0.5 + 0.25 * tex, 0, 1)
        cv2.imwrite(os.path.join(root, f"color_{f:04d}.jpg"),
                    (color * 255).astype(np.uint8),
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        mask = (np.asarray(items["mask_img"]) * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(root, f"mask_{f:04d}.jpg"), mask)
        exr.write_exr(os.path.join(root, f"pose_{f:04d}.exr"),
                      np.asarray(items["smpl_pos_map"], np.float32))
        metas[f"extr_{f}"] = np.asarray(items["extr"])
        metas[f"intr_{f}"] = np.asarray(items["intr"])
        metas[f"mats_{f}"] = np.asarray(items["cano2live_jnt_mats"])
    np.savez(os.path.join(root, "meta.npz"), **metas)
    open(stamp, "w").close()


class DiskDataset:
    """``__getitem__`` is the AvatarReX per-item host pipeline: the JPEG
    decodes, the mask's boundary band, the EXR pose map."""

    def __init__(self, root: str, n_frames: int):
        self.root = root
        self.n = n_frames
        self.meta = dict(np.load(os.path.join(root, "meta.npz")))

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> dict:
        color = native_io.decode_jpeg(
            os.path.join(self.root, f"color_{i:04d}.jpg"))
        mask_raw = native_io.decode_jpeg(
            os.path.join(self.root, f"mask_{i:04d}.jpg"), grayscale=True)
        boundary, binarized = native_io.boundary_mask(mask_raw)
        pose = exr.read_exr(os.path.join(self.root, f"pose_{i:04d}.exr"))
        return dict(
            color_img=color.astype(np.float32) / 255.0,
            mask_img=binarized.astype(np.float32),
            boundary_mask_img=boundary.astype(np.float32),
            smpl_pos_map=np.asarray(pose, np.float32),
            extr=self.meta[f"extr_{i}"],
            intr=self.meta[f"intr_{i}"],
            cano2live_jnt_mats=self.meta[f"mats_{i}"],
        )


def make_run(net, batch: int, device, lpips=None, seed: int = 0,
             img_w: int = None, img_h: int = None,
             patch_size: int = None):
    """``run(loader_batch) -> loss terms``: one update of ``net`` on one
    loader batch, with ``render_fixture``'s Adam settings and loss weights
    (``patch_size`` defaults to its 512). ``batch`` 0 runs the B = 1 step on
    the batch's one item, ``batch`` B the batched step. Every step's draws
    come from one generator seeded with ``seed`` on ``device``."""
    from animatablegaussians_torch.tools import render_fixture as rf
    from animatablegaussians_torch.training import avatar_trainer as at

    state = at.make_train_state(net, rf.LR_INIT, rf.ITER_NUM)
    kw = dict(loss_weight=rf.LOSS_WEIGHT, lpips=lpips,
              patch_size=patch_size or rf.PATCH_SIZE, img_w=img_w,
              img_h=img_h)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_pts = net.n_points
    if batch:
        step = at.make_train_step_batched(net, **kw)

        def run(b: dict) -> dict:
            draws = [at.make_draws(gen, n_pts) for _ in range(batch)]
            return step(state, b, draws)[1]
    else:
        step = at.make_train_step(net, **kw)

        def run(b: dict) -> dict:
            items = {k: v[0] for k, v in b.items()}
            return step(state, items, at.make_draws(gen, n_pts))[1]
    return run


def timed_loop(run, loader, n_steps: int, warm: int = WARMUP_STEPS,
               sync=None) -> dict:
    """Run ``run`` on the loader's batches, epoch after epoch, for ``warm``
    + ``n_steps`` steps (``warm`` >= 1); time the last ``n_steps``
    (``sync()`` before each clock read, for a card). Returns it/s (items a
    second), ms/step, the seconds each timed step waited on the loader and
    every step's terms as floats."""
    if warm < 1:
        raise ValueError("timed_loop needs warm >= 1: the clock starts "
                         "after the last warm-up step")
    sync = sync or (lambda: None)
    terms, waits = [], []
    done = 0
    while done < warm + n_steps:
        for b in loader:
            if done >= warm:
                waits.append(loader.waits[-1])
            items = next(iter(b.values())).shape[0]
            terms.append(run(b))
            done += 1
            if done == warm:
                sync()
                t_start = time.perf_counter()
            if done >= warm + n_steps:
                break
    sync()
    dt = time.perf_counter() - t_start
    return dict(it_s=n_steps * items / dt, ms_step=1e3 * dt / n_steps,
                items_per_step=items, waits=waits,
                wait_mean_s=statistics.fmean(waits) if waits else 0.0,
                terms=[{k: float(v) for k, v in t.items()} for t in terms])


def _card(device) -> str:
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--root", default=str(DEFAULT_ROOT))
    args = ap.parse_args(argv)
    from animatablegaussians_torch.data.loader import PrefetchLoader
    from animatablegaussians_torch.tools import render_fixture as rf
    from animatablegaussians_torch.training.lpips import LPIPS, init_random

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build_dataset(args.root, args.frames, rf.IMG_W, rf.IMG_H, rf.MAP_H)
    build_s = time.perf_counter() - t0
    print(f"[bench_loader] dataset at {args.root} ({args.frames} frames, "
          f"{build_s:.1f} s)")
    net, _ = rf.build(dev)
    lpips = LPIPS(init_random(rf.LPIPS_SEED), device=dev)
    run = make_run(net, args.batch, dev, lpips=lpips, img_w=rf.IMG_W,
                   img_h=rf.IMG_H)
    loader = PrefetchLoader(DiskDataset(args.root, args.frames),
                            batch_size=max(args.batch, 1), shuffle=True,
                            num_threads=args.threads, prefetch=2,
                            device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else None
    res = timed_loop(run, loader, args.steps, sync=sync)
    bad = [t for t in res["terms"]
           if not all(np.isfinite(v) for v in t.values())]
    print(f"[bench_loader] loader-fed: {res['it_s']:.3f} it/s, "
          f"{res['ms_step']:.2f} ms/step over {args.steps} steps of "
          f"{res['items_per_step']} items ({args.threads} decode threads); "
          f"mean loader wait {1e3 * res['wait_mean_s']:.2f} ms a step "
          f"({_card(dev)})")
    if bad:
        raise SystemExit(f"bench_loader: non-finite loss terms {bad[0]}")
    print(json.dumps({"metric": "avatar_train_step_loader_fed",
                      "value": res["it_s"], "unit": "it/s",
                      "ms_step": res["ms_step"],
                      "wait_mean_ms": 1e3 * res["wait_mean_s"]}))
    return dict(res, build_s=build_s)


if __name__ == "__main__":
    main()
