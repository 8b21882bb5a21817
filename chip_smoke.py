"""GPU smoke run of the PyTorch / CUDA port: the novel-pose render path
and the avatar train step.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (CUDA_HOME or PATH); builds the kernels
itself. Phases, each printing a line, any failure exiting non-zero:

  1. device   - the card, its name and power limit (nvidia-smi);
  2. build    - nvcc builds csrc/*.cu for sm_90a (seconds, ptxas report);
  3. expand   - pair-expansion kernel vs its plain version at the slice's
                shapes (531,520 Gaussians, 1500x2048): keys, gids and
                tile ranges must be equal;
  4. blend    - tile-blend kernel vs its plain version on the same pairs,
                and the (pixel, pair) work this frame's data needs;
  5. blend_bwd - backward tile-blend kernel vs its plain version on the
                same pairs with seeded cotangents, per channel, both timed;
  6. slice    - the full-width fixture (tools/render_fixture.py): one
                render and one 4-frame render_sequence through both forward
                kernels (launch counters > 0), finite output, mask coverage
                > 0, one frame's kernel image against the plain path's,
                n_pairs within 1% of the 1,291,771 the JAX package bins on
                the same fixture, and a small fixture against the CPU path;
  7. timing   - median ms/frame of render and render_sequence, each kernel
                against its plain version (CUDA events, after warm-up);
  8. profile  - where one render's time goes: median ms of its stages
                (CUDA events between them), the splat's sub-stages, and the
                device's busy time under torch.profiler against the median
                wall time, with the largest device items and the ops that
                launched the four largest;
  9. train    - the full-width train step with the bench's settings
                (tools/render_fixture.py): step 0's loss terms and
                gradients through the kernels against the plain path, then
                2 warm-up and 5 timed steps through the kernels (launch
                counters reset just before: the backward kernel must run
                once per step, and the JSON record's launches are these),
                median ms/step, peak memory, the device's busy share of one
                step with its largest items and their launching ops, the
                step's forward / backward / Adam split (CUDA events) and
                LPIPS's share, finite losses, moved parameters;
 10. pretrain - two full-width pretrain steps, finite losses.

Each kernel's record carries its bound: the least time the card could take
for the same work, the larger of the bytes it must move over the memory
rate and the operations it must do, counted from this run's data, over the
FP32 rate (the H100 SXM data sheet figures below). The line before the last
is the kernels' JSON record; the last line is ``{"ok": true, "device":
{...}}``. TF32 is off for matmuls and convs.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

# (Gaussian, tile) pairs the JAX package bins for this fixture at init
# (its preprocess + tile_rect on exact-KNN scales, recomputed on the CPU by
# tests/test_torch_rasterize.py::test_full_fixture_pair_count_matches_jax).
# BENCH_r05.json's 1,065,157 is, as read from bench.py:219-221 (not rerun),
# the count its train loop printed after its warm-up and timed Adam steps,
# not at init.
JAX_N_PAIRS = 1_291_771
FRAMES = 4
# kernel vs plain version on the card: the per-pair arithmetic rounds
# identically (the kernels are built with -fmad=false); the plain version
# forms the transmittance with cumprod and the colour sums with bmm, so
# sums differ in order (~1e-7 relative), and a pixel whose transmittance
# sits within rounding of the 1e-4 cutoff may differ by one contribution
# (< 1e-4). Depth is weighted by z ~ 2.
ATOL_BLEND = {"color": 1e-5, "depth": 3e-5, "alpha": 1e-5}
# backward kernel vs its plain version on the card, per channel of grad_rows,
# relative to the channel's largest entry: the same per-pair arithmetic
# (-fmad=false), but the plain version's cumprod and cumsum scan in another
# order, the kernel sums each pair's pixels with warp shuffles and atomics in
# an order that varies from run to run, and the suffix term (total - prefix)
# cancels before it is divided by 1 - alpha
RTOL_BLEND_BWD = 1e-3
# step 0 through the kernels vs through the plain versions: loss terms, and
# each parameter group's gradient as a relative L2 error (the blend's
# differences above, carried back through the CNN heads)
RTOL_LOSS = 1e-5
RTOL_GRAD = 1e-3
WARMUP_STEPS, TIMED_STEPS = 2, 5
# H100 SXM (NVIDIA data sheet): HBM3 rate and FP32 rate outside the tensor
# cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations per (pixel, pair) in the blend kernels, counting exp and a
# division as one each: the geometry every evaluated pair costs (dx, dy,
# the quadratic form, the tests, exp, op G, the clamp); what a contributing
# pair adds in the forward (transmittance, weight, four multiply-adds); and
# in the backward (the forward's, the four prefixes, suffixes and dot
# products, galpha, the ten per-pair terms and their sums over pixels)
OPS_EVAL = 15
OPS_FWD_CONTRIB = 12
OPS_BWD_CONTRIB = 83
# small fixture on the card vs the CPU path (libm exp and conv sums differ
# between the two devices; one alpha >= 1/255 decision that flips moves a
# pixel by at most ~1/255)
ATOL_CPU = 1e-2


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms of ``fn`` over ``reps`` launches, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> list:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def stage_ms(net, items, kw, reps: int = 5) -> dict:
    """Median ms of each stage of one ``AvatarNet.render``, composed as
    ``render`` composes them, with CUDA events between the stages."""
    pose = items["smpl_pos_map"][None, ..., :3]
    style = net.constant_style()
    bg = net._bg(kw["bg_color"])
    o = {}
    stages = {
        "viewdir map + encoder": lambda: o.update(vd=net._encode_viewdirs(
            net._viewdir_half_map(items)[None])),
        "position_net": lambda: o.update(pos=net.position_net(style, pose)),
        "other_net": lambda: o.update(other=net.other_net(style, pose)),
        "color_net": lambda: o.update(color=net.color_net(
            style, pose, view_feature1=o["vd"][0],
            view_feature2=o["vd"][1])),
        "select + skin + splat": lambda: net._finish_render(
            items, o["pos"], o["other"], o["color"], bg, kw["img_w"],
            kw["img_h"]),
    }
    runs = {name: [] for name in stages}
    with torch.no_grad():
        for _ in range(reps + 1):               # the first run warms up
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(stages) + 1)]
            torch.cuda.synchronize()
            ev[0].record()
            for i, fn in enumerate(stages.values()):
                fn()
                ev[i + 1].record()
            torch.cuda.synchronize()
            for i, name in enumerate(stages):
                runs[name].append(ev[i].elapsed_time(ev[i + 1]))
    return {name: statistics.median(t[1:]) for name, t in runs.items()}


def device_profile(fn, top: int = 8, owners_of: int = 4):
    """(busy ms, rows, owners): the summed time of the device kernels and
    copies ``fn`` launches, under torch.profiler; the ``top`` largest of
    them as (name, ms, calls); and, for the ``owners_of`` largest, the
    three (launching op, autograd node or "forward", the op's first input
    shapes) that spent most of its time, as {name: [(owner, ms), ...]}.
    Host-side ops and annotated ranges (``Optimizer.step``'s) are left out
    of the sums: they span their kernels' time too. (None, [], {}) if the
    profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    evs = [e for e in prof.key_averages()
           if e.device_type != DeviceType.CPU and dev_us(e) > 0
           and not getattr(e, "is_user_annotation", False)]
    busy = sum(dev_us(e) for e in evs) / 1e3
    if not busy:
        return None, [], {}
    evs.sort(key=dev_us, reverse=True)
    rows = [(e.key, dev_us(e) / 1e3, e.count) for e in evs[:top]]
    wanted = {name for name, _, _ in rows[:owners_of]}
    owners = {}
    for e in prof.events():
        for k in getattr(e, "kernels", ()):
            if k.name not in wanted:
                continue
            node, p = "forward", e
            while p is not None:
                if p.name.startswith("autograd::engine::evaluate_function: "):
                    node = p.name.split(": ", 1)[1]
                    break
                p = p.cpu_parent
            key = (e.name, node, str(list(e.input_shapes or [])[:3]))
            d = owners.setdefault(k.name, {})
            d[key] = d.get(key, 0.0) + k.duration / 1e3
    owners = {n: sorted(d.items(), key=lambda kv: -kv[1])[:3]
              for n, d in owners.items()}
    return busy, rows, owners


def print_profile(label: str, busy, rows, owners, wall_ms: float) -> None:
    if busy is None:
        phase("profile", f"torch.profiler saw no device time in the "
              f"{label}: busy share not measured")
        return
    phase("profile", f"{label}: device busy {busy:.3f} ms of a median "
          f"{wall_ms:.2f} ms: idle {100 * (1 - busy / wall_ms):.1f}%")
    for name, ms, calls in rows:
        phase("profile", f"  {ms:9.3f} ms {calls:5d} calls  {name[:70]}")
        for (op, node, shapes), oms in owners.get(name, ()):
            phase("profile", f"      {oms:9.3f} ms launched by {op} "
                  f"({node}) on {shapes[:90]}")


def train_stage_ms(net, state, items, draws, tkw, reps: int = 3) -> dict:
    """Median ms of the train step's forward (render + losses), backward
    and Adam update, composed as make_train_step composes them, with CUDA
    events between them; each run is a real step."""
    from animatablegaussians_torch.training import avatar_trainer as at
    names = ("forward (render + losses)", "backward", "Adam + schedule")
    runs = {n: [] for n in names}
    for r in range(reps + 1):                 # the first run warms up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        net.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        ev[0].record()
        total, _ = at.compute_losses(net, items, draws, state.iter_idx,
                                     **tkw)
        ev[1].record()
        total.backward()
        ev[2].record()
        state.optimizer.step()
        state.scheduler.step()
        state.iter_idx += 1
        ev[3].record()
        torch.cuda.synchronize()
        if r:
            for i, n in enumerate(names):
                runs[n].append(ev[i].elapsed_time(ev[i + 1]))
    return {n: statistics.median(t) for n, t in runs.items()}


def bound(n_bytes: float, n_ops: float = 0.0):
    """(bound ms, what bounds it) for work that must move ``n_bytes`` and
    do ``n_ops`` FP32 operations on one H100."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pair_work(rows, gid, starts, grid_x, img_w, img_h):
    """(evaluated, contributing) (pixel, pair) counts this frame's data
    needs in the blend: a pixel evaluates its tile's pairs front to back up
    to and including the one that would take it below the 1e-4 cutoff, and
    a pair contributes when it passes the tests before that."""
    from animatablegaussians_torch.ops.rasterize import blend
    P = blend.TILE * blend.TILE
    lp = torch.arange(P, device=rows.device)
    n_eval = n_contrib = 0
    with torch.no_grad():
        for tb, _, kmask, _, geo in blend._batches(rows, gid, starts,
                                                    grid_x):
            _, pexc, contrib, _ = blend._transmittance(geo["alpha"],
                                                       geo["use"])
            px = (tb % grid_x * blend.TILE)[:, None] + lp[None] % blend.TILE
            py = (tb // grid_x * blend.TILE)[:, None] + lp[None] // blend.TILE
            inside = ((px < img_w) & (py < img_h))[:, :, None]
            n_eval += int((inside & kmask[:, None, :]
                           & (pexc >= blend.T_EPS)).sum())
            n_contrib += int((inside & contrib).sum())
    return n_eval, n_contrib


def param_groups(net) -> dict:
    """Top-level parameter group -> its parameters (name, tensor)."""
    groups = {}
    for name, p in net.named_parameters():
        groups.setdefault(name.split(".")[0], []).append((name, p))
    return groups


def grad_snapshot(net) -> dict:
    return {name: p.grad.detach().clone() for name, p in
            net.named_parameters() if p.grad is not None}


def splat_inputs(net, items):
    """The slice's posed Gaussians for the kernel phases: the fixture's
    zeroed position/other heads leave the create_from_pcd attributes, so
    these are exactly what the render splats, skinned to the frame's pose;
    colours are uniform from a seeded generator."""
    g = net.cano_gaussian
    gen = torch.Generator(device=g.xyz.device).manual_seed(1)
    vals = dict(positions=g.xyz, rotations=g.get_rotation)
    vals = net.transform_cano2live(vals, items)
    colors = torch.rand((net.n_points, 3), generator=gen,
                        device=g.xyz.device)
    return (vals["positions"], g.get_scaling, vals["rotations"],
            g.get_opacity.reshape(-1), colors)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from animatablegaussians_torch.ops.rasterize import api, binning
    from animatablegaussians_torch.ops.rasterize.blend import (
        TILE, blend_backward, blend_backward_plain, blend_tiles,
        blend_tiles_plain)
    from animatablegaussians_torch.ops.rasterize.expand import (
        expand_pairs, expand_pairs_plain)
    from animatablegaussians_torch.ops.rasterize.preprocess import \
        preprocess
    from animatablegaussians_torch.tools import render_fixture as rf
    from animatablegaussians_torch.training import avatar_trainer as at
    from animatablegaussians_torch.training import lpips as tlp
    from animatablegaussians_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    phase("device", f"{kind}; nvidia-smi: {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(card)

    cuda_build.load()
    info = cuda_build.build_info
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    phase("build", f"{info['seconds']:.2f} s -> {info['path']}")
    for ln in ptxas:
        phase("build", ln)

    t0 = time.perf_counter()
    net, train_items = rf.build(dev, keys=rf.TRAIN_KEYS)
    items = {k: train_items[k] for k in rf.RENDER_KEYS}
    torch.cuda.synchronize()
    phase("fixture", f"{net.n_points} Gaussians ({net.n_valid} masked "
          f"texels), {rf.IMG_W}x{rf.IMG_H}, built in "
          f"{time.perf_counter() - t0:.1f} s")
    W, H = rf.IMG_W, rf.IMG_H
    gx, gy = -(-W // TILE), -(-H // TILE)
    n_pts = net.n_points
    records = []

    # -- 3. pair expansion: kernel vs plain -------------------------------
    with torch.no_grad():
        means3d, scales, rots, opac, colors = splat_inputs(net, items)
        intr, extr = items["intr"], items["extr"]
        vm, pm = api._full_projection(extr, intr, W, H)
        pre = preprocess(means3d, scales, rots, vm, pm,
                         W / (2.0 * intr[0, 0]), H / (2.0 * intr[1, 1]),
                         W, H)
        valid = pre.valid & net.valid
        radii = torch.where(net.valid, pre.radii,
                            torch.zeros_like(pre.radii))
        rect, offs = binning.pair_counts(pre.means2d, radii, valid, gx, gy)
        total = int(offs[-1])
        depth = pre.depths.contiguous()
        k_keys, k_gids = expand_pairs(rect, depth, offs, total, gx)
        p_keys, p_gids = expand_pairs_plain(rect, depth, offs, total, gx)
        torch.cuda.synchronize()
        expand_err = max(int((k_keys - p_keys).abs().max()),
                         int((k_gids - p_gids).abs().max())) if total else 0
        if expand_err != 0:
            raise AssertionError("expand kernel slots differ from plain")
        kb = binning.bin_gaussians(pre.means2d, pre.depths, radii, valid,
                                   W, H, TILE)
        pb = binning.bin_gaussians(pre.means2d, pre.depths, radii, valid,
                                   W, H, TILE, plain=True)
        if not (torch.equal(kb.gid, pb.gid)
                and torch.equal(kb.starts, pb.starts)
                and kb.n_pairs == pb.n_pairs == total):
            raise AssertionError("sorted pairs or tile ranges differ")
        phase("expand", f"{total} pairs: slots, sorted gids and {gx * gy} "
              "tile ranges equal to the plain version")
        splat_ms = {
            "preprocess + pack rows": cuda_ms(lambda: api._pack_rows(
                preprocess(means3d, scales, rots, vm, pm,
                           W / (2.0 * intr[0, 0]), H / (2.0 * intr[1, 1]),
                           W, H), opac, colors), 5),
            "binning (counts, host sync, expand kernel, sort, ranges)":
                cuda_ms(lambda: binning.bin_gaussians(
                    pre.means2d, pre.depths, radii, valid, W, H, TILE), 5)}
        # rect, depth and offsets in; one key and one gid out per pair
        b_ms, b_by = bound(n_pts * (16 + 4) + (n_pts + 1) * 8 + total * 12)
        records.append(dict(
            name="expand_pairs", route="cuda",
            source="animatablegaussians_torch/csrc/expand.cu",
            replaces="animatablegaussians_tpu/ops/rasterize/expand_pallas.py"
                     ":62 (_expand_kernel)",
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            max_abs_err=float(expand_err),
            ms=cuda_ms(lambda: expand_pairs(rect, depth, offs, total, gx),
                       20),
            plain_ms=cuda_ms(lambda: expand_pairs_plain(rect, depth, offs,
                                                        total, gx), 5)))

        # -- 4. tile blend: kernel vs plain -------------------------------
        opac_v = torch.where(valid, opac, torch.zeros_like(opac))
        rows = api._pack_rows(pre._replace(valid=valid), opac_v, colors)
        args = (rows, kb.gid, kb.starts, gx, gy, W, H)
        k_out = blend_tiles(*args)
        p_out = blend_tiles_plain(*args)
        torch.cuda.synchronize()
        errs = {n: float((k - p).abs().max()) for n, k, p in
                zip(("color", "depth", "alpha"), k_out, p_out)}
        phase("blend", "max |kernel - plain|: " + ", ".join(
            f"{n} {e:.3e} (atol {ATOL_BLEND[n]:g})" for n, e in errs.items()))
        bad = {n: e for n, e in errs.items() if not e <= ATOL_BLEND[n]}
        if bad:
            raise AssertionError(f"blend kernel disagrees: {bad}")
        n_eval, n_contrib = pair_work(rows, kb.gid, kb.starts, gx, W, H)
        phase("blend", f"this frame's blend work: {n_eval} (pixel, pair) "
              f"evaluations, {n_contrib} contributions")
        # rows, gids and ranges in; colour, depth and T_final out
        b_ms, b_by = bound(n_pts * 40 + total * 4 + (gx * gy + 1) * 8
                           + W * H * 5 * 4,
                           n_eval * OPS_EVAL + n_contrib * OPS_FWD_CONTRIB)
        records.append(dict(
            name="blend_tiles", route="cuda",
            source="animatablegaussians_torch/csrc/blend.cu",
            replaces="animatablegaussians_tpu/ops/rasterize/blend_pallas.py"
                     ":282 (_fwd_chunk_kernel) and :114 (_fwd_kernel)",
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            max_abs_err=max(errs.values()),
            ms=cuda_ms(lambda: blend_tiles(*args), 20),
            plain_ms=cuda_ms(lambda: blend_tiles_plain(*args), 3, 1)))
        splat_ms["blend kernel"] = records[-1]["ms"]

        # -- 5. backward tile blend: kernel vs plain ----------------------
        gen = torch.Generator(device=dev).manual_seed(2)
        cots = (torch.randn((H, W, 3), generator=gen, device=dev),
                torch.randn((H, W), generator=gen, device=dev),
                torch.randn((H, W), generator=gen, device=dev))
        bargs = args + tuple(k_out) + cots
        g_k = blend_backward(*bargs)
        g_k2 = blend_backward(*bargs)
        g_p = blend_backward_plain(*bargs)
        torch.cuda.synchronize()
        scale = g_p.abs().amax(dim=0)
        rel = ((g_k - g_p).abs().amax(dim=0) / scale).tolist()
        chans = ("x", "y", "ca", "cb", "cc", "op", "r", "g", "b", "depth")
        phase("blend_bwd", "max |kernel - plain| / max |plain| per channel: "
              + ", ".join(f"{c} {e:.2e}" for c, e in zip(chans, rel))
              + f" (limit {RTOL_BLEND_BWD:g}); two kernel runs differ by "
              f"{float((g_k - g_k2).abs().max()):.2e} (atomics' order)")
        if not (min(scale.tolist()) > 0 and max(rel) <= RTOL_BLEND_BWD):
            raise AssertionError(f"blend backward kernel disagrees: {rel}")
        # rows, gids, ranges, three totals and three cotangents in;
        # grad_rows out
        b_ms, b_by = bound(n_pts * 40 * 2 + total * 4 + (gx * gy + 1) * 8
                           + W * H * 5 * 4 * 2,
                           n_eval * OPS_EVAL + n_contrib * OPS_BWD_CONTRIB)
        records.append(dict(
            name="blend_backward", route="cuda",
            source="animatablegaussians_torch/csrc/blend_bwd.cu",
            replaces="animatablegaussians_tpu/ops/rasterize/blend_pallas.py"
                     ":338 (_bwd_chunk_kernel) and :170 (_bwd_kernel)",
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            max_abs_err=float((g_k - g_p).abs().max()),
            ms=cuda_ms(lambda: blend_backward(*bargs), 20),
            plain_ms=cuda_ms(lambda: blend_backward_plain(*bargs), 3, 1)))
        phase("blend_bwd", f"kernel {records[-1]['ms']:.3f} ms, plain "
              f"{records[-1]['plain_ms']:.3f} ms, bound "
              f"{records[-1]['bound_ms']:.3f} ms ({b_by})")
        del k_keys, k_gids, p_keys, p_gids, kb, pb, k_out, p_out
        del g_k, g_k2, g_p, bargs, cots

    # -- 6. the full-width slice through both kernels ---------------------
    seq = rf.sequence(items, FRAMES)
    kw = dict(bg_color=(1.0, 1.0, 1.0), img_w=W, img_h=H)
    expand_pairs.launches = 0
    blend_tiles.launches = 0
    out = net.render(items, **kw)
    out_seq = net.render_sequence(seq, **kw)
    torch.cuda.synchronize()
    launches = {"expand_pairs": expand_pairs.launches,
                "blend_tiles": blend_tiles.launches}
    phase("slice", f"kernel launches in render + {FRAMES}-frame "
          f"render_sequence: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    for name, o in (("render", out), ("render_sequence", out_seq)):
        for k in ("rgb_map", "mask_map", "depth_map"):
            if not torch.isfinite(o[k]).all():
                raise AssertionError(f"{name} {k} has non-finite values")
        cov = float((o["mask_map"] > 0.5).float().mean())
        phase("slice", f"{name}: rgb {tuple(o['rgb_map'].shape)}, mask "
              f"coverage {cov:.4f}")
        if not cov > 0:
            raise AssertionError(f"{name}: empty mask")
    if tuple(out_seq["rgb_map"].shape) != (FRAMES, H, W, 3):
        raise AssertionError(f"bad sequence shape {out_seq['rgb_map'].shape}")

    pg = out["posed_gaussians"]
    bg = torch.ones(3, device=dev)
    ref = api.render(pg["positions"], pg["scales"], pg["rotations"],
                     pg["opacity"].reshape(-1), pg["colors"], bg, extr, intr,
                     W, H, valid_mask=net.valid, plain=True)
    errs = {"color": float((out["rgb_map"] - ref["render"]).abs().max()),
            "depth": float((out["depth_map"] - ref["depth"]).abs().max()),
            "alpha": float((out["mask_map"] - ref["mask"]).abs().max())}
    phase("slice", "frame 0, kernel path vs plain path: " + ", ".join(
        f"{n} {e:.3e} (atol {ATOL_BLEND[n]:g})" for n, e in errs.items()))
    if any(not e <= ATOL_BLEND[n] for n, e in errs.items()):
        raise AssertionError(f"kernel path disagrees with plain: {errs}")
    n_pairs = out["n_pairs"]
    rel = abs(n_pairs - JAX_N_PAIRS) / JAX_N_PAIRS
    phase("slice", f"n_pairs {n_pairs} vs JAX {JAX_N_PAIRS} "
          f"({100 * rel:.3f}% apart, limit 1%)")
    if rel > 0.01:
        raise AssertionError("n_pairs differs from the JAX package by >1%")

    small, small_items = rf.build(dev, map_h=64, img_w=128, img_h=128,
                                  channel_max=32)
    g_out = small.render(small_items, img_w=128, img_h=128)
    c_out = small.to("cpu").render(
        {k: v.cpu() for k, v in small_items.items()}, img_w=128, img_h=128)
    err = max(float((g_out[k].cpu() - c_out[k]).abs().max())
              for k in ("rgb_map", "mask_map", "depth_map"))
    phase("slice", f"small fixture, GPU kernels vs CPU plain path: max "
          f"|diff| {err:.3e} (atol {ATOL_CPU:g}), n_pairs "
          f"{g_out['n_pairs']} vs {c_out['n_pairs']}")
    if not err <= ATOL_CPU:
        raise AssertionError("GPU render disagrees with the CPU path")
    del small

    # -- 7. timing ---------------------------------------------------------
    t_render = wall_ms(lambda: net.render(items, **kw), 5)
    t_seq = [t / FRAMES for t in
             wall_ms(lambda: net.render_sequence(seq, **kw), 3)]
    phase("timing", f"render: median {statistics.median(t_render):.2f} "
          f"ms/frame over {len(t_render)} runs "
          f"{['%.2f' % t for t in t_render]}")
    phase("timing", f"render_sequence ({FRAMES} frames): median "
          f"{statistics.median(t_seq):.2f} ms/frame over {len(t_seq)} runs "
          f"{['%.2f' % t for t in t_seq]}")
    for r in records:
        phase("timing", f"{r['name']}: kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms at the slice's shapes ({card})")

    # -- 8. profile: where one render's time goes -------------------------
    for name, ms in stage_ms(net, items, kw).items():
        phase("profile", f"render stage {name}: {ms:.3f} ms")
    for name, ms in splat_ms.items():
        phase("profile", f"  splat sub-stage {name}: {ms:.3f} ms")
    print_profile("render", *device_profile(lambda: net.render(items, **kw)),
                  statistics.median(t_render))
    del out, out_seq, seq, pg, ref

    # -- 9. the train step --------------------------------------------------
    lpips = tlp.LPIPS(tlp.init_random(rf.LPIPS_SEED), device=dev)
    tkw = dict(loss_weight=rf.LOSS_WEIGHT, lpips=lpips,
               patch_size=rf.PATCH_SIZE, img_w=W, img_h=H)
    state = at.make_train_state(net, rf.LR_INIT, rf.ITER_NUM)
    step = at.make_train_step(net, **tkw)
    step_plain = at.make_train_step(net, plain=True, **tkw)
    n_steps = WARMUP_STEPS + TIMED_STEPS
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = [at.make_draws(gen, n_pts) for _ in range(n_steps + 1)]

    t_plain = step_plain.loss_and_grads(state, train_items, draws[0])
    g_plain = grad_snapshot(net)
    t_kern = step.loss_and_grads(state, train_items, draws[0])
    g_kern = grad_snapshot(net)
    net.zero_grad(set_to_none=True)
    loss_err = {k: abs(float(t_kern[k]) - float(t_plain[k]))
                / max(abs(float(t_plain[k])), 1e-30) for k in t_plain}
    phase("train", "step 0, kernel path vs plain path, loss terms: "
          + ", ".join(f"{k} {float(t_kern[k]):.6f} (rel {e:.1e})"
                      for k, e in loss_err.items())
          + f" (limit {RTOL_LOSS:g})")
    grad_err = {}
    for group, named in param_groups(net).items():
        names = [n for n, _ in named if n in g_plain]
        if sorted(names) != sorted(n for n, _ in named if n in g_kern):
            raise AssertionError(f"{group}: the two paths reach different "
                                 "parameters")
        if not names:       # a group the loss does not reach
            continue
        a = torch.cat([g_kern[n].reshape(-1) for n in names])
        b = torch.cat([g_plain[n].reshape(-1) for n in names])
        grad_err[group] = float((a - b).norm() / b.norm())
    phase("train", "step 0, relative gradient error per group: " + ", ".join(
        f"{g} {e:.2e}" for g, e in grad_err.items())
        + f" (limit {RTOL_GRAD:g})")
    if not (max(loss_err.values()) <= RTOL_LOSS
            and max(grad_err.values()) <= RTOL_GRAD):
        raise AssertionError(f"train step: kernel path disagrees with plain: "
                             f"{loss_err} {grad_err}")
    del g_plain, g_kern

    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    for fn in (expand_pairs, blend_tiles, blend_backward):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, t_step = [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, terms = step(state, train_items, draws[i])
        torch.cuda.synchronize()
        if i >= WARMUP_STEPS:
            t_step.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in terms.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {"expand_pairs": expand_pairs.launches,
                "blend_tiles": blend_tiles.launches,
                "blend_backward": blend_backward.launches}
    phase("train", f"kernel launches in {n_steps} train steps: {launches}")
    if (blend_backward.launches != n_steps
            or min(launches.values()) == 0):
        raise AssertionError(f"train path kernel launches {launches}, want "
                             f"blend_backward == {n_steps} and none 0")
    for r in records:
        r["launches"] = launches[r["name"]]
    for i, t in enumerate(losses):
        phase("train", f"step {i}: " + ", ".join(
            f"{k} {v:.6f}" for k, v in t.items()))
        if not all(math.isfinite(v) for v in t.values()):
            raise AssertionError(f"train step {i}: non-finite loss {t}")
    # every group with a gradient (cano_gaussian's features are unused)
    moved = {g: max(float((p.detach() - before[n]).abs().max())
                    for n, p in named if p.numel()
                    and not n.startswith("cano_gaussian.features"))
             for g, named in param_groups(net).items() if g in grad_err}
    phase("train", "largest parameter change per group: " + ", ".join(
        f"{g} {m:.2e}" for g, m in moved.items()))
    if not min(moved.values()) > 0:
        raise AssertionError(f"a parameter group did not move: {moved}")
    del before
    step_med = statistics.median(t_step)
    phase("train", f"median {step_med:.2f} ms/step over {len(t_step)} "
          f"steps {['%.2f' % t for t in t_step]} after {WARMUP_STEPS} "
          f"warm-up; peak memory {peak_gb:.2f} GiB ({card})")
    print_profile("train step", *device_profile(
        lambda: step(state, train_items, draws[-1])), step_med)
    for name, ms in train_stage_ms(net, state, train_items, draws[-1],
                                   tkw).items():
        phase("profile", f"train stage {name}: {ms:.3f} ms")
    gen = torch.Generator(device=dev).manual_seed(3)
    crops = [torch.rand((1, rf.PATCH_SIZE, rf.PATCH_SIZE, 3), generator=gen,
                        device=dev) for _ in range(2)]
    crops[0].requires_grad_(True)
    phase("profile", "  of which LPIPS on two 512^2 crops, forward + "
          f"backward: {cuda_ms(lambda: lpips(*crops).sum().backward(), 5):.3f}"
          " ms")
    del state, step, step_plain, draws

    # -- 10. the pretrain step ---------------------------------------------
    pstate = at.make_train_state(net, rf.LR_INIT, rf.ITER_NUM)
    pstep = at.make_pretrain_step(net)
    pose = train_items["smpl_pos_map"][..., :3]
    for i in range(2):
        pstate, pterms = pstep(pstate, pose)
        vals = {k: float(v) for k, v in pterms.items()}
        phase("pretrain", f"step {i}: " + ", ".join(
            f"{k} {v:.6e}" for k, v in vals.items()))
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"pretrain step {i}: non-finite loss")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
