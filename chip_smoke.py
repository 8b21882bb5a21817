"""GPU smoke run of the PyTorch / CUDA port: the novel-pose render path,
the avatar train step, and the CNN's separable FIRs through their kernel in
the render (with mean hands and pose-map regeneration) and in the B = 2
batched train step and its scan.

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
                render and one 4-frame render_sequence through the forward
                kernels (launch counters > 0; the FIR kernel once per FIR
                of the three heads, none left to F.conv2d), finite output,
                mask coverage > 0, both against the plain path
                (``plain=True``: the CNN's FIRs and the splat through the
                kernels' plain versions), n_pairs within 1% of the
                1,291,771 the JAX package bins on the same fixture, and a
                small fixture against the CPU path;
  7. timing   - median ms/frame of render and render_sequence, each kernel
                against its plain version (CUDA events, after warm-up;
                the kernels' device time as phase 11 reads it);
  8. profile  - where one render's time goes: median ms of its stages
                (CUDA events between them), the splat's sub-stages, and the
                device's busy time under torch.profiler against the median
                wall time, with the largest device items and the ops that
                launched the four largest;
  9. train    - the full-width train step with the bench's settings
                (tools/render_fixture.py): step 0's loss terms and
                gradients through the kernels against the plain path, then
                2 warm-up and 5 timed steps through the kernels (launch
                counters reset just before: the backward blend must run
                once per step, the FIR kernel once per FIR of the forward
                and once per FIR whose input carries a gradient, and the
                JSON record's launches are these),
                median ms/step, peak memory, the device's busy share of one
                step with its largest items and their launching ops, the
                step's forward / backward / Adam split (CUDA events) and
                LPIPS's share, finite losses, moved parameters;
 10. pretrain - two full-width pretrain steps, finite losses;
 11. fir      - the FIR kernel (csrc/fir.cu) against its plain version at
                every distinct FIR of one train forward, forward (bitwise)
                and backward (the autograd VJP, max |kernel - plain| / max
                |plain|); per call and summed per direction, the kernel's
                device time (CUDA events around calls queued behind a
                sleep kernel), its time launch to launch (CUDA events over
                back-to-back calls) and the host's time per call, the library
                call's device and launch-to-launch times (a depthwise
                F.conv2d, or F.conv_transpose2d at up = 2), the plain
                version's, and the bound (input + output bytes over the
                memory rate);
 12. fir_path - render, render_sequence and the B = 1 train step with the
                FIRs through the kernel against the same calls with them
                through the library call (swapped in here, never in the
                port): images, step 0's loss terms and gradients, wall
                times both ways (interleaved) and the device's busy time
                both ways (torch.profiler);
 13. hands    - generate_mean_hands on the fixture's pose map (kernel path
                against plain path), a render with the mean hands through
                the kernels against the plain path, the blend's weights,
                and a render from the pose map get_pose_map regenerates
                with the points the mean hands move;
 14. train_b2 - the B = 2 batched train step through the kernels: step 0
                against the plain path, ms/step (launch counters reset just
                before: the FIR record's launches are these steps'), peak
                memory, and make_train_scan_batched over 3 steps, each on
                its own batch, against the host loop of the same steps,
                beside two planted faults (a scan that never updates, one
                that trains every step on the first batch) that the limit
                must catch.

Each kernel's record carries its bound: the least time the card could take
for the same work, the larger of the bytes it must move over the memory
rate and the operations it must do, counted from this run's data, over the
FP32 rate (the H100 SXM data sheet figures below). The line before the last
is the kernels' JSON record; the last line is ``{"ok": true, "device":
{...}}``. TF32 is off for matmuls and convs.
"""

from __future__ import annotations

import contextlib
import functools
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
# order, the kernel sums each pair's pixels with warp shuffles and a sum
# over the tile's warps, then across tiles with atomics in an order that
# varies from run to run, and the suffix term (total - prefix)
# cancels before it is divided by 1 - alpha
RTOL_BLEND_BWD = 1e-3
# step 0 through the kernels vs through the plain versions (phases 9 and 14)
# or with the FIRs through the library call (phase 12): loss terms, and each
# parameter group's gradient as a relative L2 error. Beyond the blend's
# differences above, carried back through the CNN heads, the card is not
# deterministic run to run: an L1 residual within rounding of 0 takes the
# other sign, LPIPS's max pools route a near-tie to the other input, and
# cuDNN's transposed and backward convs sum in a run-dependent order; each
# such event moves the gradients of the few Gaussians under one pixel. On
# the H100 the groups read <= 6e-5 without such an event and 4.9e-4 to
# 1.8e-3 in cano_gaussian with one, at B = 1 (phases 9 and 12) and B = 2
# (phase 14) alike; the same path run twice differed by up to 4e-3 in
# LPIPS's part of that gradient
RTOL_LOSS = 1e-5
RTOL_GRAD = 1e-2
WARMUP_STEPS, TIMED_STEPS = 2, 5
# the sleep kernel that holds the card while the host queues the calls
# device_ms times (~25-30 ms of an H100's SM clock)
SLEEP_CYCLES = 50_000_000
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
# FIR kernel vs its plain version, relative to the largest |plain| of the
# call: forward, the same products and sums in the same order
# (-fmad=false); backward, the plain side is autograd through its slices,
# which adds each input element's terms in another order
RTOL_FIR = 1e-5
# the paths with the FIRs through the kernel against through the library
# call (phases 12 and 13's mean hands): the kernel's taps are the SVD
# factors, whose outer product differs from the 2-D kernel by ~1e-8, and
# the sums run in another order, ~1e-7 relative per FIR; this fixture's
# position/other heads output exactly zero, so only the colours can move,
# by the colour head's rounding
ATOL_FIR_IMG = 1e-4
TRAIN_B = 2
B2_WARMUP, B2_TIMED, SCAN_STEPS = 2, 3, 3
# scan against host loop on the card, per step's loss terms: the same steps
# on the same batches and draws, but the blend's atomics and the events of
# RTOL_GRAD make every run's update differ a little. On the H100 two host
# loops read 4.5e-6 to 7.3e-5 apart, and the planted faults 1.7e-1 (a scan
# that never updates) and 1.3e-1 (every step on the first batch); the limit
# sits near the middle of the two on a log scale, and each run prints all
# four. The parameters are not held to a limit: Adam moves an element by
# about lr whatever its gradient, so an element whose gradient is within
# that noise of 0 moves either way, and two host loops differ by up to ~4 lr
SCAN_RTOL_LOSS = 1e-3


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


def fir_count(net) -> tuple:
    """(FIRs a forward of the three heads runs, of them on a tensor that
    carries a gradient in a train step), from the heads' structure: per
    head conv_in's pre-blur and each FromRGB's downsample (both on the pose
    map, so no gradient), each ConvBlock's pre-blur, and per decoder branch
    each up-conv's post-blur and each ToRGB's wavelet upsample but the
    first's. The FIR kernel launching this often leaves none to F.conv2d."""
    n_fwd = n_grad = 0
    for head in (net.position_net, net.other_net, net.color_net):
        grad = len(head.cond_convs) + 2 * (len(head.convs1) // 2
                                           + len(head.to_rgbs1) - 1)
        n_fwd += 1 + len(head.from_rgbs) + grad
        n_grad += grad
    return n_fwd, n_grad


@contextlib.contextmanager
def fir_calls():
    """Records each launch of the FIR kernel in the block, through
    ``ops/fir.py::_launch``: (input shape, taps, up, down, pad), and
    whether the input carries a gradient."""
    from animatablegaussians_torch.ops import fir
    inner, calls = fir._launch, []

    def recorded(x, kv, kh, up, down, pad):
        calls.append(((tuple(x.shape), tuple(kv), tuple(kh), up, down,
                       tuple(pad)), x.requires_grad))
        return inner(x, kv, kh, up, down, pad)

    fir._launch = recorded
    try:
        yield calls
    finally:
        fir._launch = inner


@functools.lru_cache(maxsize=None)
def _library_weight(kv, kh, flip: bool, c: int, device):
    """The depthwise weight (C, 1, kh, kw) of ``fir_library``, made on the
    device once per call shape: a copy from the host on every call would
    wait for the card and time the wait, not the convolution."""
    if flip:
        kv, kh = kv[::-1], kh[::-1]
    w = torch.outer(torch.tensor(kv), torch.tensor(kh)).to(device)
    return w[None, None].expand(c, 1, len(kv), len(kh)).contiguous()


def fir_library(x, kv, kh, up, down, pad):
    """The resampling of ``ops/fir.py::upfirdn2d_fir`` as one PyTorch call,
    for the calls the CNN makes: a depthwise F.conv2d (up = 1, even pads;
    it correlates, so the taps are reversed) or F.conv_transpose2d (up = 2,
    down = 1; a true convolution of the stuffed input, cropped by the pads'
    complement). The yardstick, never called by the port."""
    px0, px1, py0, py1 = pad
    c = x.shape[1]
    if up == 1 and px0 == px1 >= 0 and py0 == py1 >= 0:
        return torch.nn.functional.conv2d(
            x, _library_weight(kv, kh, True, c, x.device), stride=down,
            padding=(py0, px0), groups=c)
    crop = (len(kv) - 1 - py0, len(kh) - 1 - px0)
    extra = (py1 - py0 + 1, px1 - px0 + 1)
    if up == 2 and down == 1 and min(crop) >= 0 and set(extra) <= {0, 1}:
        return torch.nn.functional.conv_transpose2d(
            x, _library_weight(kv, kh, False, c, x.device), stride=2,
            padding=crop, output_padding=extra, groups=c)
    raise AssertionError(f"no one-call library yardstick for up {up}, down "
                         f"{down}, pad {pad}")


@contextlib.contextmanager
def fir_through_library():
    """The port's FIRs through ``fir_library`` for the block (phase 12's
    path-level comparison)."""
    from animatablegaussians_torch.ops import fir
    inner = fir.upfirdn2d_fir
    fir.upfirdn2d_fir = fir_library
    try:
        yield
    finally:
        fir.upfirdn2d_fir = inner


def compare_images(a: dict, b: dict, atol: float) -> dict:
    errs = {"color": float((a["rgb_map"] - b["rgb_map"]).abs().max()),
            "depth": float((a["depth_map"] - b["depth_map"]).abs().max()),
            "alpha": float((a["mask_map"] - b["mask_map"]).abs().max())}
    if not all(e <= atol for e in errs.values()):
        raise AssertionError(f"images disagree beyond {atol:g}: {errs}")
    return errs


def grad_errors(net, g_a: dict, g_b: dict) -> dict:
    """Relative L2 error of ``g_a`` against ``g_b`` per parameter group;
    groups the loss does not reach are left out, and both must reach the
    same parameters."""
    out = {}
    for group, named in param_groups(net).items():
        names = [n for n, _ in named if n in g_b]
        if sorted(names) != sorted(n for n, _ in named if n in g_a):
            raise AssertionError(f"{group}: the two paths reach different "
                                 "parameters")
        if names:
            a = torch.cat([g_a[n].reshape(-1) for n in names])
            b = torch.cat([g_b[n].reshape(-1) for n in names])
            out[group] = float((a - b).norm() / b.norm())
    return out


def device_ms(fn, reps: int) -> float:
    """Mean device time of what one call of ``fn`` launches: CUDA events
    around ``reps`` back-to-back calls that the host enqueues while a sleep
    kernel holds the card, so the events time the card's work and not the
    host's (after a warm-up call). Raises if the enqueue outlasted the
    sleep, which would let host time in."""
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ev[2].record()
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep = ev[0].elapsed_time(ev[1])
    if not host < sleep:
        raise RuntimeError(f"device_ms: the host took {host:.3f} ms to "
                           f"enqueue, longer than the {sleep:.3f} ms sleep")
    return ev[1].elapsed_time(ev[2]) / reps


def host_ms(fn, reps: int) -> float:
    """Mean host time of one call of ``fn``: the enqueue rate of ``reps``
    calls after a synchronize (the card keeps up with the small calls, so
    this is the wrapper's own cost and the launch's)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def fir_phase(calls, card: str, dev) -> dict:
    """Phase 11: the FIR kernel against its plain version and the library
    call at each distinct call of ``calls`` (``fir_calls`` records of one
    train forward), forward and backward (the autograd VJP of a call whose
    input carries a gradient). For each: the forward bitwise against the
    plain version, the backward within RTOL_FIR; the kernel's device time
    (``device_ms``), its time launch to launch (CUDA events over 20
    back-to-back calls, which include the host's cost where the card
    waits for it), the host's time per call, the plain version's and the
    library call's times and the bound. Returns the kernel's JSON record:
    sums over the forward's calls and, for the ``bwd_`` keys, over the
    calls whose input carries a gradient."""
    from animatablegaussians_torch.ops.fir import (grad_pads, upfirdn2d_fir,
                                                   upfirdn2d_fir_plain)
    counts = {}
    for key, grad in calls:
        n, n_grad = counts.get(key, (0, 0))
        counts[key] = (n + 1, n_grad + int(grad))
    gen = torch.Generator(device=dev).manual_seed(4)
    names = ("ms", "device_ms", "host_ms", "plain_ms", "library_ms",
             "library_device_ms", "bound_ms")
    tot = dict.fromkeys(names, 0.0)
    tot_bwd = dict.fromkeys(names, 0.0)
    worst = 0.0
    for (shape, kv, kh, up, down, pad), (n, n_grad) in counts.items():
        x = torch.randn(shape, generator=gen, device=dev)
        args = (kv, kh, up, down, pad)
        yk, yp = upfirdn2d_fir(x, *args), upfirdn2d_fir_plain(x, *args)
        yl = fir_library(x, *args)
        fwd_abs = float((yk - yp).abs().max())
        lib_err = float((yl - yp).abs().max() / yp.abs().max())
        g = torch.randn(yk.shape, generator=gen, device=dev)
        xs = [x.clone().requires_grad_(True) for _ in range(3)]
        outs = [upfirdn2d_fir(xs[0], *args),
                upfirdn2d_fir_plain(xs[1], *args), fir_library(xs[2], *args)]
        gk, gp, gl = (torch.autograd.grad(o, xi, g, retain_graph=True)[0]
                      for o, xi in zip(outs, xs))
        bwd_abs = float((gk - gp).abs().max())
        bwd_err = bwd_abs / float(gp.abs().max())
        worst = max(worst, fwd_abs, bwd_abs)
        if not (torch.equal(yk, yp) and bwd_err <= RTOL_FIR):
            raise AssertionError(f"FIR kernel disagrees with plain at "
                                 f"{shape} {pad}: forward max |diff| "
                                 f"{fwd_abs} (want 0), backward {bwd_err}")
        fwd = [lambda: upfirdn2d_fir(x, *args),
               lambda: upfirdn2d_fir_plain(x, *args),
               lambda: fir_library(x, *args)]
        bwd = [lambda o=o, xi=xi: torch.autograd.grad(o, xi, g,
                                                      retain_graph=True)
               for o, xi in zip(outs, xs)]
        t = {}
        for d, fns in (("fwd", fwd), ("bwd", bwd)):
            t[d] = dict(ms=cuda_ms(fns[0], 20),
                        device_ms=device_ms(fns[0], 10),
                        host_ms=host_ms(fns[0], 20),
                        plain_ms=cuda_ms(fns[1], 5),
                        library_ms=cuda_ms(fns[2], 20),
                        library_device_ms=device_ms(fns[2], 10))
        t["fwd"]["bound_ms"] = bound((x.numel() + yk.numel()) * 4)[0]
        t["bwd"]["bound_ms"] = bound((g.numel() + gk.numel()) * 4)[0]
        gpad = grad_pads(shape[2:], len(kv), len(kh), up, down, pad)
        phase("fir", f"{n:2d}x ({n_grad} with a gradient) {tuple(shape)} up "
              f"{up} down {down} pad {pad} -> {tuple(yk.shape[1:])}: fwd "
              f"bitwise equal, library rel err {lib_err:.1e}; bwd (pad "
              f"{gpad}) rel err {bwd_err:.1e}")
        for d in ("fwd", "bwd"):
            v = t[d]
            phase("fir", f"    {d}: kernel device {v['device_ms']:.4f} ms, "
                  f"launch to launch {v['ms']:.4f}, host {v['host_ms']:.4f};"
                  f" library device {v['library_device_ms']:.4f}, launch to "
                  f"launch {v['library_ms']:.4f}; plain {v['plain_ms']:.4f};"
                  f" bound {v['bound_ms']:.4f}")
        for key in names:
            tot[key] += n * t["fwd"][key]
            tot_bwd[key] += n_grad * t["bwd"][key]
    n_grad = sum(int(grad) for _, grad in calls)
    for name, v, k in (("forward", tot, len(calls)),
                       ("backward", tot_bwd, n_grad)):
        phase("fir", f"{k} calls a train {name} ({len(counts)} distinct "
              f"shapes): kernel device {v['device_ms']:.3f} ms, launch to "
              f"launch {v['ms']:.3f}, host {v['host_ms']:.3f}; library "
              f"device {v['library_device_ms']:.3f}, launch to launch "
              f"{v['library_ms']:.3f}; plain {v['plain_ms']:.3f}; bound "
              f"{v['bound_ms']:.3f} ({card})")
    return dict(name="upfirdn2d_fir", route="cuda",
                source="animatablegaussians_torch/csrc/fir.cu",
                replaces="animatablegaussians_tpu/ops/fir_pallas.py:180 "
                         "(_vhfir_kernel; pl.pallas_call at :231)",
                bound_by="bytes", max_abs_err=worst, **tot,
                **{f"bwd_{k}": v for k, v in tot_bwd.items()})


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
    net, train_items = rf.build(dev, keys=rf.TRAIN_KEYS + rf.HAND_KEYS)
    items = {k: train_items[k] for k in rf.RENDER_KEYS}
    # the fixture's weights, restored after the train phases (phase 11 on)
    fixture_state = {k: v.clone() for k, v in net.state_dict().items()}
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
            device_ms=device_ms(lambda: expand_pairs(rect, depth, offs,
                                                     total, gx), 10),
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
            device_ms=device_ms(lambda: blend_tiles(*args), 10),
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
            device_ms=device_ms(lambda: blend_backward(*bargs), 10),
            plain_ms=cuda_ms(lambda: blend_backward_plain(*bargs), 3, 1)))
        phase("blend_bwd", f"kernel {records[-1]['ms']:.3f} ms, plain "
              f"{records[-1]['plain_ms']:.3f} ms, bound "
              f"{records[-1]['bound_ms']:.3f} ms ({b_by})")
        del k_keys, k_gids, p_keys, p_gids, kb, pb, k_out, p_out
        del g_k, g_k2, g_p, bargs, cots

    # -- 6. the full-width slice through the forward kernels ---------------
    from animatablegaussians_torch.ops import fir
    seq = rf.sequence(items, FRAMES)
    kw = dict(bg_color=(1.0, 1.0, 1.0), img_w=W, img_h=H)
    n_fir, n_fir_grad = fir_count(net)
    fwd_kernels = (expand_pairs, blend_tiles, fir.upfirdn2d_fir)
    for fn in fwd_kernels:
        fn.launches = 0
    out = net.render(items, **kw)
    out_seq = net.render_sequence(seq, **kw)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in fwd_kernels}
    phase("slice", f"kernel launches in render + {FRAMES}-frame "
          f"render_sequence: {launches} (FIR: want {n_fir} each, one per "
          "FIR of the three heads)")
    if min(launches.values()) == 0 or launches["upfirdn2d_fir"] != 2 * n_fir:
        raise AssertionError(f"a kernel of the path never ran, or a FIR "
                             f"went around its kernel: {launches}")
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

    refs = (net.render(items, plain=True, **kw),
            net.render_sequence(seq, plain=True, **kw))
    for name, o, ref in zip(("render", "render_sequence"), (out, out_seq),
                            refs):
        errs = {n: float((o[k] - ref[k]).abs().max()) for n, k in
                (("color", "rgb_map"), ("depth", "depth_map"),
                 ("alpha", "mask_map"))}
        phase("slice", f"{name}, kernel path vs plain path: " + ", ".join(
            f"{n} {e:.3e} (atol {ATOL_BLEND[n]:g})" for n, e in errs.items()))
        if any(not e <= ATOL_BLEND[n] for n, e in errs.items()):
            raise AssertionError(f"{name}: kernel path disagrees with plain: "
                                 f"{errs}")
    del refs
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
        phase("timing", f"{r['name']}: kernel {r['ms']:.3f} ms launch to "
              f"launch, {r['device_ms']:.3f} ms device, plain "
              f"{r['plain_ms']:.3f} ms at the slice's shapes ({card})")

    # -- 8. profile: where one render's time goes -------------------------
    for name, ms in stage_ms(net, items, kw).items():
        phase("profile", f"render stage {name}: {ms:.3f} ms")
    for name, ms in splat_ms.items():
        phase("profile", f"  splat sub-stage {name}: {ms:.3f} ms")
    print_profile("render", *device_profile(lambda: net.render(items, **kw)),
                  statistics.median(t_render))
    del out, out_seq, seq

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
    grad_err = grad_errors(net, g_kern, g_plain)
    phase("train", "step 0, relative gradient error per group: " + ", ".join(
        f"{g} {e:.2e}" for g, e in grad_err.items())
        + f" (limit {RTOL_GRAD:g})")
    if not (max(loss_err.values()) <= RTOL_LOSS
            and max(grad_err.values()) <= RTOL_GRAD):
        raise AssertionError(f"train step: kernel path disagrees with plain: "
                             f"{loss_err} {grad_err}")
    del g_plain, g_kern

    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    counted = (expand_pairs, blend_tiles, blend_backward, fir.upfirdn2d_fir)
    for fn in counted:
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
    launches = {fn.__name__: fn.launches for fn in counted}
    want_fir = n_steps * (n_fir + n_fir_grad)
    phase("train", f"kernel launches in {n_steps} train steps: {launches} "
          f"(FIR: want {want_fir}, {n_fir} forward + {n_fir_grad} backward "
          "a step)")
    if (blend_backward.launches != n_steps
            or launches["upfirdn2d_fir"] != want_fir
            or min(launches.values()) == 0):
        raise AssertionError(f"train path kernel launches {launches}, want "
                             f"blend_backward == {n_steps}, upfirdn2d_fir == "
                             f"{want_fir} and none 0")
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
    del pstate, pstep

    # -- 11. the FIR kernel at every distinct FIR of a train forward -------
    # back to the fixture's weights (here and after each phase that trains):
    # the position and other heads output exactly 0 again, so the paths
    # compared below place the Gaussians identically
    net.load_state_dict(fixture_state)
    with fir_calls() as calls:
        net.render(items, training=True, **kw)
    n_grad = sum(int(grad) for _, grad in calls)
    if (len(calls), n_grad) != (n_fir, n_fir_grad):
        raise AssertionError(f"FIR: {len(calls)} launches ({n_grad} with a "
                             f"gradient) in a train forward, want {n_fir} "
                             f"({n_fir_grad})")
    fir_record = fir_phase(calls, card, dev)
    records.append(fir_record)
    del calls

    # -- 12. render, sequence and B = 1 step: FIRs through the kernel vs
    # through the library call
    seq = rf.sequence(items, FRAMES)
    out_k = net.render(items, **kw)
    seq_k = net.render_sequence(seq, **kw)
    with fir_through_library():
        out_l = net.render(items, **kw)
        seq_l = net.render_sequence(seq, **kw)
    for name, a, b in (("render", out_k, out_l),
                       ("render_sequence", seq_k, seq_l)):
        errs = compare_images(a, b, ATOL_FIR_IMG)
        phase("fir_path", f"{name}, FIRs through the kernel vs the library "
              "call: " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f" (atol {ATOL_FIR_IMG:g})")
    del out_k, seq_k, out_l, seq_l
    routes = {"kernel": contextlib.nullcontext, "library": fir_through_library}
    walls = {(name, r): [] for name in ("render", "sequence") for r in routes}
    for i in range(10):                  # kernel, library, library, ...
        for r in (routes if i % 2 == 0 else reversed(list(routes))):
            with routes[r]():
                walls["render", r] += wall_ms(lambda: net.render(items, **kw),
                                              1)
                walls["sequence", r] += [t / FRAMES for t in wall_ms(
                    lambda: net.render_sequence(seq, **kw), 1)]
    for (name, r), t in walls.items():
        phase("fir_path", f"{name}, FIRs through the {r}: median "
              f"{statistics.median(t):.2f} ms/frame over {len(t)} runs "
              f"{['%.2f' % v for v in t]}")
    for r, route in routes.items():
        with route():
            busy = device_profile(lambda: net.render(items, **kw))[0]
        phase("fir_path", f"render, FIRs through the {r}: device busy "
              + ("not measured" if busy is None else f"{busy:.3f} ms"))
    del seq

    state = at.make_train_state(net, rf.LR_INIT, rf.ITER_NUM)
    step = at.make_train_step(net, **tkw)
    gen = torch.Generator(device=dev).manual_seed(5)
    draws = at.make_draws(gen, n_pts)
    with fir_through_library():
        t_lib = step.loss_and_grads(state, train_items, draws)
    g_lib = grad_snapshot(net)
    t_kern = step.loss_and_grads(state, train_items, draws)
    g_kern = grad_snapshot(net)
    net.zero_grad(set_to_none=True)
    loss_err = {k: abs(float(t_kern[k]) - float(t_lib[k]))
                / max(abs(float(t_lib[k])), 1e-30) for k in t_lib}
    grad_err = grad_errors(net, g_kern, g_lib)
    phase("fir_path", "B = 1 step 0, FIRs through the kernel vs the library "
          "call: loss terms " + ", ".join(f"{k} rel {e:.1e}" for k, e in
                                          loss_err.items())
          + f" (limit {RTOL_LOSS:g}); gradients " + ", ".join(
              f"{g} {e:.2e}" for g, e in grad_err.items())
          + f" (limit {RTOL_GRAD:g})")
    if not (max(loss_err.values()) <= RTOL_LOSS
            and max(grad_err.values()) <= RTOL_GRAD):
        raise AssertionError("train step: the kernel route disagrees with "
                             "the library route")
    del g_lib, g_kern
    t_steps = {r: [] for r in routes}
    for i in range(10):
        for r in (routes if i % 2 == 0 else reversed(list(routes))):
            with routes[r]():
                t_steps[r] += wall_ms(lambda: step(state, train_items, draws),
                                      1)
    for r, t in t_steps.items():
        phase("fir_path", f"B = 1 train step, FIRs through the {r}: median "
              f"{statistics.median(t):.2f} ms/step over {len(t)} steps "
              f"{['%.2f' % v for v in t]}")
    for r, route in routes.items():
        with route():
            busy = device_profile(lambda: step(state, train_items, draws))[0]
        phase("fir_path", f"B = 1 train step, FIRs through the {r}: device "
              "busy " + ("not measured" if busy is None else f"{busy:.3f} ms"))
    del state, step

    # -- 13. mean hands and the regenerated pose map ------------------------
    # the mean hands come from the weights phase 12's steps left (at the
    # fixture's, the position and other heads output 0 for any pose map,
    # and the hands would equal every frame's own Gaussians); the renders
    # then run at the fixture's weights with those hands blended in
    hitems = {k: train_items[k] for k in rf.RENDER_KEYS + rf.HAND_KEYS}
    pose = hitems["smpl_pos_map"][..., :3]
    fir.upfirdn2d_fir.launches = 0
    hands = net.generate_mean_hands(pose)
    n_hands = fir.upfirdn2d_fir.launches
    hands_p = net.generate_mean_hands(pose, plain=True)
    hand_err = max(float((hands[k] - hands_p[k]).abs().max()) for k in hands)
    phase("hands", f"generate_mean_hands: {n_hands} FIR launches (want "
          f"{n_fir}); kernel path vs plain path max |diff| {hand_err:.3e} "
          f"(atol {ATOL_FIR_IMG:g})")
    if not (n_hands == n_fir and hand_err <= ATOL_FIR_IMG):
        raise AssertionError("generate_mean_hands: kernel path")
    net.load_state_dict(fixture_state)
    fir.upfirdn2d_fir.launches = 0
    h_kern = net.render(hitems, hand_vals=hands, **kw)
    n_hands = fir.upfirdn2d_fir.launches
    h_plain = net.render(hitems, hand_vals=hands, plain=True, **kw)
    if n_hands != n_fir:
        raise AssertionError(f"mean-hand render: {n_hands} FIR launches")
    w = net.hand_weights(hitems)
    errs = compare_images(h_kern, h_plain, ATOL_FIR_IMG)
    phase("hands", "render(hand_vals), kernel path vs plain path: " + ", ".join(
        f"{n} {e:.3e}" for n, e in errs.items())
        + f" (atol {ATOL_FIR_IMG:g}); {n_hands} FIR launches; blend weight "
          f"> 1e-3 at {int((w > 1e-3).sum())} points, > 0.5 at "
          f"{int((w > 0.5).sum())} of {n_pts}")
    novel = dict(hitems, smpl_pos_map=net.get_pose_map(hitems))
    n_hand = net.render(novel, hand_vals=hands, **kw)
    n_bare = net.render(novel, **kw)
    moved = (n_hand["posed_gaussians"]["positions"]
             - n_bare["posed_gaussians"]["positions"]).norm(dim=1) > 1e-6
    cov = float((n_hand["mask_map"] > 0.5).float().mean())
    phase("hands", f"render from get_pose_map {tuple(novel['smpl_pos_map'].shape)}"
          f" with the mean hands: mask coverage {cov:.4f}, "
          f"{int(moved.sum())} points moved by the mean hands")
    if not (cov > 0 and int(moved.sum()) > 0
            and all(torch.isfinite(n_hand[k]).all() for k in
                    ("rgb_map", "mask_map", "depth_map"))):
        raise AssertionError("render from the regenerated pose map")
    del hands, hands_p, h_kern, h_plain, novel, n_hand, n_bare, w

    # -- 14. the B = 2 batched train step and its scan ----------------------
    net.load_state_dict(fixture_state)
    del fixture_state
    titems = {k: train_items[k] for k in rf.TRAIN_KEYS}
    batch = rf.sequence(titems, TRAIN_B)
    state = at.make_train_state(net, rf.LR_INIT, rf.ITER_NUM)
    step_b = at.make_train_step_batched(net, **tkw)
    step_bp = at.make_train_step_batched(net, plain=True, **tkw)
    gen = torch.Generator(device=dev).manual_seed(6)
    n_b2 = B2_WARMUP + B2_TIMED
    b_draws = [[at.make_draws(gen, n_pts) for _ in range(TRAIN_B)]
               for _ in range(n_b2 + SCAN_STEPS)]
    t_plain = step_bp.loss_and_grads(state, batch, b_draws[0])
    g_plain = grad_snapshot(net)
    fir.upfirdn2d_fir.launches = 0
    t_kern = step_b.loss_and_grads(state, batch, b_draws[0])
    n_step = fir.upfirdn2d_fir.launches
    g_kern = grad_snapshot(net)
    net.zero_grad(set_to_none=True)
    phase("train_b2", f"B = {TRAIN_B} step: {n_step} FIR launches (want "
          f"{n_fir} forward + {n_fir_grad} backward)")
    if n_step != n_fir + n_fir_grad:
        raise AssertionError("batched step FIR launches")
    loss_err = {k: abs(float(t_kern[k]) - float(t_plain[k]))
                / max(abs(float(t_plain[k])), 1e-30) for k in t_plain}
    grad_err = grad_errors(net, g_kern, g_plain)
    phase("train_b2", "step 0, kernel path vs plain path: loss terms " +
          ", ".join(f"{k} {float(t_kern[k]):.6f} (rel {e:.1e})"
                    for k, e in loss_err.items())
          + f" (limit {RTOL_LOSS:g}); gradients " + ", ".join(
              f"{g} {e:.2e}" for g, e in grad_err.items())
          + f" (limit {RTOL_GRAD:g})")
    if not (max(loss_err.values()) <= RTOL_LOSS
            and max(grad_err.values()) <= RTOL_GRAD):
        raise AssertionError("batched step: kernel path disagrees")
    del g_plain, g_kern, step_bp

    for fn in counted:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_b2 = []
    for i in range(n_b2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, terms = step_b(state, batch, b_draws[i])
        torch.cuda.synchronize()
        if i >= B2_WARMUP:
            t_b2.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(v) for k, v in terms.items()}
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"batched step {i}: non-finite {vals}")
    peak_b2 = torch.cuda.max_memory_allocated() / 2 ** 30
    b2_launches = {fn.__name__: fn.launches for fn in counted}
    phase("train_b2", f"kernel launches in {n_b2} B = {TRAIN_B} steps: "
          f"{b2_launches}")
    if not (b2_launches["upfirdn2d_fir"] == n_b2 * (n_fir + n_fir_grad)
            and b2_launches["blend_backward"] == TRAIN_B * n_b2
            and min(b2_launches.values()) > 0):
        raise AssertionError(f"batched path launches {b2_launches}")
    fir_record["launches"] = b2_launches["upfirdn2d_fir"]
    phase("train_b2", f"median {statistics.median(t_b2):.2f} ms/step "
          f"({statistics.median(t_b2) / TRAIN_B:.2f} ms/frame) over "
          f"{len(t_b2)} steps {['%.2f' % t for t in t_b2]} after "
          f"{B2_WARMUP} warm-up; peak memory {peak_b2:.2f} GiB ({card})")
    del state

    # the scan over SCAN_STEPS steps, each on its own B = 2 batch (its own
    # camera jitter) and draws, against the host loop of the same steps from
    # the same weights; a second host loop reads the run-to-run spread, and
    # two planted faults (no update; every step on the first batch) show
    # what the limit catches
    start = {n: p.detach().clone() for n, p in net.named_parameters()}
    batches = [rf.sequence(titems, TRAIN_B, seed=i)
               for i in range(SCAN_STEPS)]
    scan_batch = {k: torch.stack([b[k] for b in batches]) for k in batch}
    scan_draws = b_draws[n_b2:]

    def run(variant):
        with torch.no_grad():
            for n, p in net.named_parameters():
                p.copy_(start[n])
        state = at.make_train_state(net, rf.LR_INIT, rf.ITER_NUM)
        if variant == "scan":
            state, terms = at.make_train_scan_batched(step_b)(
                state, scan_batch, scan_draws)
            if state.iter_idx != SCAN_STEPS:
                raise AssertionError(f"the scan took {state.iter_idx} steps")
            return terms
        seq_terms = []
        for i, d in enumerate(scan_draws):
            b = batches[0] if variant == "first batch" else batches[i]
            if variant == "no update":
                seq_terms.append(step_b.loss_and_grads(state, b, d))
            else:
                state, t = step_b(state, b, d)
                seq_terms.append(t)
        return {k: torch.stack([t[k] for t in seq_terms])
                for k in seq_terms[0]}

    ref = run("host loop")
    gaps = {}
    for variant in ("scan", "host loop again", "no update", "first batch"):
        terms = run(variant)
        gaps[variant] = max(float(((terms[k] - ref[k]).abs()
                                / ref[k].abs().clamp(min=1e-30)).max())
                         for k in ref)
    phase("train_b2", f"{SCAN_STEPS} steps against the host loop, largest "
          "loss-term relative difference: " + ", ".join(
              f"{k} {g:.1e}" for k, g in gaps.items())
          + f" (limit {SCAN_RTOL_LOSS:g}: the first two within, the "
          "planted faults beyond)")
    if not (gaps["scan"] <= SCAN_RTOL_LOSS
            and gaps["host loop again"] <= SCAN_RTOL_LOSS
            and gaps["no update"] > SCAN_RTOL_LOSS
            and gaps["first batch"] > SCAN_RTOL_LOSS):
        raise AssertionError(f"scan against the host loop: {gaps}")
    del start, batches, scan_batch

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
