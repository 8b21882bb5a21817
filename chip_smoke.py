"""GPU smoke run of the PyTorch / CUDA port: the novel-pose render path,
the avatar train step, and the CNN's separable FIRs through their kernel in
the render (with mean hands and pose-map regeneration) and in the B = 2
batched train step and its scan; then the two entry points a user runs,
training and animation, on a full-width capture on disk, and the scoring
of that capture's frames; last, the template stack that prepares a
subject, on a capture of its own.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (CUDA_HOME or PATH); builds the kernels
itself. Phases, each printing a line, any failure exiting non-zero:

  1. device   - the card, its name and power limit (nvidia-smi);
  2. build    - nvcc builds csrc/*.cu for sm_90a (seconds, ptxas report);
  3. expand   - pair-expansion kernel vs its plain version at the slice's
                shapes (531,520 Gaussians, 1500x2048): keys, gids and
                tile ranges must be equal;
  4. blend    - tile-blend kernel vs its plain version on the same pairs,
                and the (pixel, pair) work this frame's data needs: the
                evaluations a walk over every pair makes, those the
                kernel's per-warp cull leaves (its cull box, mirrored in
                torch; no contribution may be culled) and the
                contributions;
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
                must catch;
 15. driver   - the training entry point as a user runs it,
                ``main_avatar_torch.main(["-c", cfg, "-m", "train"])``, on
                a full-width synthetic capture that tools/capture_fixture.py
                writes under build/ (2 cameras x 3 frames of 1500x2048
                JPEGs, map_h 1024 = 531,520 Gaussians, SMPL-X's real
                shapes) with the bench's settings at channel_max 512: 2
                pretrain iterations (each frame's pose map moved by 0.01
                N(0, 1) m, so phase 16's PCA has a basis), one epoch of
                6 steps with a mini-test
                and a batch checkpoint at step 4, epoch_latest; launch
                counters reset just before (the backward blend once a step,
                the FIR kernel per ``fir_count`` of a pretrain step, a
                train step and the mini-test's render); finite losses,
                moved parameters, a second trainer resumed from
                epoch_latest equal to the first bit for bit, a second CLI
                run resuming to step 12 with one batch_* directory left;
                the JPEG codec, dataset init (and its SMPL-X forward)
                seconds, the loader's mean wait, the median ms of a train
                iteration with host I/O beside phase 9's bare step, peak
                memory and the first item's n_pairs;
 16. animate  - the animation entry point as a user runs it,
                ``main_avatar_torch.main(["-c", cfg, "-m", "test"])``, on
                phase 15's capture with its epoch_latest weights, the
                position and other heads' outputs zeroed as in phase 6's
                fixture (``test.prev_ckpt``), three times. Run A: 12
                THuman4-style poses that tools/capture_fixture.py writes,
                the free orbit with global_orient at 1024x1024, 4 frames a
                render_sequence call, PCA with 2 components. Run B: 2
                poses, the front view, fix_hand with a MANO directory at
                SMPL-X's 10,475 vertices, save_ply, save_tex_map and
                render_skeleton (one render a frame). Run C: run A at the
                default seq_frames, 8 (8 + 4 frames). Launch counters reset
                before each run (expand and forward blend once a frame, the
                backward blend never, the FIR kernel ``fir_count`` a call
                to the heads); the files' names by the JAX package's rule;
                each frame, collected through a wrapped ``_write_frame``,
                against the plain path's same call on its items (phase 6's
                tolerance) and against a render of the frame alone
                (ATOL_FIR_IMG), by tools/frame_compare.py's flip rule; the
                frames' coverage against a floor; the first frame's pairs,
                contributions and blend bound; the PLYs' positions against
                the render's, bit for bit; transform_pca on the card
                against its CPU float64 version; the PoseDataset, SMPL-X
                and PCA-fit seconds, ms/frame with host I/O beside phase
                7's render_sequence, peak memory. The capture is removed
                at the end.
 17. template - the template stack in the user's order, on a full-width
                capture of its own under build/ (2 cameras x 2 frames of
                1500x2048, SMPL-X's real shapes with the template scaled
                by 0.3, the MANO maps) and configs/avatarrex_zzr/
                template.yaml (with_hand, use_root_finding, 1024 rays x 64
                samples): tools/gen_weight_volume at 128^3 (stage
                seconds, peak memory; the card against the CPU path at
                16^3); main_template_torch.main for 2 warm-up and 10 timed
                iterations (launch counters reset just before: no kernel
                of the port may launch; finite losses; ms/iteration with
                host I/O, peak memory), the export at (256, 256, 128)
                (SDF and marching-cubes seconds, the mesh's size); the bare
                step, the device's busy share of one step, its stages'
                device ms (the body's and the hands' nearest-face
                searches, near_far_smpl, the root finding, the MLPs'
                forward and double backward, Adam), one step at 64 rays
                against the same step on the CPU (loss terms, gradients
                per group); tools/gen_pos_maps on the exported template
                (seconds, the map's shape and coverage, init_pts_lbs' row
                sums, one pose map per frame). The capture is removed at
                the end.
 18. eval     - runs after phase 16, on phase 15's capture: its 3 frames
                rendered from each of its 2 cameras by
                ``main_avatar_torch.main(["-c", cfg, "-m", "test"])``
                (``test.data`` the capture, view_setting camera,
                render_view_idx 0 and 1, phase 16's checkpoint: phase
                15's epoch_latest with the position and other heads'
                outputs zeroed; 1500x2048 JPEGs, each covering at least
                ANIM_COVER_MIN of its frame), then scored through the
                evaluation CLI's functions
                (eval/comparison.compare_methods against the capture's
                frames and box mattes: PSNR and SSIM in float64 on the
                card, 512^2 mask crops, LPIPS with random VGG16 weights;
                eval/fid.compute_fid over the crops with a random
                Inception trunk from a seeded generator, not a valid
                metric); launch counters reset just before the scoring (no
                kernel of the port may launch: ``eval_launches`` 0 in each
                record); each frame's PSNR against a numpy PSNR of the
                same render and ground truth (and a swapped camera pairing
                scoring otherwise); the card against the CPU on the same
                frames and weights (PSNR, SSIM, LPIPS, the Inception
                features, the Fréchet distance of the same statistics, and
                the FID from each device's own features, beside the FID of
                a planted fault: the crops resized without antialiasing);
                seconds a frame of each stage (utils/profiling.
                StageTimer), the trunk's ms/image at batch 8 over 64 seeded
                512^2 images, one batch's kernels summed from a
                utils/profiling.trace Chrome trace by trace_report against
                its CUDA-event time, the Fréchet distance's seconds at 2048
                dimensions, peak memory.

Each kernel's record carries its bound: the least time the card could take
for the same work, the larger of the bytes it must move over the memory
rate and the operations it must do, counted from this run's data, over the
FP32 rate (the H100 SXM data sheet figures below). The blends' operations
are those of the contributing (pixel, pair) evaluations only, since a
kernel that culls can skip the others; ``bound_eval_ms`` keeps the earlier
figure, which charged every evaluation. The line before the last
is the kernels' JSON record; the last line is ``{"ok": true, "device":
{...}}``. TF32 is off for matmuls and convs.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
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
# phase 15: frames of the capture (two cameras each), pretrain iterations
# and the heads' width; each frame's pose map moves its texels by this
# times N(0, 1) metres, so that phase 16's PCA has frames that differ
DRIVER_FRAMES, DRIVER_PRETRAIN, DRIVER_CHANNEL_MAX = 3, 2, 512
DRIVER_POSE_JITTER = 0.01
# phase 16: run A's novel poses, frames a render_sequence call and PCA
# components (the capture's 3 training frames allow at most 3; the shipped
# configs' 20 wait for a real capture); run B's frames. Run C animates run
# A's poses at run_test's default seq_frames, 8
ANIM_FRAMES, ANIM_SEQ, ANIM_PCA, ANIM_B_FRAMES = 12, 4, 2, 2
# transform_pca on the card against its float64 CPU version, relative to
# the largest entry: the same float64 arithmetic on two devices
RTOL_PCA = 1e-5
# phase 16's frames, the least share of their pixels with alpha > 1/255:
# about half the smallest reading on the H100 (0.0812 of a frame, PERF.md),
# so that an avatar the frames barely show fails (phase 15's random-init
# heads alone read 0.0046)
ANIM_COVER_MIN = 0.04
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
# phase 17: the template stack on a capture of its own (2 cameras a frame),
# the weight volume's grid, the template CLI's warm-up and timed
# iterations; the SMPL-X template scaled by 0.3, so that the body's box
# stays in front of the cameras 2 m away, as a real subject's does
# (tools/capture_fixture.write_capture)
TPL_FRAMES, TPL_RES, TPL_WARMUP, TPL_TIMED = 2, 128, 2, 10
TPL_BODY_SCALE = 0.3
# the card against the CPU path on the same inputs: the weight volume at
# 16^3 from 8,192 surface samples (the CPU's nearest-face search takes ~1 s
# per 1,024 points against SMPL-X's 20,908 faces, so 32^3 and the full
# 100,000 samples would take minutes), and one template step at 64 rays
TPL_CHECK_RES, TPL_CHECK_SURFACE, TPL_CHECK_RAYS = 16, 8192, 64
# per volume, entries off by more than TPL_VOL_ATOL (the two devices' sums
# over 3 coordinates round differently) may be at most this share: where a
# grid point's two nearest faces tie within float32 rounding, either face
# may win, and its weights or its normal's sign come with it
TPL_VOL_ATOL, TPL_VOL_TIE_SHARE = 1e-5, 5e-3
# the template step, card against CPU: loss terms relative, each parameter
# group's gradient relative L2. The gradients are sensitive to rounding
# (the eikonal term's double backward through softplus(beta = 100), the
# SMPL-sphere near/far's cancellation b +- sqrt(b^2 - c)): on the CPU the
# same step in float32 against float64 differs by 2.2e-3 in geo_mlp and
# 2.0e-3 in density on a small capture; the card against the CPU read
# <= 5.44e-5 (H100, with the hands at the body's x extremes)
TPL_RTOL_LOSS, TPL_RTOL_GRAD = 1e-4, 1e-2
# phase 18: phase 15's capture rendered from its own cameras (in
# calibration order, tools/capture_fixture.write_capture's names) and
# scored at the reference protocol's 512^2 crops; the Inception trunk timed
# on this many seeded images of this side at the scorer's batch
EVAL_CAMS, EVAL_PATCH = ("cam00", "cam01"), 512
EVAL_TIMED_IMAGES, EVAL_TIMED_SIDE, EVAL_BATCH = 64, 512, 8
# the card against the CPU on the same frames: PSNR and SSIM relative
# (float64 on both devices, sums in another order); LPIPS absolute (float32
# VGG16 convolutions of cuDNN and the CPU, TF32 off); the Inception
# features relative to the largest feature (float32 through 94
# convolutions); the Fréchet distance of the same float64 statistics
# relative (two eigensolvers: cuSOLVER's and LAPACK's)
EVAL_RTOL_F64, EVAL_ATOL_LPIPS = 1e-9, 1e-4
EVAL_RTOL_FEATURES, EVAL_RTOL_FRECHET = 1e-4, 1e-6
# the FID end to end, each device's features through its own statistics
# and distance, relative. The two devices' float32 convolutions put the
# features 1.0e-6 to 1.1e-6 apart (relative to the largest feature), and
# the distance carries that at 1.7e-6 to 2.2e-6 (H100, three runs), so
# 1e-6 cannot hold here; the limit is about 5 times the largest reading.
# A planted fault, the crops resized without antialiasing (the trap of
# fid.resize_299), must move the FID by more than EVAL_FAULT_MIN times it
EVAL_RTOL_FID, EVAL_FAULT_MIN = 1e-5, 10
# one Inception batch's kernels summed from a torch.profiler trace
# (utils/profiling.trace_report) over the batch's CUDA-event time: the
# kernels cannot take longer than the span that holds them (up to the two
# clocks' noise), and the launch gaps between them are a small share
EVAL_TRACE_SHARE = (0.5, 1.1)


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


def cull_boxes(rows):
    """(N, 4) [x0 x1 y0 y1]: ``csrc/blend.cu``'s ``cull_box`` in float32
    torch operations, each rounded as the kernel rounds it (-fmad=false):
    outside its box a pair fails power <= 0 and alpha >= 1/255 at every
    pixel; an infinite box never culls, an empty one always does."""
    f32 = lambda v: float(np.float32(v))
    x, y, ca, cb, cc, op = rows[:, :6].unbind(1)
    big = 2.0 ** 40
    sound = ((x.abs() <= 2.0 ** 24) & (y.abs() <= 2.0 ** 24) & (ca > 0)
             & (ca <= big) & (cc > 0) & (cc <= big) & (cb.abs() <= big)
             & (op.abs() <= f32(3.4028234e38)))
    empty = op < f32(np.float32(1) / np.float32(255) * np.float32(0.99999))
    det = ca * cc - cb * cb
    hd = 0.5 * (ca - cc)
    lmax = 0.5 * (ca + cc) + torch.sqrt(hd * hd + cb * cb)
    kappa = lmax * lmax / det
    tau = torch.log(255.0 * op)
    tau_m = torch.clamp(tau * (1.0 + 2.0 ** -16) + 2.0 ** -16, min=0.0)
    t2 = 2.0 * tau_m * (1.0 + 2.0 ** -18 * kappa)
    hx = torch.sqrt(t2 * cc / det)
    hy = torch.sqrt(t2 * ca / det)
    sx = (x.abs() + hx + 1.0) * 2.0 ** -20
    sy = (y.abs() + hy + 1.0) * 2.0 ** -20
    box = torch.stack([x - hx - sx, x + hx + sx, y - hy - sy, y + hy + sy], 1)
    inf = float("inf")
    never = torch.tensor([-inf, inf, -inf, inf], device=rows.device)
    finite = sound & ~empty & (det >= f32(1e-30)) & (kappa <= 1e4)
    box = torch.where(finite[:, None], box, never)
    return torch.where((sound & empty)[:, None], -never, box)


def pair_work(rows, gid, starts, grid_x, img_w, img_h):
    """(evaluated, evaluated after the cull, contributing) (pixel, pair)
    counts this frame's data needs in the blend: a pixel evaluates its
    tile's pairs front to back up to and including the one that would take
    it below the 1e-4 cutoff; the forward kernel evaluates only those whose
    cull box (``cull_boxes``) meets the pixel's warp's 8x4 rectangle; a pair
    contributes when it passes the tests before the cutoff. Raises if the
    cull would drop a contributing (pixel, pair)."""
    from animatablegaussians_torch.ops.rasterize import blend
    P = blend.TILE * blend.TILE
    lp = torch.arange(P, device=rows.device)
    boxes = cull_boxes(rows)
    n_eval = n_cull = n_contrib = 0
    with torch.no_grad():
        for tb, g, kmask, _, geo in blend._batches(rows, gid, starts,
                                                   grid_x):
            _, pexc, contrib, _ = blend._transmittance(geo["alpha"],
                                                       geo["use"])
            px = (tb % grid_x * blend.TILE)[:, None] + lp[None] % blend.TILE
            py = (tb // grid_x * blend.TILE)[:, None] + lp[None] // blend.TILE
            inside = ((px < img_w) & (py < img_h))[:, :, None]
            # the pixel's warp rectangle, as floats (B, P, 1)
            wx0 = (px - px % 8).float()[:, :, None]
            wy0 = (py - py % 4).float()[:, :, None]
            b = boxes[g][:, None]                             # (B, 1, K, 4)
            hit = ~((b[..., 1] < wx0) | (b[..., 0] > wx0 + 7.0)
                    | (b[..., 3] < wy0) | (b[..., 2] > wy0 + 3.0))
            live = inside & kmask[:, None, :] & (pexc >= blend.T_EPS)
            n_eval += int(live.sum())
            n_cull += int((live & hit).sum())
            n_contrib += int((inside & contrib).sum())
            lost = int((inside & contrib & ~hit).sum())
            if lost:
                raise AssertionError(f"the cull box drops {lost} contributing "
                                     "(pixel, pair) evaluations")
    return n_eval, n_cull, n_contrib


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


def fir_count(net, heads=("position_net", "other_net", "color_net")):
    """(FIRs a forward of the ``heads`` runs, of them on a tensor that
    carries a gradient in a train step), from the heads' structure: per
    head conv_in's pre-blur and each FromRGB's downsample (both on the pose
    map, so no gradient), each ConvBlock's pre-blur, and per decoder branch
    each up-conv's post-blur and each ToRGB's wavelet upsample but the
    first's. The FIR kernel launching this often leaves none to F.conv2d."""
    n_fwd = n_grad = 0
    for head in (getattr(net, h) for h in heads):
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


def driver_phase(card: str, bare_step_ms: float, records: list,
                 tmp: str) -> dict:
    """Phase 15: ``main_avatar_torch`` trains a full-width capture written
    under ``tmp`` (see the module docstring); adds each kernel's launches
    in that run to its record as ``driver_launches``. Returns the run's
    config, whose capture and checkpoints phase 16 animates."""
    import yaml

    import main_avatar_torch
    from animatablegaussians_torch.data import image_io
    from animatablegaussians_torch.ops import fir
    from animatablegaussians_torch.ops.rasterize.blend import (
        blend_backward, blend_tiles)
    from animatablegaussians_torch.ops.rasterize.expand import expand_pairs
    from animatablegaussians_torch.tools import capture_fixture as cf
    from animatablegaussians_torch.training import checkpoint as ck
    from animatablegaussians_torch.tools.render_fixture import RENDER_KEYS
    from animatablegaussians_torch.training.driver import AvatarTrainer

    t0 = time.perf_counter()
    data_dir = os.path.join(tmp, "capture")
    smpl_path = cf.write_capture(data_dir, n_frames=DRIVER_FRAMES,
                                 pose_map_jitter=DRIVER_POSE_JITTER,
                                 **cf.FULL)
    phase("driver", f"capture written in {time.perf_counter() - t0:.1f}"
          f" s with the {image_io.CODEC} codec: {DRIVER_FRAMES} frames "
          f"x 2 cameras of {cf.FULL['img_w']}x{cf.FULL['img_h']}, "
          f"map_h {cf.FULL['map_h']}, SMPL-X {cf.FULL['n_verts']} "
          "vertices")
    ckpt_dir = os.path.join(tmp, "ckpt")
    opt = dict(
        train=dict(
            dataset="MvRgbDatasetAvatarReX",
            data=dict(data_dir=data_dir, frame_range=[0, DRIVER_FRAMES],
                      used_cam_ids=[0, 1], load_smpl_pos_map=True,
                      smpl_model_path=smpl_path),
            net_ckpt_dir=ckpt_dir,
            ckpt_interval=dict(epoch=1, batch=4), eval_interval=4,
            eval_training_ids=[0, 0], lr_init=5e-4,
            loss_weight=dict(l1=1.0, lpips=0.1, offset=0.005),
            lpips_weights="random", finetune_color=False, batch_size=1,
            num_workers=8, random_bg_color=True),
        model=dict(with_viewdirs=True, channel_max=DRIVER_CHANNEL_MAX))
    cfg = os.path.join(tmp, "avatar.yaml")
    with open(cfg, "w") as fp:
        yaml.safe_dump(opt, fp)
    argv = ["-c", cfg, "-m", "train"]

    AvatarTrainer.PRETRAIN_ITERS = DRIVER_PRETRAIN
    counted = (expand_pairs, blend_tiles, blend_backward,
               fir.upfirdn2d_fir)
    for fn in counted:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = main_avatar_torch.main(argv, num_epochs=1)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {fn.__name__: fn.launches for fn in counted}
    net = trainer.avatar_net
    n_steps = trainer.iter_idx
    n_eval = n_steps // opt["train"]["eval_interval"]
    pre_fwd, pre_grad = fir_count(net, ("position_net", "other_net"))
    n_fir, n_fir_grad = fir_count(net)
    want = {"expand_pairs": n_steps + n_eval,
            "blend_tiles": n_steps + n_eval, "blend_backward": n_steps,
            "upfirdn2d_fir": DRIVER_PRETRAIN * (pre_fwd + pre_grad)
            + n_steps * (n_fir + n_fir_grad) + n_eval * n_fir}
    phase("driver", f"main_avatar_torch {' '.join(argv[2:])}: "
          f"{DRIVER_PRETRAIN} pretrain iterations, {n_steps} steps, "
          f"{n_eval} mini-test in {wall:.1f} s; kernel launches "
          f"{launches} (want {want}: FIR {pre_fwd} + {pre_grad} a "
          f"pretrain step, {n_fir} + {n_fir_grad} a train step, "
          f"{n_fir} a mini-test)")
    if n_steps != 2 * DRIVER_FRAMES or launches != want:
        raise AssertionError(f"driver: {n_steps} steps, launches "
                             f"{launches}, want {want}")
    for r in records:
        r["driver_launches"] = launches[r["name"]]
    for i, t in enumerate(trainer.terms):
        phase("driver", f"step {i + 1}: " + ", ".join(
            f"{k} {v:.6f}" for k, v in t.items()))
        if not all(math.isfinite(v) for v in t.values()):
            raise AssertionError(f"driver step {i + 1}: non-finite {t}")
    pre = torch.load(os.path.join(ckpt_dir, "pretrained", "net.pt"),
                     map_location="cpu", weights_only=True)["avatar_net"]
    moved = {g: max(float((p.detach().cpu() - pre[n]).abs().max())
                    for n, p in named if p.numel()
                    and not n.startswith("cano_gaussian.features"))
             for g, named in param_groups(net).items()}
    phase("driver", "largest parameter change per group over the epoch: "
          + ", ".join(f"{g} {m:.2e}" for g, m in moved.items()))
    if not min(moved.values()) > 0:
        raise AssertionError(f"driver: a parameter group did not move: "
                             f"{moved}")
    ds = trainer.dataset
    it_med = statistics.median(trainer.iter_ms)
    wait = 1e3 * statistics.mean(trainer.loader_waits)
    phase("driver", f"dataset init {trainer.dataset_init_s:.3f} s, of "
          f"which the SMPL-X forward {ds.smplx_s:.3f} s ({len(ds)} "
          f"items); loader wait mean {wait:.3f} ms a step (per step "
          f"{['%.2f' % (1e3 * w) for w in trainer.loader_waits]}); train "
          f"iteration median {it_med:.2f} ms with host I/O (per "
          f"iteration {['%.2f' % t for t in trainer.iter_ms]}) against "
          f"the bare step's {bare_step_ms:.2f} ms (phase 9); peak "
          f"memory {peak_gb:.2f} GiB ({card})")
    eval_img = os.path.join(ckpt_dir, "eval", "training_4.jpg")
    if not os.path.exists(eval_img):
        raise AssertionError(f"driver: no mini-test image {eval_img}")
    with torch.no_grad():
        item = ds.getitem(0)
        n_pairs = net.render({k: torch.as_tensor(item[k],
                                                 device=trainer.device)
                              for k in RENDER_KEYS},
                             img_w=trainer.img_w,
                             img_h=trainer.img_h)["n_pairs"]
    phase("driver", f"first item's n_pairs after the epoch {n_pairs}; "
          f"mini-test {eval_img} ({os.path.getsize(eval_img)} bytes)")

    # a second trainer resumed from epoch_latest equals the first
    d, with_optm = ck.resolve_resume_dir(ckpt_dir)
    second = AvatarTrainer(opt)
    second.load_ckpt(d, load_optm=with_optm)
    same = (second.iter_idx == trainer.iter_idx == second.state.iter_idx
            and d.endswith("epoch_latest") and with_optm)
    sa, sb = trainer.state, second.state
    for k, v in sa.net.state_dict().items():
        same &= torch.equal(v, sb.net.state_dict()[k])
    oa, ob = sa.optimizer.state_dict(), sb.optimizer.state_dict()
    same &= oa["param_groups"] == ob["param_groups"]
    for i, st in oa["state"].items():
        same &= all(torch.equal(v, ob["state"][i][k])
                    for k, v in st.items())
    same &= sa.scheduler.state_dict() == sb.scheduler.state_dict()
    phase("driver", f"resumed from {os.path.basename(d)}: iter_idx "
          f"{second.iter_idx}, weights, Adam and schedule bit for bit "
          f"equal: {same}")
    if not same:
        raise AssertionError("driver: the resumed state differs")
    del trainer, second, net, sa, sb

    # the CLI again: it resumes from epoch_latest and trains on
    trainer = main_avatar_torch.main(argv, num_epochs=1)
    batches = sorted(x for x in os.listdir(ckpt_dir)
                     if x.startswith("batch_"))
    phase("driver", f"second CLI run resumed to step {trainer.iter_idx};"
          f" checkpoints left: {batches}")
    if trainer.iter_idx != 4 * DRIVER_FRAMES or batches != [
            f"batch_{4 * DRIVER_FRAMES}"]:
        raise AssertionError(f"driver resume: step {trainer.iter_idx}, "
                             f"{batches}")
    del trainer
    return opt


def blend_bytes(n_pts: int, n_pairs: int, gx: int, gy: int, img_w: int,
                img_h: int) -> int:
    """The bytes the forward blend must move: rows, gids and tile ranges in;
    colour, depth and T_final out."""
    return (n_pts * 40 + n_pairs * 4 + (gx * gy + 1) * 8
            + img_w * img_h * 5 * 4)


def frame_blend_work(net, g: dict, items: dict, img_w: int, img_h: int):
    """One frame's blend work, from the posed Gaussians its render returned,
    projected, binned and packed as ``api.render`` does (the plain
    versions, so nothing is counted): (pairs, contributions, the forward
    blend's bound ms and what bounds it)."""
    from animatablegaussians_torch.ops.rasterize import api, binning
    from animatablegaussians_torch.ops.rasterize.blend import TILE
    from animatablegaussians_torch.ops.rasterize.preprocess import \
        preprocess
    intr, extr = items["intr"], items["extr"]
    vm, pm = api._full_projection(extr, intr, img_w, img_h)
    pre = preprocess(g["positions"], g["scales"], g["rotations"], vm, pm,
                     img_w / (2.0 * intr[0, 0]), img_h / (2.0 * intr[1, 1]),
                     img_w, img_h)
    pre = pre._replace(valid=pre.valid & net.valid,
                       radii=torch.where(net.valid, pre.radii,
                                         torch.zeros_like(pre.radii)))
    rows = api._pack_rows(pre, g["opacity"].reshape(-1), g["colors"])
    gx, gy = -(-img_w // TILE), -(-img_h // TILE)
    bins = binning.bin_gaussians(pre.means2d, pre.depths, pre.radii,
                                 pre.valid, img_w, img_h, TILE, plain=True)
    n_contrib = pair_work(rows, bins.gid, bins.starts, gx, img_w, img_h)[2]
    return (bins.n_pairs, n_contrib) + bound(
        blend_bytes(net.n_points, bins.n_pairs, gx, gy, img_w, img_h),
        n_contrib * (OPS_EVAL + OPS_FWD_CONTRIB))


def jax_file_indices(pose_list) -> list:
    """The frame file indices the JAX package's PoseDataset gives in
    run_test's call order (getitem_fast(0), then every index): a pose
    not past the last index takes the last + 1, pose 0 stays 0
    (animatablegaussians_tpu/data/pose_dataset.py:295-321)."""
    last, out = 0, []
    for i in [0] + list(range(len(pose_list))):
        p = pose_list[i]
        last = p if (p == 0 or p > last) else last + 1
        out.append(last)
    return out[1:]


def animate_checkpoint(opt: dict, path: str, dev) -> str:
    """Phase 15's epoch_latest with the position and other heads' ToRGB
    weights zeroed (``render_fixture.zero_head_outputs``), written to
    ``path`` in the reference layout: the Gaussians keep their canonical
    attributes, as in phase 6's fixture, while all three heads' conv work
    is unchanged."""
    from animatablegaussians_torch.tools import render_fixture as rf
    from animatablegaussians_torch.training import checkpoint as ck
    from animatablegaussians_torch.training.driver import AvatarTrainer

    net = AvatarTrainer._build_net(opt["train"]["data"]["data_dir"],
                                   opt.get("model", {}), dev)
    meta = ck.load_checkpoint(os.path.join(opt["train"]["net_ckpt_dir"],
                                           "epoch_latest"), net)
    rf.zero_head_outputs(net)
    ck.save_checkpoint(path, net, **meta)
    return path


def animate_phase(card: str, tmp: str, opt: dict, seq_ms: float,
                  records: list) -> None:
    """Phase 16: ``main_avatar_torch -m test`` animates phase 15's capture
    with its epoch_latest weights (the position and other heads' outputs
    zeroed), in three runs (see the module docstring); adds each kernel's
    launches in them to its record as ``animate_launches``."""
    import yaml

    import main_avatar_torch
    from animatablegaussians_torch.ops import fir
    from animatablegaussians_torch.ops.rasterize.blend import (
        blend_backward, blend_tiles)
    from animatablegaussians_torch.ops.rasterize.expand import expand_pairs
    from animatablegaussians_torch.testing import animate
    from animatablegaussians_torch.tools import capture_fixture as cf

    data = opt["train"]["data"]
    t0 = time.perf_counter()
    ckpt = animate_checkpoint(opt, os.path.join(tmp, "animate_ckpt"),
                              torch.device("cuda:0"))
    torch.cuda.empty_cache()
    phase("animate", f"checkpoint: phase 15's epoch_latest with the "
          f"position and other heads' outputs zeroed, so the Gaussians keep "
          f"their canonical opacity and scales (as phase 6's fixture), in "
          f"{time.perf_counter() - t0:.1f} s")
    poses = cf.write_pose_sequence(os.path.join(tmp, "thuman4",
                                                "pose_00.npz"),
                                   ANIM_FRAMES, seed=16)
    mano = cf.write_mano(os.path.join(tmp, "mano"),
                         n_verts_total=cf.FULL["n_verts"])
    pose_data = dict(data_path=poses, smpl_model_path=data["smpl_model_path"])
    free = dict(pose_data=pose_data, view_setting="free", global_orient=True,
                img_scale=1.0, n_pca=ANIM_PCA, sigma_pca=2.0)
    runs = {
        "A": dict(free, seq_frames=ANIM_SEQ),
        "B": dict(pose_data=dict(pose_data, frame_range=[0, ANIM_B_FRAMES],
                                 mano_dir=mano),
                  view_setting="front", img_scale=1.0, n_pca=-1,
                  fix_hand=True, fix_hand_id=1, save_ply=True,
                  save_tex_map=True, render_skeleton=True),
        "C": free}
    phase("animate", f"run A: {ANIM_FRAMES} THuman4-style poses, free orbit "
          f"with global_orient at 1024x1024, {ANIM_SEQ} frames a "
          f"render_sequence call, PCA with {ANIM_PCA} components (the "
          f"capture's {DRIVER_FRAMES} training frames allow at most "
          f"{DRIVER_FRAMES}; the shipped configs' 20 wait for a real "
          f"capture); run B: {ANIM_B_FRAMES} poses, front view, fix_hand, "
          "save_ply, save_tex_map, render_skeleton, one render a frame; "
          "run C: run A at the default seq_frames (8), so 8 + 4 frames")

    # the frames are collected in memory, each with its write time
    frames = []
    inner_write = animate._write_frame

    def write(item, items, extr, intr, img_w, img_h, output, *rest):
        inner_write(item, items, extr, intr, img_w, img_h, output, *rest)
        frames.append(dict(item=item, items=items, size=(img_w, img_h),
                           output=output, t=time.perf_counter()))

    counted = (expand_pairs, blend_tiles, blend_backward, fir.upfirdn2d_fir)
    total = {fn.__name__: 0 for fn in counted}
    animate._write_frame = write
    try:
        for name, test in runs.items():
            frames.clear()
            test = dict(test, prev_ckpt=ckpt,
                        output_dir=os.path.join(tmp, f"animate_{name}"))
            cfg = os.path.join(tmp, f"animate_{name}.yaml")
            with open(cfg, "w") as fp:
                yaml.safe_dump(dict(opt, test=test), fp)
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for fn in counted:
                fn.launches = 0
            t0 = time.perf_counter()
            trainer = main_avatar_torch.main(["-c", cfg, "-m", "test"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            launches = {fn.__name__: fn.launches for fn in counted}
            for k, v in launches.items():
                total[k] += v
            loop_ms = 1e3 * (frames[-1]["t"] - trainer.test_loop_t0) / len(
                frames)
            check_animation(name, test, trainer, frames, launches, wall,
                            peak_gb, loop_ms, seq_ms, data["data_dir"], card)
            frames.clear()
            del trainer
    finally:
        animate._write_frame = inner_write
    for rec in records:
        rec["animate_launches"] = total[rec["name"]]


def check_animation(name, test, trainer, frames, launches, wall, peak_gb,
                    loop_ms, seq_ms, data_dir, card) -> None:
    """Phase 16's checks of one run: the launches, the file names, each
    frame against the plain path, the PLYs, the frames' coverage and the
    first frame's blend work, transform_pca on the card against the CPU,
    and the run's times."""
    from animatablegaussians_torch.models.gaussian_model import \
        load_gaussians_from_ply
    from animatablegaussians_torch.tools import frame_compare as fc
    from animatablegaussians_torch.utils import exr

    net = trainer.avatar_net
    poses = trainer.test_datasets["poses"]
    n_fir = fir_count(net)[0]
    n = len(frames)
    # calls to the heads: one a render_sequence batch (one a frame with
    # the exports), and the mean hands'
    per = 1 if (test.get("save_ply") or test.get("save_tex_map")) else int(
        test.get("seq_frames", 8))
    calls = -(-n // per) + bool(test.get("fix_hand"))
    want = {"expand_pairs": n, "blend_tiles": n, "blend_backward": 0,
            "upfirdn2d_fir": calls * n_fir}
    phase("animate", f"run {name}: {n} frames in {wall:.1f} s (trainer, "
          f"datasets, PCA and frames); kernel launches {launches} (want "
          f"{want}: FIR {n_fir} a call to the heads, {calls} calls)")
    if n != len(poses) or launches != want:
        raise AssertionError(f"animate run {name}: {n} frames, launches "
                             f"{launches}, want {want}")

    # the file names and counts: the JAX package's rule, one per frame
    names = ["%08d" % i for i in jax_file_indices(poses.pose_list)]
    folders = {"rgb_map": ".jpg", "mask_map": ".png"}
    if test.get("save_tex_map"):
        folders["cano_tex_map"] = ".jpg"
    if test.get("render_skeleton"):
        folders["live_skeleton"] = ".jpg"
    if test.get("save_ply"):
        folders["posed_gaussians"] = ".ply"
    out_dir = test["output_dir"]
    got = {f: sorted(os.listdir(os.path.join(out_dir, f)))
           for f in sorted(os.listdir(out_dir))}
    want_files = {f: [x + e for x in names] for f, e in sorted(
        folders.items())}
    if got != want_files or [f["item"]["data_idx"] for f in frames] != [
            int(x) for x in names]:
        raise AssertionError(f"animate run {name}: files {got}, want "
                             f"{want_files}")

    # the mean hands of the plain path, from the same fixed frame
    hand_vals = None
    if test.get("fix_hand"):
        m = exr.read_exr(os.path.join(data_dir, "smpl_pos_map",
                                      "%08d.exr" % test["fix_hand_id"]))
        half = m.shape[1] // 2
        hand_vals = net.generate_mean_hands(torch.as_tensor(
            np.concatenate([m[:, :half], m[:, half:]], axis=2)[..., :3],
            device=net.lbs.device), plain=True)
    # each frame against the plain path on the same items: the same call
    # (a render_sequence batch, or a render) at phase 6's tolerance, and a
    # render of the frame alone, whose batch-1 convs sum in another order
    # than the batch's, at ATOL_FIR_IMG; in both, but for the pixels where
    # an alpha decision flips (tools/frame_compare.py's rule, with the span
    # of one contribution from the frame's posed Gaussians)
    kw = dict(bg_color=(1.0, 1.0, 1.0), img_w=frames[0]["size"][0],
              img_h=frames[0]["size"][1], use_pca=test["n_pca"] >= 1,
              hand_vals=hand_vals, plain=True)
    atol_alone = dict.fromkeys(ATOL_BLEND, ATOL_FIR_IMG)
    same, alone = [], []
    for b in range(0, n, per):
        batch = frames[b:b + per]
        assert all(f["size"] == frames[0]["size"] for f in batch)
        if len(batch) > 1:
            out = net.render_sequence({k: torch.stack(
                [f["items"][k] for f in batch]) for k in batch[0]["items"]},
                **kw)
            refs = [{k: v[i] for k, v in out.items()}
                    for i in range(len(batch))]
        else:
            refs = [net.render(batch[0]["items"], **kw)]
        for f, ref in zip(batch, refs):
            o = f["output"]
            for k in ("rgb_map", "depth_map", "mask_map"):
                if not torch.isfinite(o[k]).all():
                    raise AssertionError(f"animate run {name}: {k} "
                                         "non-finite")
            one = ref if len(batch) == 1 else net.render(f["items"], **kw)
            g = one["posed_gaussians"]
            span = fc.contribution_span(
                g["positions"][net.valid], g["colors"][net.valid],
                f["items"]["extr"], kw["bg_color"])
            same.append(fc.flip_diff(o, ref, ATOL_BLEND, span))
            if len(batch) > 1:
                alone.append(fc.flip_diff(o, one, atol_alone, span))
            if test.get("save_ply"):
                ply = load_gaussians_from_ply(os.path.join(
                    out_dir, "posed_gaussians",
                    "%08d.ply" % f["item"]["data_idx"]))
                pos = o["posed_gaussians"]["positions"][net.valid].cpu()
                if not (ply["positions"].shape == (net.n_valid, 3)
                        and torch.equal(torch.from_numpy(ply["positions"]),
                                        pos)):
                    raise AssertionError(f"animate run {name}: the PLY's "
                                         "positions differ from the "
                                         "render's")
            del one, g
        del refs
    phase("animate", f"run {name}, each frame against the plain path's "
          f"{'render_sequence' if per > 1 else 'render'} on its items: "
          + fc.flip_summary(same, ATOL_BLEND)
          + (f"; against render(plain=True) of the frame alone: "
             + fc.flip_summary(alone, atol_alone) if alone else "")
          + (f"; {n} PLYs of {net.n_valid} points, positions equal to "
             "the render's posed_gaussians[valid] bit for bit"
             if test.get("save_ply") else ""))
    cov = [d["in_view"] for d in same]
    first = net.render(frames[0]["items"], **kw)
    g = first["posed_gaussians"]
    opac = g["opacity"].reshape(-1)[net.valid]
    n_pairs, n_contrib, b_ms, b_by = frame_blend_work(
        net, g, frames[0]["items"], *frames[0]["size"])
    phase("animate", f"run {name}: pixels with alpha > 1/255 "
          f"{min(cov):.4f} to {max(cov):.4f} of a frame (floor "
          f"{ANIM_COVER_MIN:g}), mean alpha "
          f"{min(d['mean_alpha'] for d in same):.3e} to "
          f"{max(d['mean_alpha'] for d in same):.3e}; the first frame's "
          f"{n_pairs} pairs and {n_contrib} contributions, the forward "
          f"blend's bound {b_ms:.4f} ms ({b_by}); its valid Gaussians' "
          f"opacity mean {float(opac.mean()):.3e} (> 1/255 at "
          f"{float((opac > 1 / 255).float().mean()):.4f} of them)")
    del first, g
    if not (fc.flips_ok(same, ATOL_BLEND) and fc.flips_ok(alone, atol_alone)
            and min(cov) >= ANIM_COVER_MIN):
        raise AssertionError(f"animate run {name}: frames against the "
                             f"plain path {same}, alone {alone}")

    fit = trainer.test_datasets["training"] if test["n_pca"] >= 1 else None
    phase("animate", f"run {name}: PoseDataset init {poses.init_s:.3f} s, "
          f"of which the SMPL-X forward {poses.smplx_s:.3f} s ({len(poses)}"
          f" poses)" + (f"; PCA fit or cache load {fit.pca_fit_s:.3f} s"
                        if fit else "")
          + f"; {per if per > 1 else 1} frames a call to the heads, "
          f"{loop_ms:.2f} ms/frame with host I/O (camera, item, pose "
          f"map, PCA, render, image writes) beside phase 7's "
          f"render_sequence {seq_ms:.2f} ms/frame at 1500x2048; peak "
          f"memory {peak_gb:.2f} GiB ({card})")
    if fit is not None:
        # transform_pca on the card against its float64 CPU version, on
        # the last frame's regenerated pose map
        pm = frames[-1]["items"]["smpl_pos_map"][..., :3]
        rows = pm[torch.as_tensor(fit.pos_map_mask, device=pm.device)]
        dev_out = fit.transform_pca(rows, sigma_pca=2.0).cpu().double()
        cpu_out = fit.transform_pca(rows.cpu().double(), sigma_pca=2.0)
        rel = float((dev_out - cpu_out).abs().max() / cpu_out.abs().max())
        moved = float((frames[-1]["items"]["smpl_pos_map_pca"][..., :3]
                       - pm).abs().max())
        phase("animate", f"transform_pca on the card vs its CPU float64 "
              f"version: max |diff| / max |CPU| {rel:.3e} (limit "
              f"{RTOL_PCA:g}) over {rows.shape[0]} texels, "
              f"{fit.pca['components'].shape[0]} components; the projection "
              f"moved the frame's pose map by up to {moved:.3e}")
        if not rel <= RTOL_PCA:
            raise AssertionError(f"transform_pca: card vs CPU {rel}")


def template_stage_ms(net, step, items, reps: int = 3) -> dict:
    """Device ms (CUDA events, mean of ``reps`` after one warm-up) of the
    template step's stages on ``items``' rays: the body's and the hands'
    nearest-face searches, the SMPL-sphere near/far, the root finding, the
    MLPs' forward with the eikonal normal and its double backward, and
    Adam."""
    from animatablegaussians_torch.ops import geometry3d as g3d
    from animatablegaussians_torch.ops.root_finding import root_finding
    from animatablegaussians_torch.utils import nerf as nerf_util

    with torch.no_grad():
        near, far = net.smpl_guided_near_far(items, items["ray_o"],
                                             items["ray_d"], items["near"],
                                             items["far"])
        pts, _ = nerf_util.sample_pts_on_rays(
            items["ray_o"], items["ray_d"], near, far, step.n_samples)
        flat = pts.reshape(-1, 3)
        mats = net._rigid_hand_mats(items["cano2live_jnt_mats"])
        w, _ = g3d.calc_blending_weight(
            flat, items["live_smpl_v"], items["smpl_faces"],
            items["smpl_lbs"], method="barycentric")
        inv = torch.linalg.inv(torch.einsum("nj,jxy->nxy", w, mats))
        cano0 = torch.einsum("nxy,ny->nx", inv[:, :3, :3], flat) + \
            inv[:, :3, 3]
        cano, _ = net.transform_live2cano(flat, items)
    faces = items["mano_face_closed"]

    def hands():
        for side, f in (("left", torch.flip(faces, [1])), ("right", faces)):
            g3d.nearest_face(flat, items[f"{side}_live_mano_v"], f)

    def mlp():
        net.zero_grad(set_to_none=True)
        out = net.forward_cano_body_nerf(cano, None, compute_grad=True)
        loss = (out["color"].mean() + out["density"].mean()
                + ((out["normal"].norm(dim=-1) - 1) ** 2).mean())
        loss.backward()

    stages = {
        "nearest_face body": lambda: g3d.nearest_face(
            flat, items["live_smpl_v"], items["smpl_faces"]),
        "nearest_face hands": hands,
        "near_far_smpl": lambda: g3d.near_far_smpl(
            items["live_smpl_v"], items["ray_o"], items["ray_d"]),
        "root_finding": lambda: root_finding(
            net.weight_volume_arr, net.grad_volume_arr, flat, cano0, mats,
            net.volume.volume_bounds),
        "MLPs forward + double backward": mlp,
        "Adam": step.optimizer.step,
    }
    return {k: cuda_ms(fn, reps, warmup=1) for k, fn in stages.items()}


def template_cpu_check(run, items, vol_path: str) -> None:
    """One template step's loss terms and gradients on the card against
    the same step on the CPU: TPL_CHECK_RAYS rays of ``items``, three
    quarters those that the card's render of all the rays accumulates
    most, a quarter those it accumulates least (so that the body and its
    colour have gradients to compare), the run's parameters, draws made on
    the host."""
    import copy

    from animatablegaussians_torch.models.template import TemplateNet
    from animatablegaussians_torch.models.volume import \
        CanoBlendWeightVolume
    from animatablegaussians_torch.training import template_trainer as tt

    net_cpu = TemplateNet(run.net.opt, CanoBlendWeightVolume(
        vol_path, device="cpu"), device="cpu")
    net_cpu.load_state_dict({k: v.cpu() for k, v in
                             run.net.state_dict().items()})
    n, S = TPL_CHECK_RAYS, run.step.n_samples
    with torch.no_grad():
        acc = run.net.render_rays(items, items["ray_o"], items["ray_d"],
                                  items["near"], items["far"],
                                  n_samples=S)["acc_map"]
    order = torch.argsort(acc, descending=True, stable=True)
    pick = torch.sort(torch.cat([order[:n - n // 4],
                                 order[-(n // 4):]])).values
    sub = {k: v[pick] if k in tt.RAY_KEYS else v for k, v in items.items()}
    gen = torch.Generator().manual_seed(5)
    draws = dict(t_rand=torch.rand((n, S), generator=gen),
                 view_noise=torch.randn((n * S, 3), generator=gen))
    res = {}
    for name, net in (("card", run.net), ("cpu", net_cpu)):
        d = next(net.parameters()).device
        st = copy.copy(run.step)
        st.net = net
        net.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        total, terms = st.loss({k: v.to(d) for k, v in sub.items()},
                               draws={k: v.to(d) for k, v in draws.items()})
        total.backward()
        groups = {}
        for pn, p in net.named_parameters():
            groups.setdefault(pn.split(".")[0], []).append(
                p.grad.detach().reshape(-1).cpu().double())
        res[name] = ({k: float(v.detach()) for k, v in terms.items()},
                     {g: torch.cat(v) for g, v in groups.items()},
                     time.perf_counter() - t0)
        net.zero_grad(set_to_none=True)
    (t_card, g_card, s_card), (t_cpu, g_cpu, s_cpu) = res["card"], res["cpu"]
    loss_err = {k: abs(t_card[k] - v) / max(abs(v), 1e-30)
                for k, v in t_cpu.items()}
    grad_err = {g: float((g_card[g] - v).norm() / v.norm().clamp(min=1e-30))
                for g, v in g_cpu.items()}
    norms = {g: float(v.norm()) for g, v in g_cpu.items()}
    phase("template", f"step at {n} rays x {S} samples (accumulation "
          f"{float(acc[pick].min()):.3f}-{float(acc[pick].max()):.3f}), "
          f"card against CPU ({s_card:.2f} s / {s_cpu:.2f} s): loss terms "
          + ", ".join(
              f"{k} {t_cpu[k]:.6f} (rel {e:.1e})"
              for k, e in loss_err.items())
          + f" (limit {TPL_RTOL_LOSS:g}); gradients " + ", ".join(
              f"{g} {e:.2e} (norm {norms[g]:.3e})"
              for g, e in grad_err.items())
          + f" (limit {TPL_RTOL_GRAD:g})")
    finite = all(math.isfinite(v) for v in t_card.values()) and all(
        bool(torch.isfinite(v).all()) for v in g_card.values())
    # the body's groups must have gradients to compare; the hands' only
    # where a ray reaches them
    moved = all(norms[g] > 0 for g in ("geo_mlp", "tex_mlp", "density"))
    if not (finite and moved and max(loss_err.values()) <= TPL_RTOL_LOSS
            and max(grad_err.values()) <= TPL_RTOL_GRAD):
        raise AssertionError("template step: card disagrees with the CPU")


def eval_trace_check(inception, batch, batch_ms: float, tmp: str) -> str:
    """One Inception batch under ``utils/profiling.trace``: its kernels,
    summed by ``trace_report``, must come to EVAL_TRACE_SHARE of the
    batch's CUDA-event time ``batch_ms``, with convolutions among them
    (cuDNN's implicit-GEMM, Winograd and FFT kernels, by name); returns
    the reading."""
    import re

    from animatablegaussians_torch.utils import profiling

    d = os.path.join(tmp, "eval_trace")
    with profiling.trace(d):
        profiling.sync(inception.features(batch))
    report = profiling.trace_report(d, top=10 ** 6)
    if report.startswith("no "):
        raise AssertionError(f"eval trace: {report}")
    rows = [ln.split(None, 4) for ln in report.splitlines()]
    total = sum(float(r[0]) for r in rows)
    conv_names = r"conv|fprop|xmma|implicit_gemm|cudnn|winograd|fft"
    conv = sum(float(r[0]) for r in rows
               if re.search(conv_names, r[4], re.I))
    reading = (f"one batch of {batch.shape[0]} under profiling.trace: "
               f"trace_report sums {sum(int(r[2]) for r in rows)} kernel "
               f"events of {len(rows)} names to {total:.3f} ms against "
               f"{batch_ms:.3f} ms of CUDA events (share "
               f"{total / batch_ms:.3f}, limits {EVAL_TRACE_SHARE}), "
               f"convolution kernels {conv:.3f} ms; the longest: "
               + "; ".join(f"{r[4][:60]} {float(r[0]):.3f} ms"
                           for r in rows[:3]))
    if not (EVAL_TRACE_SHARE[0] <= total / batch_ms <= EVAL_TRACE_SHARE[1]
            and conv > 0):
        raise AssertionError(f"eval trace: {reading}")
    return reading


def eval_phase(card: str, tmp: str, opt: dict, records: list) -> None:
    """Phase 18: phase 15's capture rendered from each of its cameras by
    ``main_avatar_torch -m test`` with phase 16's checkpoint, then scored
    by the evaluation CLI's functions on the card and on the CPU (see the
    module docstring); adds each kernel's launches while scoring (none) to
    its record as ``eval_launches``."""
    import cv2
    import torch.nn.functional as F
    import yaml

    import main_avatar_torch
    from animatablegaussians_torch.eval import comparison
    from animatablegaussians_torch.eval import fid
    from animatablegaussians_torch.ops import fir
    from animatablegaussians_torch.ops.rasterize.blend import (
        blend_backward, blend_tiles)
    from animatablegaussians_torch.ops.rasterize.expand import expand_pairs
    from animatablegaussians_torch.tools import capture_fixture as cf
    from animatablegaussians_torch.training import lpips as tlp
    from animatablegaussians_torch.utils.profiling import StageTimer

    counted = (expand_pairs, blend_tiles, blend_backward, fir.upfirdn2d_fir)
    full_w, full_h = cf.FULL["img_w"], cf.FULL["img_h"]
    data = opt["train"]["data"]
    frames = list(range(DRIVER_FRAMES))
    # phase 16's checkpoint: phase 15's raw epoch_latest covers about 0.5%
    # of a frame, too little to score
    ckpt = os.path.join(tmp, "animate_ckpt")
    if not os.path.exists(ckpt):
        raise AssertionError(f"eval: no checkpoint {ckpt} from phase 16")

    # the frames to score: the capture's own poses seen by its cameras
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    renders = {}
    for i, cam in enumerate(EVAL_CAMS):
        test = dict(data=dict(data_dir=data["data_dir"],
                              frame_range=[0, DRIVER_FRAMES],
                              smpl_model_path=data["smpl_model_path"]),
                    view_setting="camera", render_view_idx=i,
                    img_scale=1.0, prev_ckpt=ckpt,
                    output_dir=os.path.join(tmp, f"eval_{cam}"))
        cfg = os.path.join(tmp, f"eval_{cam}.yaml")
        with open(cfg, "w") as fp:
            yaml.safe_dump(dict(opt, test=test), fp)
        main_avatar_torch.main(["-c", cfg, "-m", "test"])
        renders[cam] = os.path.join(test["output_dir"], "rgb_map")
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    n = len(EVAL_CAMS) * len(frames)
    phase("eval", f"main_avatar_torch -m test, view_setting camera, "
          f"render_view_idx 0 and 1, phase 16's checkpoint: {n} frames in "
          f"{time.perf_counter() - t0:.1f} s; kernel launches {launches}")
    if not (launches["expand_pairs"] == launches["blend_tiles"] == n
            and launches["blend_backward"] == 0
            and launches["upfirdn2d_fir"] > 0):
        raise AssertionError(f"eval renders: launches {launches}")
    for cam in EVAL_CAMS:
        for f in frames:
            img = cv2.imread(os.path.join(renders[cam], "%08d.jpg" % f))
            if img is None or img.shape != (full_h, full_w, 3):
                raise AssertionError(f"eval: frame {cam}/{f} is "
                                     f"{None if img is None else img.shape}")
    # each frame's share of pixels with alpha >= 1/255 (run_test's mask_map
    # PNG holds floor(255 alpha))
    cover = [float((cv2.imread(os.path.join(os.path.dirname(renders[cam]),
                                            "mask_map", "%08d.png" % f),
                               cv2.IMREAD_UNCHANGED) >= 1).mean())
             for cam in EVAL_CAMS for f in frames]
    phase("eval", f"pixels with alpha >= 1/255: {min(cover):.4f} to "
          f"{max(cover):.4f} of a frame (floor {ANIM_COVER_MIN:g})")
    if min(cover) < ANIM_COVER_MIN:
        raise AssertionError(f"eval: frames too faint to score, {cover}")

    def plain_psnr(render, cam, f):
        """numpy's PSNR of a render against camera ``cam``'s frame ``f``,
        whitened outside its matte, read as compare_methods reads them."""
        def rd(path):
            img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            return (img / 255.0).astype(np.float32).astype(np.float64)
        gt = rd(os.path.join(data["data_dir"], cam, "%08d.jpg" % f))
        mask = rd(os.path.join(data["data_dir"], cam, "mask", "pha",
                               "%08d.jpg" % f)) > 0.5
        gt[~(mask[..., 0] if mask.ndim == 3 else mask)] = 1.0
        return float(10.0 * np.log10(1.0 / np.mean((rd(render) - gt) ** 2)))

    def score(device, lp, timer=None, crops=None):
        """Per-frame [psnr, ssim, lpips] of every camera and frame."""
        out = {}
        for cam in EVAL_CAMS:
            for f in frames:
                m = comparison.compare_methods(
                    {"ours": renders[cam]},
                    os.path.join(data["data_dir"], cam),
                    os.path.join(data["data_dir"], cam, "mask", "pha"), [f],
                    patch_size=EVAL_PATCH, lpips_params=lp,
                    crop_out_dir=crops and os.path.join(crops, cam),
                    device=device, timer=timer)["ours"]
                if m.count != 1:
                    raise AssertionError(f"eval: {cam}/{f} not scored")
                out[(cam, f)] = [m.psnr, m.ssim, m.lpips]
        return out

    lp_weights = tlp.init_random(0)
    lp_card = tlp.LPIPS(lp_weights, device="cuda")
    crops = os.path.join(tmp, "eval_crops")
    timer = StageTimer()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    card_scores = score("cuda", lp_card, timer, crops)
    score_s = time.perf_counter() - t0
    # the FID's directories: both cameras' crops
    fid_dirs = {}
    for sub in ("ours", "gt"):
        fid_dirs[sub] = os.path.join(crops, "all", sub)
        os.makedirs(fid_dirs[sub])
        for cam in EVAL_CAMS:
            for name in os.listdir(os.path.join(crops, cam, sub)):
                shutil.copy(os.path.join(crops, cam, sub, name),
                            os.path.join(fid_dirs[sub], f"{cam}_{name}"))
    inception = fid.InceptionV3Features.init_random(
        torch.Generator().manual_seed(18), device="cuda")
    with timer.stage("fid"):
        fid_card = fid.compute_fid(fid_dirs["ours"], fid_dirs["gt"],
                                   inception, batch=EVAL_BATCH)
    launches = {fn.__name__: fn.launches for fn in counted}
    for rec in records:
        rec["eval_launches"] = launches[rec["name"]]
    phase("eval", f"kernel launches while scoring: {launches} (the scorer "
          "reaches no kernel of the port)")
    if any(launches.values()):
        raise AssertionError(f"eval: the scorer launched {launches}")
    mean = [statistics.mean(v[i] for v in card_scores.values())
            for i in range(3)]
    phase("eval", f"compare_methods on the card, {n} frames of "
          f"{full_w}x{full_h} at {EVAL_PATCH}^2 crops: PSNR {mean[0]:.6f}, "
          f"SSIM {mean[1]:.6f}, LPIPS {mean[2]:.6f} (random VGG16 "
          f"weights, not a valid metric) in {score_s:.2f} s; per frame " +
          ", ".join(f"{c}/{f} {v[0]:.4f}/{v[1]:.4f}/{v[2]:.4f}"
                    for (c, f), v in card_scores.items()))
    phase("eval", f"FID over the {len(os.listdir(fid_dirs['ours']))} + "
          f"{len(os.listdir(fid_dirs['gt']))} crops: {fid_card:.6f} "
          "(random trunk, not a valid metric)")
    if not all(math.isfinite(x) for v in card_scores.values() for x in v) \
            or not math.isfinite(fid_card):
        raise AssertionError(f"eval: non-finite scores {card_scores}, "
                             f"FID {fid_card}")
    # each frame scored against its own camera's ground truth: the scorer's
    # PSNR against numpy's on the same pairing, and against the other
    # camera's frame, which must read otherwise
    psnr_err, swap_gap = 0.0, math.inf
    for (cam, f), v in card_scores.items():
        other = EVAL_CAMS[1 - EVAL_CAMS.index(cam)]
        render = os.path.join(renders[cam], "%08d.jpg" % f)
        right = plain_psnr(render, cam, f)
        psnr_err = max(psnr_err, abs(v[0] - right) / right)
        swap_gap = min(swap_gap,
                       abs(v[0] - plain_psnr(render, other, f)) / right)
    distinct = len({v[0] for v in card_scores.values()})
    phase("eval", f"each frame's PSNR against numpy's on the same pairing: "
          f"rel {psnr_err:.2e} (limit {EVAL_RTOL_F64:g}); against the other "
          f"camera's frame at least {swap_gap:.2e} apart (must exceed "
          f"{1e3 * EVAL_RTOL_F64:g}); {distinct} distinct PSNRs in {n} "
          "frames")
    if not (psnr_err <= EVAL_RTOL_F64 and swap_gap > 1e3 * EVAL_RTOL_F64
            and distinct > 1):
        raise AssertionError("eval: the scores are not those of the frames'"
                             " own pairings")
    for cam in EVAL_CAMS:
        for sub in ("ours", "gt"):
            for f in frames:
                c = cv2.imread(os.path.join(crops, cam, sub, "%08d.png" % f))
                if c is None or c.shape != (EVAL_PATCH, EVAL_PATCH, 3):
                    raise AssertionError(f"eval: crop {cam}/{sub}/{f}")

    # the card against the CPU: the same frames, weights and features
    cpu_scores = score("cpu", tlp.LPIPS(lp_weights, device="cpu"))
    errs = [max(abs(card_scores[k][i] - cpu_scores[k][i])
                / (abs(cpu_scores[k][i]) if i < 2 else 1.0)
                for k in card_scores) for i in range(3)]
    inception_cpu = fid.InceptionV3Features.init_random(
        torch.Generator().manual_seed(18), device="cpu")
    feats, feat_err = {}, 0.0
    for sub, d in fid_dirs.items():
        a = fid.features_of_images(inception, fid.read_rgb_dir(d),
                                   EVAL_BATCH)
        b = fid.features_of_images(inception_cpu, fid.read_rgb_dir(d),
                                   EVAL_BATCH)
        feat_err = max(feat_err, float((a.cpu() - b).abs().max()
                                       / b.abs().max()))
        feats[sub] = (a, b)
    stats = {sub: fid.gaussian_stats(a, "cuda") for sub, (a, _) in
             feats.items()}
    fd_card = fid.frechet_distance(*stats["ours"], *stats["gt"],
                                   device="cuda")
    fd_cpu = fid.frechet_distance(*stats["ours"], *stats["gt"],
                                  device="cpu")
    fd_err = abs(fd_card - fd_cpu) / abs(fd_cpu)
    fd_cpu_feats = fid.frechet_distance(
        *fid.gaussian_stats(feats["ours"][1], "cpu"),
        *fid.gaussian_stats(feats["gt"][1], "cpu"), device="cpu")
    fid_rel = abs(fd_cpu_feats - fid_card) / fid_card
    # the planted fault: the crops of the renders resized to 299 without
    # antialiasing, through the same trunk on the card
    with torch.no_grad():
        x = torch.from_numpy(np.stack(list(fid.read_rgb_dir(
            fid_dirs["ours"]))).astype(np.float32)).cuda()
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(299, 299),
                          mode="bilinear", align_corners=False)
        fault = inception.trunk(x * 2.0 - 1.0)
    fd_fault = fid.frechet_distance(*fid.gaussian_stats(fault, "cuda"),
                                    *stats["gt"], device="cuda")
    fault_rel = abs(fd_fault - fid_card) / fid_card
    del x, fault
    phase("eval", f"card vs CPU on the same frames: PSNR rel "
          f"{errs[0]:.2e}, SSIM rel {errs[1]:.2e} (limit {EVAL_RTOL_F64:g}),"
          f" LPIPS abs {errs[2]:.2e} (limit {EVAL_ATOL_LPIPS:g}); "
          f"Inception features max |card - CPU| / max |CPU| {feat_err:.2e} "
          f"(limit {EVAL_RTOL_FEATURES:g}); Fréchet distance of the card's "
          f"features on the card {fd_card:.9f}, on the CPU {fd_cpu:.9f} "
          f"(rel {fd_err:.2e}, limit {EVAL_RTOL_FRECHET:g}; compute_fid "
          f"read {fid_card:.9f}); the FID end to end, each device's own "
          f"features, statistics and distance: card {fid_card:.9f}, CPU "
          f"{fd_cpu_feats:.9f} (rel {fid_rel:.2e}, limit "
          f"{EVAL_RTOL_FID:g}); planted fault, the renders' crops resized "
          f"without antialiasing: {fd_fault:.6f} (rel {fault_rel:.2e}, must "
          f"exceed {EVAL_FAULT_MIN * EVAL_RTOL_FID:g})")
    if not (errs[0] <= EVAL_RTOL_F64 and errs[1] <= EVAL_RTOL_F64
            and errs[2] <= EVAL_ATOL_LPIPS
            and feat_err <= EVAL_RTOL_FEATURES
            and fd_err <= EVAL_RTOL_FRECHET
            and abs(fd_card - fid_card) <= EVAL_RTOL_FRECHET * fid_card
            and fid_rel <= EVAL_RTOL_FID
            and fault_rel > EVAL_FAULT_MIN * EVAL_RTOL_FID):
        raise AssertionError("eval: the card and the CPU disagree")
    del feats, stats

    # stage times: seconds a frame, the trunk at batch EVAL_BATCH, the
    # Fréchet distance at 2048 dimensions
    per_frame = {k: timer.totals[k] / n
                 for k in ("read", "psnr", "ssim", "crop", "lpips")}
    phase("eval", "seconds a frame on the card (StageTimer, "
          f"{n} frames of {full_w}x{full_h}): " + ", ".join(
              f"{k} {v:.4f}" for k, v in per_frame.items())
          + f", total {sum(per_frame.values()):.4f}; compute_fid over "
          f"{2 * n} crops {timer.totals['fid']:.3f} s ({card})")
    rng = np.random.default_rng(18)
    images = rng.random((EVAL_TIMED_IMAGES, EVAL_TIMED_SIDE,
                         EVAL_TIMED_SIDE, 3), dtype=np.float32)
    fid.features_of_images(inception, images[:EVAL_BATCH], EVAL_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = fid.features_of_images(inception, images, EVAL_BATCH)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / EVAL_TIMED_IMAGES
    batch = torch.from_numpy(images[:EVAL_BATCH]).cuda()
    dev_ms = cuda_ms(lambda: inception.features(batch), reps=8) / EVAL_BATCH
    phase("eval", eval_trace_check(inception, batch, dev_ms * EVAL_BATCH,
                                   tmp))
    # the trunk's convolution FLOPs an image, counted by PyTorch's
    # dispatcher at this input size (the resize and pools not counted)
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        inception.features(batch[:1])
    gflop = counter.get_total_flops() / 1e9
    half = EVAL_TIMED_IMAGES // 2
    s1 = fid.gaussian_stats(feats[:half], "cuda")
    s2 = fid.gaussian_stats(feats[half:], "cuda")
    fid.frechet_distance(*s1, *s2, device="cuda")
    t_fd = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fd = fid.frechet_distance(*s1, *s2, device="cuda")
        t_fd.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    phase("eval", f"Inception features at batch {EVAL_BATCH} over "
          f"{EVAL_TIMED_IMAGES} seeded {EVAL_TIMED_SIDE}^2 images: "
          f"{wall_ms:.3f} ms/image with the host-to-card copies "
          f"(features_of_images), {dev_ms:.3f} ms/image of device time "
          f"(CUDA events); its convolutions {gflop:.3f} GFLOP an image "
          f"(FlopCounterMode), {gflop / dev_ms:.2f} TFLOP/s at that time, "
          f"{100 * gflop / dev_ms * 1e12 / FP32_OPS_PER_S:.1f}% of the FP32 "
          f"peak; Fréchet distance at 2048 dimensions "
          f"{statistics.median(t_fd):.4f} s median of "
          f"{['%.4f' % t for t in t_fd]} (value {fd:.6f}); peak memory "
          f"while scoring {peak_gb:.2f} GiB ({card})")
    if not (math.isfinite(fd) and torch.isfinite(feats).all()):
        raise AssertionError("eval: non-finite timed features")
    del inception, inception_cpu, lp_card, batch, feats


def template_phase(card: str, records: list) -> None:
    """Phase 17: the template stack as a user runs it on a full-width
    capture of its own (see the module docstring); adds each kernel's
    launches in the template CLI's run (none) to its record as
    ``template_launches``."""
    import glob

    import yaml

    import main_template_torch
    from animatablegaussians_torch.data import MvRgbDatasetAvatarReX
    from animatablegaussians_torch.ops import fir
    from animatablegaussians_torch.ops.rasterize.blend import (
        blend_backward, blend_tiles)
    from animatablegaussians_torch.ops.rasterize.expand import expand_pairs
    from animatablegaussians_torch.tools import capture_fixture as cf
    from animatablegaussians_torch.tools import gen_pos_maps as gpm
    from animatablegaussians_torch.tools import gen_weight_volume as gwv
    from animatablegaussians_torch.training import template_trainer as tt
    from animatablegaussians_torch.utils import cuda_build, exr

    dev = torch.device("cuda:0")
    cuda_build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="template-", dir=cuda_build.BUILD_ROOT)
    try:
        t0 = time.perf_counter()
        data_dir = os.path.join(tmp, "capture")
        smpl_path = cf.write_capture(data_dir, n_frames=TPL_FRAMES,
                                     body_scale=TPL_BODY_SCALE, **cf.FULL)
        # the hands at the canonical body's x extremes (write_mano)
        ds = MvRgbDatasetAvatarReX(data_dir, frame_range=[0, 1],
                                   smpl_model_path=smpl_path)
        sv = ds.cano_smpl["vertices"]
        sf = np.asarray(ds.smpl_model.faces, np.int64)
        sl = ds.smpl_model.data.lbs_weights.cpu().numpy()
        mano_dir = cf.write_mano(os.path.join(tmp, "mano"),
                                 n_verts_total=cf.FULL["n_verts"],
                                 cano_verts=sv)
        del ds
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "avatarrex_zzr", "template.yaml")
        with open(src) as fp:
            opt = yaml.safe_load(fp)
        opt["train"]["data"].update(
            data_dir=data_dir, used_cam_ids=[0, 1],
            frame_range=[0, TPL_FRAMES], smpl_model_path=smpl_path,
            mano_dir=mano_dir)
        opt["train"]["net_ckpt_dir"] = os.path.join(tmp, "ckpt")
        cfg = os.path.join(tmp, "template.yaml")
        with open(cfg, "w") as fp:
            yaml.safe_dump(opt, fp)
        phase("template", f"capture written in {time.perf_counter() - t0:.1f}"
              f" s: {TPL_FRAMES} frames x 2 cameras of {cf.FULL['img_w']}x"
              f"{cf.FULL['img_h']}, SMPL-X {cf.FULL['n_verts']} vertices / "
              f"{cf.FULL['n_faces']} faces (x {TPL_BODY_SCALE}), MANO maps "
              "at the x extremes; "
              f"configs/avatarrex_zzr/template.yaml: model {opt['model']}, "
              f"lr {opt['train']['lr']['network']}, loss weights "
              f"{opt['train']['loss_weight']}")

        # 1. the weight volume at TPL_RES^3 through the tool
        timings = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        vol_path = gwv.main(["-c", cfg, "--res", str(TPL_RES)],
                            timings=timings)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with np.load(vol_path) as f:
            vol = {k: f[k] for k in f.files}
        sums = np.abs(vol["diff_weight_volume"].sum(-1) - 1).max()
        phase("template", f"gen_weight_volume at {TPL_RES}^3 (100,000 "
              f"surface samples, SMPL-X as the template): {wall:.1f} s, of "
              "which " + ", ".join(f"{k} {v:.2f} s" for k, v in
                                   timings.items())
              + f"; peak {peak:.2f} GiB ({card}); diff weights' sums off 1"
              f" by at most {sums:.1e}")
        if not (all(np.isfinite(v).all() for v in vol.values())
                and vol["diff_weight_volume"].shape == (TPL_RES,) * 3 + (55,)
                and sums < 1e-4):
            raise AssertionError("template: bad weight volume")
        small = {}
        for d in (dev, "cpu"):
            t0 = time.perf_counter()
            small[str(d)] = gwv.build_weight_volume(
                sv, sf, sv, sf, sl, res=TPL_CHECK_RES,
                n_surface=TPL_CHECK_SURFACE, device=d)
            small[str(d) + "_s"] = time.perf_counter() - t0
        errs = {}
        for k in ("diff_weight_volume", "ori_weight_volume", "sdf_volume"):
            e = np.abs(small[str(dev)][k] - small["cpu"][k])
            e = e.reshape(TPL_CHECK_RES ** 3, -1).max(1)
            errs[k] = (float(e.max()), float((e > TPL_VOL_ATOL).mean()))
        phase("template", f"weight volume at {TPL_CHECK_RES}^3 from "
              f"{TPL_CHECK_SURFACE} samples, card ({small[str(dev) + '_s']:.2f}"
              f" s) against CPU ({small['cpu_s']:.2f} s): " + ", ".join(
                  f"{k} max {m:.2e}, share over {TPL_VOL_ATOL:g} {sh:.4f}"
                  for k, (m, sh) in errs.items())
              + f" (limit share {TPL_VOL_TIE_SHARE:g})")
        if max(sh for _, sh in errs.values()) > TPL_VOL_TIE_SHARE:
            raise AssertionError(f"template: weight volume card vs CPU "
                                 f"{errs}")
        del small

        # 2. the template CLI: warm-up and timed iterations, the export
        counted = (expand_pairs, blend_tiles, blend_backward,
                   fir.upfirdn2d_fir)
        for fn in counted:
            fn.launches = 0
        stamps, terms = [], []

        def on_step(it, t):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            terms.append({k: float(v) for k, v in t.items()})

        n_iter = TPL_WARMUP + TPL_TIMED
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = main_template_torch.main(["-c", cfg, "--max_iters",
                                        str(n_iter)], on_step=on_step)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = {fn.__name__: fn.launches for fn in counted}
        for r in records:
            r["template_launches"] = launches[r["name"]]
        for i, t in enumerate(terms):
            phase("template", f"iteration {i + 1}: " + ", ".join(
                f"{k} {v:.6f}" for k, v in t.items()))
        if len(terms) != n_iter or not all(
                math.isfinite(v) for t in terms for v in t.values()):
            raise AssertionError(f"template: {len(terms)} iterations, "
                                 "a loss not finite")
        it_ms = [(b - a) * 1e3 for a, b in
                 zip(stamps[TPL_WARMUP - 1:], stamps[TPL_WARMUP:])]
        tm = run.timings
        phase("template", f"main_template_torch --max_iters {n_iter}: "
              f"{wall:.1f} s; kernel launches {launches} (want 0 each: the "
              f"template path runs none of the port's kernels); median "
              f"{statistics.median(it_ms):.2f} ms/iteration with host I/O "
              f"over {len(it_ms)} after {TPL_WARMUP} warm-up "
              f"{['%.1f' % t for t in it_ms]}; export at (256, 256, 128): "
              f"SDF {tm['sdf_s']:.2f} s, marching cubes {tm['mcubes_s']:.2f}"
              f" s, PLY {tm['write_s']:.2f} s, {run.n_verts} vertices, "
              f"{run.n_faces} faces; peak {peak:.2f} GiB ({card})")
        if any(launches.values()) or not run.n_faces > 0:
            raise AssertionError(f"template: launches {launches}, "
                                 f"{run.n_faces} faces")

        smpl_lbs = run.dataset.smpl_model.data.lbs_weights.cpu().numpy()
        items = tt.template_items(run.dataset[0], smpl_lbs, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        bare = wall_ms(lambda: run.step(items, gen), 7)[2:]
        bare_med = statistics.median(bare)
        phase("template", f"bare step (items on the card): median "
              f"{bare_med:.2f} ms over 5 after 2 warm-up "
              f"{['%.1f' % t for t in bare]}; with host I/O +"
              f"{100 * (statistics.median(it_ms) / bare_med - 1):.1f}%; at "
              f"150,000 iterations (main_template.py's default) "
              f"{150_000 * statistics.median(it_ms) / 3.6e6:.1f} h")
        busy, rows, owners = device_profile(lambda: run.step(items, gen))
        print_profile("one template step", busy, rows, owners, bare_med)
        stages = template_stage_ms(run.net, run.step, items)
        phase("template", "stages of a step (device ms, CUDA events): "
              + ", ".join(f"{k} {v:.2f} ({100 * v / bare_med:.1f}%)"
                          for k, v in stages.items()))
        template_cpu_check(run, items, os.path.join(
            data_dir, "cano_weight_volume.npz"))
        del run, items
        torch.cuda.empty_cache()

        # 3. the pose maps from the exported template and the volume
        timings = {}
        t0 = time.perf_counter()
        out_dir = gpm.main(["-c", cfg], timings=timings)
        wall = time.perf_counter() - t0
        pos = exr.read_exr(os.path.join(out_dir, "cano_smpl_pos_map.exr"))
        lbs = np.load(os.path.join(out_dir, "init_pts_lbs.npy"))
        maps = sorted(glob.glob(os.path.join(out_dir, "0*.exr")))
        first = exr.read_exr(maps[0]) if maps else None
        covered = float((np.linalg.norm(pos, axis=-1) > 0).mean())
        row = float(np.abs(lbs.sum(1) - 1).max()) if len(lbs) else math.inf
        phase("template", f"gen_pos_maps: {wall:.1f} s, of which " + ", ".join(
            f"{k} {v:.2f} s" for k, v in timings.items())
            + f"; position map {pos.shape}, {100 * covered:.2f}% covered; "
            f"init_pts_lbs {lbs.shape}, row sums off 1 by at most {row:.1e};"
            f" {len(maps)} pose maps "
            f"{None if first is None else first.shape}")
        if not (pos.shape == (1024, 2048, 3) and covered > 0
                and lbs.shape == (int((np.linalg.norm(pos, axis=-1) > 0)
                                      .sum()), 55) and row < 1e-4
                and len(maps) == TPL_FRAMES
                and first.shape == (512, 1024, 3)):
            raise AssertionError("template: bad pose maps")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
        n_eval, n_cull, n_contrib = pair_work(rows, kb.gid, kb.starts, gx,
                                              W, H)
        phase("blend", f"this frame's blend work: {n_eval} (pixel, pair) "
              f"evaluations a walk over every pair makes (n_eval), {n_cull} "
              f"after the forward kernel's per-warp cull "
              f"({100 * n_cull / max(n_eval, 1):.1f}%), {n_contrib} "
              "contributions (n_contrib); no contribution culled")
        # rows, gids and ranges in; colour, depth and T_final out; the
        # operations of the contributing evaluations (a kernel that culls
        # can skip the others, so counting them would not bound it)
        fwd_bytes = blend_bytes(n_pts, total, gx, gy, W, H)
        b_ms, b_by = bound(fwd_bytes,
                           n_contrib * (OPS_EVAL + OPS_FWD_CONTRIB))
        old_ms, old_by = bound(fwd_bytes, n_eval * OPS_EVAL
                               + n_contrib * OPS_FWD_CONTRIB)
        phase("blend", f"bound {b_ms:.4f} ms ({b_by}; bytes and "
              f"contributions); the earlier figure, which charged every "
              f"evaluation: {old_ms:.4f} ms ({old_by})")
        records.append(dict(
            name="blend_tiles", route="cuda",
            source="animatablegaussians_torch/csrc/blend.cu",
            replaces="animatablegaussians_tpu/ops/rasterize/blend_pallas.py"
                     ":282 (_fwd_chunk_kernel) and :114 (_fwd_kernel)",
            bound_ms=b_ms, bound_by=b_by, bound_eval_ms=old_ms,
            library_ms=None, max_abs_err=max(errs.values()),
            n_eval=n_eval, n_cull=n_cull, n_contrib=n_contrib,
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
        # grad_rows out; the contributing evaluations' operations, as for
        # the forward
        bwd_bytes = (n_pts * 40 * 2 + total * 4 + (gx * gy + 1) * 8
                     + W * H * 5 * 4 * 2)
        b_ms, b_by = bound(bwd_bytes, n_contrib * (OPS_EVAL + OPS_BWD_CONTRIB))
        old_ms, old_by = bound(bwd_bytes, n_eval * OPS_EVAL
                               + n_contrib * OPS_BWD_CONTRIB)
        records.append(dict(
            name="blend_backward", route="cuda",
            source="animatablegaussians_torch/csrc/blend_bwd.cu",
            replaces="animatablegaussians_tpu/ops/rasterize/blend_pallas.py"
                     ":338 (_bwd_chunk_kernel) and :170 (_bwd_kernel)",
            bound_ms=b_ms, bound_by=b_by, bound_eval_ms=old_ms,
            library_ms=None, max_abs_err=float((g_k - g_p).abs().max()),
            ms=cuda_ms(lambda: blend_backward(*bargs), 20),
            device_ms=device_ms(lambda: blend_backward(*bargs), 10),
            plain_ms=cuda_ms(lambda: blend_backward_plain(*bargs), 3, 1)))
        phase("blend_bwd", f"kernel {records[-1]['ms']:.3f} ms, plain "
              f"{records[-1]['plain_ms']:.3f} ms, bound "
              f"{records[-1]['bound_ms']:.4f} ms ({b_by}; bytes and "
              f"contributions); the earlier figure, which charged every "
              f"evaluation: {old_ms:.4f} ms ({old_by})")
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

    # -- 15. the training entry point on a full-width capture --------------
    # -- 16. the animation entry point on that capture and checkpoint -----
    # -- 18. that capture's frames rendered and scored ---------------------
    del net, train_items, items, titems, batch, lpips, step_b, tkw, kw
    torch.cuda.empty_cache()
    cuda_build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="capture-", dir=cuda_build.BUILD_ROOT)
    try:
        driver_opt = driver_phase(card, step_med, records, tmp)
        torch.cuda.empty_cache()
        animate_phase(card, tmp, driver_opt, statistics.median(t_seq),
                      records)
        torch.cuda.empty_cache()
        eval_phase(card, tmp, driver_opt, records)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 17. the template stack on a capture of its own -------------------
    torch.cuda.empty_cache()
    template_phase(card, records)

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
