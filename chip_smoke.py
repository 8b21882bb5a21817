"""GPU smoke run of the PyTorch / CUDA port: the novel-pose render path,
the avatar train step, and the CNN's separable FIRs through their kernel in
the render (with mean hands and pose-map regeneration) and in the B = 2
batched train step and its scan; then the two entry points a user runs,
training and animation, on a full-width capture on disk, and the scoring
of that capture's frames; then the template stack that prepares a
subject, on a capture of its own; the StyleGAN2 family and one GAN step
with its R1 penalty, the second derivative through the FIR kernel; the
train path's routes: remat, the data-parallel step, random styles and
the training CLI under torchrun's variables; the generic 3DGS layer: SH
colours, densification and its Adam surgery; last, the loader-fed train
tool, the batched JPEG decode, the body-model families, the 2D feature
fields, the template losses and the generic trainer.

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
                iterations (launch counters reset just before: no splat
                or FIR kernel may launch, every nearest-face search goes
                through its kernel; finite losses; ms/iteration with
                host I/O, peak memory), the export at (256, 256, 128)
                (SDF and marching-cubes seconds, the mesh's size); the bare
                step, the device's busy share of one step, its stages'
                device ms (the body's and the hands' nearest-face
                searches, near_far_smpl, the root finding, the MLPs'
                forward and double backward, Adam); the nearest-face
                kernel (csrc/nearest_face.cu) against its plain version
                at the step's shapes (points that differ in any bit,
                kernel and plain ms, the bound, one launch a call); one
                step at 64 rays
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
 19. gan      - the StyleGAN2 family at the avatar heads' widths (512^2
                condition maps, 1024^2 out, style_dim 512, channel_max
                512): (a) DualStyleUNetV2 in modes base, add_dwt and wo_dwt
                and SWGANUnet, one B = 1 forward each with two styles mixed
                at the default inject_index and fixed noise, through the
                FIR kernel against through its plain version (bit for bit
                under cuDNN's deterministic algorithms; under the default
                ones the gap beside the kernel route's own run-to-run gap;
                the plain route launches no kernel), ms each way; (b)
                StyleGenerator(1024, n_mlp 8) forward and backward at
                B = 2, ms and peak memory; (c) one
                GAN step at B = 2: G the base net, D the Discriminator(1024,
                6 channels) on G's [front | back] output and seeded real
                maps; the D half's logistic loss and R1 penalty (a
                gradient of a gradient: the FIR's second derivative through
                ops/fir.py::_FIRGrad), Adam; the G half's non-saturating
                loss, Adam; step 0's losses and gradients per group through
                the kernel against the plain path (RTOL_LOSS, RTOL_GRAD),
                2 warm-up and 3 timed steps (launch counter reset just
                before: one step's launches each), ms/step, peak memory,
                the FIR launches of one step by direction (forward, first
                and second derivative, as fir_calls records them), the
                device's busy time of one step and the FIR kernel's share;
                (d) phase 11's comparison (fir_phase) on each distinct FIR
                call of the step, in each direction it ran (forward
                bitwise, both derivatives within RTOL_FIR), with the same
                times. The FIR record gains ``gan_launches``,
                ``gan_step_launches``, ``gan_device_ms``,
                ``gan_max_abs_err`` and the ``bwd2_`` keys.
 20. routes   - the train path's routes at full width (routes_phase): (a)
                remat: a B = 1 and a B = 2 step with remat against the
                same steps without it under deterministic cuDNN (losses
                RTOL_REMAT_LOSS, gradients RTOL_REMAT_GRAD a group), the
                remat step's FIR launches by direction (phase 9's plus
                the recompute's forwards, remat_fir_count), the render
                bit for bit; ms/step, device busy ms and peak memory for
                B = 1, 2, 4, 8 with and without remat (a B without remat
                skipped, printed, where the peak extrapolated from B = 2
                and 4 exceeds REMAT_PEAK_LIMIT_GIB); (b) the
                data-parallel step on a one-rank NCCL group: the
                reduction leaves the rank's gradients bit for bit, the
                step against make_train_step (losses bit for bit,
                gradients RTOL_DP_GRAD), the all-reduce's device time and
                bytes; (c) a B = 1 step with random_style, kernels against
                plain=True at phase 9's limits; (d) main_avatar_torch -m
                train with WORLD_SIZE=1 RANK=0 LOCAL_RANK=0 on phase 15's
                capture: an NCCL group, the rank on cuda:0, use_dp off,
                one epoch, epoch_latest's net.pt loaded strictly, the group
                torn down. The FIR record gains ``remat_step_launches``.
 21. gs3d     - the generic 3DGS layer on phase 3's 531,520 posed
                Gaussians at 1500x2048 (gs3d_phase), SH degree 3 (the DC
                term from the seeded colours, the rest seeded normals):
                (a) render(shs=, max_sh_degree=3) through the kernels
                against plain=True (ATOL_BLEND), n_pairs equal to the
                colors= route's on the same geometry, finite, covered,
                precompute_sh_colors on the card against the CPU; (b) one
                Adam step (the reference's learning rates) on seeded
                image, depth and mask cotangents, each field's gradient
                through blend_bwd.cu against plain=True (GS_RTOL_GRAD); (c)
                a densification round (clone, split, prune with the
                step's radii, reset_opacity; models/densify.py) from the
                step's view-space gradient norms, on the card and on the
                CPU with the same norms and split draws: counts equal,
                values within GS_RTOL_ROUND; (d) the Adam surgery after
                each step (grow_adam_state: kept rows' moments bit for
                bit, appended rows' zero, step kept), a step through the
                kernels against plain=True on the scene after the prune
                (opaque, at the new N) and after the reset, and one more
                Adam step; (e) mark_visible on the card against the CPU;
                (f) render ms with SH against colors=, forward + backward
                ms, the round's and the surgery's ms, peak memory, and a
                device profile of one step at each N (busy ms, idle
                share, the kernels' device ms). Each record
                gains ``gs3d_launches`` (counters reset just before (a),
                read after (d)).
 22. loader   - the slice that finished the port (loader_phase): (a)
                tools/bench_loader's loop on LOADER_FRAMES frames at
                1500x2048 written by its build_dataset, at B = 1 and B =
                2, LOADER_THREADS decode threads, LOADER_WARMUP +
                LOADER_TIMED steps: it/s, ms/step and the mean loader wait
                beside phase 9's and phase 20's bare steps; the first
                batch on the card equal to DiskDataset's read bit for
                bit; phase 9's (14's) launches a step, the counters reset
                just before each loop (records gain ``loader_launches``
                and ``loader_b2_launches``); finite losses; (b)
                DECODE_FILES JPEGs through decode_jpeg_batch at 1 and
                LOADER_THREADS threads against decode_jpeg bit for bit,
                ms an image and the codec; (c) SMPL, SMPL+H, MANO and
                FLAME at their real sizes from archives the phase writes,
                card against CPU at B = BODY_B, ms a forward; (d) a
                tri-plane sample of the fixture's 531,520 Gaussians, its
                backward and a gradient of a gradient, and UNet5 at nf
                UNET_NF on UNET_SIDE^2, card against CPU, ms; (e) the
                eleven template losses card against CPU, three
                BaseTrainer iterations with a checkpoint, TensorBoard and
                a resume bit for bit.

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

from animatablegaussians_torch.utils import profiling

# the launch counter (utils/profiling.counters) of each kernel wrapper
LAUNCH_COUNTER = {"expand_pairs": "expand.launches",
                  "blend_tiles": "blend.fwd.launches",
                  "blend_backward": "blend.bwd.launches",
                  "upfirdn2d_fir": "fir.launches",
                  "nearest_face": "nearest_face.launches"}


def reset_launches(fns) -> None:
    """Zeroes the launch counters of the kernel wrappers ``fns``."""
    profiling.reset_counters(*(LAUNCH_COUNTER[fn.__name__] for fn in fns))


def launch_count(fn) -> int:
    """The kernel wrapper ``fn``'s launches since its counter was reset."""
    return profiling.counters().get(LAUNCH_COUNTER[fn.__name__], 0)

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
# phase 19: the StyleGAN2 family at the avatar heads' widths
# (models/avatar.py:129-135): 512^2 condition maps in, 1024^2 out
GAN_KW = dict(inp_size=512, inp_ch=3, out_ch=3, out_size=1024,
              style_dim=512, n_mlp=2, channel_max=512)
# the GAN step's batch, its warm-up and timed steps, the R1 weight
# (StyleGAN2's gamma, as r1 / 2 * gamma) and Adam's settings (StyleGAN2's)
GAN_B, GAN_WARMUP, GAN_TIMED = 2, 2, 3
GAN_R1_GAMMA, GAN_LR, GAN_BETAS = 10.0, 2e-3, (0.0, 0.99)
# the host's draw of the default inject_index, seeded alike before each
# route's forward
GAN_INJECT_SEED = 19
# phase 20: the train path's routes. remat's steps against the same steps
# without it under cuDNN's deterministic algorithms: the forward is the
# same float32 arithmetic in the same order, so the losses may differ only
# by the rounding of their last sums; the gradients by the backward
# blend's atomics, which sum in a run-dependent order (phase 9's events of
# RTOL_GRAD cannot occur, the forward being identical)
RTOL_REMAT_LOSS, RTOL_REMAT_GRAD = 1e-6, 1e-4
# the batch sizes timed with and without remat, warm-up and timed steps
# each; a B without remat is skipped where the peak extrapolated linearly
# from the B = 2 and B = 4 readings exceeds this (of the card's 80 GB)
REMAT_BS, REMAT_WARMUP, REMAT_TIMED = (1, 2, 4, 8), 2, 3
REMAT_PEAK_LIMIT_GIB = 70.0
# the data-parallel step on a one-rank NCCL group against the single step
# (deterministic cuDNN): the losses bit for bit, the gradients as above;
# the all-reduce's device time over this many calls
RTOL_DP_GRAD, DP_ALLREDUCE_REPS = 1e-4, 10
# the launch path: steps of main_avatar_torch -m train under torchrun's
# variables for a world of one (one epoch of phase 15's capture)
ROUTES_CLI_STEPS = 2 * DRIVER_FRAMES
# phase 21: the generic 3DGS layer on phase 3's posed Gaussians. SH degree
# 3, the 3DGS default (16 coefficients a channel): the DC term from the
# seeded colours, the rest N(0, GS_REST_STD) from a seeded generator. The
# fixture's create_from_pcd scales are the same on the three axes, where a
# rotation moves nothing and its gradient is rounding noise (kernel and
# plain read 0.80 apart in relative L2 on the H100); N(0, GS_SCALE_JITTER)
# added to each log-scale makes the Gaussians anisotropic, as a fitted
# scene's are
GS_SH_DEGREE, GS_REST_STD, GS_SCALE_JITTER, GS_SEED = 3, 0.1, 0.2, 21
# Adam with the 3DGS reference's learning rates and eps (ref:
# arguments/__init__.py OptimizationParams, gaussian_model.py
# training_setup): position 0.00016 times the scene extent (set per run),
# the DC term 0.0025, the rest 0.0025 / 20, opacity 0.05, scaling 0.005,
# rotation 0.001
GS_LR = dict(features_dc=2.5e-3, features_rest=2.5e-3 / 20, opacity=0.05,
             scaling=5e-3, rotation=1e-3)
GS_XYZ_LR, GS_EPS = 1.6e-4, 1e-15
# the densification round: the gradient threshold is this quantile of the
# visible Gaussians' view-space gradient norms, lowered to the median norm
# of the visible large ones (max scale > GS_PERCENT_DENSE x the extent), and
# of the small ones, where that is lower, so that both the split and the
# clone select rows (the fixture has few large Gaussians: by a k-d tree's
# distances, 8 of its 517,832 at 1024^2); the prune's limits (the
# reference's defaults: min opacity 0.005, 20 pixels on screen)
GS_GRAD_QUANTILE, GS_PERCENT_DENSE = 0.9, 0.01
GS_MIN_OPACITY, GS_MAX_SCREEN, GS_SPLIT_SEED = 0.005, 20, 22
# samples a split Gaussian becomes (the reference's N = 2)
GS_N_SPLIT = 2
# the port's kernels on phase 21's path, as the device profile names them
GS_KERNEL_NAMES = ("expand_pairs_kernel", "tile_order_kernel",
                   "blend_forward_kernel", "blend_backward_kernel")
# the card against the CPU on the same inputs, each value relative to the
# largest magnitude of its field (floor 1): the round's fields pass
# through exp and log (scaling) and sigmoid and its inverse (opacity),
# whose last bits the two devices' libm round apart; the SH colours (the
# norms of the directions, summed in another order)
GS_RTOL_ROUND, GS_ATOL_SH = 1e-6, 1e-6
# phase 21's gradients, kernel path against plain path, relative L2 per
# field. No CNN is on this path (RTOL_GRAD's events do not occur): only
# the backward kernel's atomics and the plain version's scan order set
# the two apart. On the H100 the fields read 1.2e-7 to 1.4e-6, at 531,520
# and 790,332 Gaussians; this limit keeps two orders of magnitude above
# that and still fails a fault of 0.01% in any field's gradient
GS_RTOL_GRAD = 1e-4
# kernel launches of phase 21's checked part: the SH render and the
# colors= render (a), the kernel step (b), and the steps after the prune
# and after the reset (d)
GS_LAUNCHES = dict(expand_pairs=5, blend_tiles=5, blend_backward=3)
GS_TIMED = 5
# phase 22: the loader-fed train path (tools/bench_loader) on a dataset of
# LOADER_FRAMES frames at 1500x2048 (the JAX tool's default is 24; 8 give
# B = 2 four batches an epoch), LOADER_THREADS decode threads,
# LOADER_WARMUP + LOADER_TIMED steps at B = 1 and B = 2
LOADER_FRAMES, LOADER_THREADS = 8, 8
LOADER_WARMUP, LOADER_TIMED = 3, 10
# (b) JPEGs of the batch decode, and its timed repeats
DECODE_FILES, DECODE_REPS = 16, 3
# (c) the body-model families' batch, and the card against the CPU, each
# output's largest error over its largest magnitude: float32 einsums and
# matmuls (TF32 off) summed in another order
BODY_B, BODY_RTOL = 64, 1e-5
# (d) the tri-plane field: 32 channels a plane at 256^2; the card against
# the CPU relative to each output's largest magnitude: the same float32
# arithmetic a point, but the gradients to the planes are scatter sums
# whose order the card's atomics set; UNet5's cuDNN and CPU convolutions
FEAT_DIM, FEAT_SIZE, FEAT_RTOL = 32, 256, 1e-4
UNET_NF, UNET_SIDE, UNET_RTOL = 64, 512, 1e-4
# (e) the losses and their gradients, card against CPU
LOSS_RTOL = 1e-5
# a generator's forward through the FIR kernel against through its plain
# version is held bit for bit under cuDNN's deterministic algorithms: every
# FIR launch of it equals its plain version bit for bit, and deterministic
# cuDNN sums equal inputs alike. Under the default algorithms the same
# route run twice already differs by 7.2e-7 to 1.42e-6 of the output's
# largest |value| (NVIDIA H100 80GB HBM3, 700 W: the four generators over
# the runs PERF.md lists), so that gap is printed beside the route's own
# run-to-run gap, not held


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


def device_busy(fn):
    """The summed device time (ms) of the kernels and copies ``fn``
    launches, as ``device_profile`` sums it, from a profile of the device
    alone: no host ops, shapes or launching ops, which took most of a
    profiled B = 8 step's 23-31 s there and leave the sum unchanged
    (within 0.2%, H100). None if the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages()
               if e.device_type != DeviceType.CPU
               and not getattr(e, "is_user_annotation", False)) / 1e3
    return busy or None


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
    ``ops/fir.py``'s ``_launch`` and its two derivative entries, as (key,
    order, grad): key the forward call's (input shape, taps, up, down,
    pad); order 0 for a forward, 1 for a first derivative
    (``_launch_grad``, the transposed call on a cotangent), 2 for a second
    (``_launch_grad2``, the forward call again on the cotangent of a first
    derivative's output); grad whether the launch's input carries a
    gradient."""
    from animatablegaussians_torch.ops import fir
    saved = fir._launch, fir._launch_grad, fir._launch_grad2
    calls, within = [], []

    def launch(x, kv, kh, up, down, pad):
        if within:
            order, (hw, *args) = within[-1]
            key = (tuple(x.shape[:2]) + tuple(hw), *args)
        else:
            order = 0
            key = (tuple(x.shape), tuple(kv), tuple(kh), up, down,
                   tuple(pad))
        calls.append((key, order, x.requires_grad))
        return saved[0](x, kv, kh, up, down, pad)

    def derivative(order, entry):
        def recorded(g, args):
            within.append((order, args))
            try:
                return entry(g, args)
            finally:
                within.pop()
        return recorded

    fir._launch = launch
    fir._launch_grad = derivative(1, saved[1])
    fir._launch_grad2 = derivative(2, saved[2])
    try:
        yield calls
    finally:
        fir._launch, fir._launch_grad, fir._launch_grad2 = saved


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
def heads_eager():
    """The heads run eagerly in the block: a forward pre-hook on every
    module, which changes nothing, keeps ``AvatarNet`` from replaying the
    heads' CUDA graph (``models/heads_graph.py``), whose FIRs were captured
    through the kernel."""
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda mod, args: None)
    try:
        yield
    finally:
        hook.remove()


@contextlib.contextmanager
def fir_through_library():
    """The port's FIRs through ``fir_library`` for the block (phase 12's
    path-level comparison), the heads run eagerly."""
    from animatablegaussians_torch.ops import fir
    inner = fir.upfirdn2d_fir
    fir.upfirdn2d_fir = fir_library
    try:
        with heads_eager():
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


# fir_phase's directions: (the JSON record's key prefix, the printed name)
FIR_DIRECTIONS = (("", "forward"), ("bwd_", "first derivative"),
                  ("bwd2_", "second derivative"))


def fir_phase(calls, card: str, dev, step: bool = False) -> dict:
    """The FIR kernel against its plain version and the library call at
    each distinct call of ``calls`` (``fir_calls`` records). Phase 11's are
    one train forward's: each call whose input carries a gradient counts
    one first derivative (the autograd VJP). Phase 19's are a whole GAN
    step's (``step``): the derivatives counted are those the step
    launched, second ones included (the gradient of the VJP with respect
    to its cotangent, through ``_FIRGrad``; the library's is its forward
    call on the cotangent's cotangent, one call that computes the same
    function). For each call and direction: the forward bitwise against
    the plain version, the derivatives within RTOL_FIR of autograd through
    it; the kernel's device time (``device_ms``), its time launch to
    launch (CUDA events over 20 back-to-back calls, which include the
    host's cost where the card waits for it), the host's time per call,
    the plain version's and the library call's times and the bound (input
    + output bytes over the memory rate). Returns the kernel's JSON
    record: sums over the counted calls of each direction, keys prefixed
    as ``FIR_DIRECTIONS`` says, and the largest |kernel - plain|."""
    from animatablegaussians_torch.ops.fir import (grad_pads, upfirdn2d_fir,
                                                   upfirdn2d_fir_plain)
    counts = {}
    for key, order, grad in calls:
        n = counts.setdefault(key, [0, 0, 0])
        n[order] += 1
        if not step and order == 0 and grad:
            n[1] += 1
    gen = torch.Generator(device=dev).manual_seed(4)
    names = ("ms", "device_ms", "host_ms", "plain_ms", "library_ms",
             "library_device_ms", "bound_ms")
    tot = [dict.fromkeys(names, 0.0) for _ in FIR_DIRECTIONS]
    routes = (upfirdn2d_fir, upfirdn2d_fir_plain, fir_library)
    worst = 0.0
    for (shape, kv, kh, up, down, pad), n in counts.items():
        args = (kv, kh, up, down, pad)
        x = torch.randn(shape, generator=gen, device=dev)
        yk, yp = upfirdn2d_fir(x, *args), upfirdn2d_fir_plain(x, *args)
        yl = fir_library(x, *args)
        fwd_abs = float((yk - yp).abs().max())
        lib_err = float((yl - yp).abs().max() / yp.abs().max())
        g = torch.randn(yk.shape, generator=gen, device=dev)
        r = torch.randn(shape, generator=gen, device=dev)
        xs = [x.clone().requires_grad_(True) for _ in routes]
        gs = [g.clone().requires_grad_(bool(n[2])) for _ in routes]
        outs = [fn(xi, *args) for fn, xi in zip(routes, xs)]
        firsts = [torch.autograd.grad(o, xi, gi, retain_graph=True,
                                      create_graph=bool(n[2]))[0]
                  for o, xi, gi in zip(outs, xs, gs)]
        errs = [0.0, 0.0, 0.0]
        pairs = [(1, firsts[:2])]
        if n[2]:
            pairs.append((2, [torch.autograd.grad(f, gi, r,
                                                  retain_graph=True)[0]
                              for f, gi in zip(firsts[:2], gs)]))
        for d, (k, p) in pairs:
            e = float((k - p).detach().abs().max())
            worst = max(worst, e)
            errs[d] = e / float(p.detach().abs().max())
        worst = max(worst, fwd_abs)
        if not (torch.equal(yk, yp) and max(errs) <= RTOL_FIR):
            raise AssertionError(
                f"FIR kernel disagrees with plain at {shape} up {up} down "
                f"{down} pad {pad}: forward max |diff| {fwd_abs} (want "
                f"0), derivatives {errs[1:]} (limit {RTOL_FIR:g})")
        fns = [[lambda fn=fn: fn(x, *args) for fn in routes],
               [lambda o=o, xi=xi: torch.autograd.grad(
                   o, xi, g, retain_graph=True) for o, xi in zip(outs, xs)]]
        if n[2]:
            fns.append([lambda f=f, gi=gi: torch.autograd.grad(
                f, gi, r, retain_graph=True)
                for f, gi in zip(firsts[:2], gs)]
                + [lambda: fir_library(r, *args)])
        # a forward or second derivative reads x's shape and writes y's, a
        # first derivative the other way round
        moved = (x.numel() + yk.numel()) * 4
        gpad = grad_pads(shape[2:], len(kv), len(kh), up, down, pad)
        phase("fir", f"{tuple(shape)} up {up} down {down} pad {pad} -> "
              f"{tuple(yk.shape[1:])}, launched {n[0]}x / {n[1]}x / "
              f"{n[2]}x (forward / first / second derivative): fwd "
              f"bitwise equal, library rel err {lib_err:.1e}; first (pad "
              f"{gpad}) rel err {errs[1]:.1e}"
              + (f"; second rel err {errs[2]:.1e}" if n[2] else ""))
        for d, (_, label) in enumerate(FIR_DIRECTIONS):
            if not n[d]:
                continue
            k, p, lib = fns[d]
            v = dict(ms=cuda_ms(k, 20), device_ms=device_ms(k, 10),
                     host_ms=host_ms(k, 20), plain_ms=cuda_ms(p, 5),
                     library_ms=cuda_ms(lib, 20),
                     library_device_ms=device_ms(lib, 10),
                     bound_ms=bound(moved)[0])
            phase("fir", f"    {label}: kernel device {v['device_ms']:.4f} "
                  f"ms, launch to launch {v['ms']:.4f}, host "
                  f"{v['host_ms']:.4f}; library device "
                  f"{v['library_device_ms']:.4f}, launch to launch "
                  f"{v['library_ms']:.4f}; plain {v['plain_ms']:.4f}; bound "
                  f"{v['bound_ms']:.4f}")
            for key in names:
                tot[d][key] += n[d] * v[key]
    rec = dict(name="upfirdn2d_fir", route="cuda",
               source="animatablegaussians_torch/csrc/fir.cu",
               replaces="animatablegaussians_tpu/ops/fir_pallas.py:180 "
                        "(_vhfir_kernel; pl.pallas_call at :231)",
               bound_by="bytes", max_abs_err=worst)
    for d, (prefix, label) in enumerate(FIR_DIRECTIONS):
        k = sum(n[d] for n in counts.values())
        if not k:
            continue
        v = tot[d]
        phase("fir", f"{label}: {k} launches over "
              f"{sum(1 for n in counts.values() if n[d])} distinct calls: "
              f"kernel device {v['device_ms']:.3f} ms, launch to launch "
              f"{v['ms']:.3f}, host {v['host_ms']:.3f}; library device "
              f"{v['library_device_ms']:.3f}, launch to launch "
              f"{v['library_ms']:.3f}; plain {v['plain_ms']:.3f}; bound "
              f"{v['bound_ms']:.3f} ({card})")
        rec.update({prefix + key: val for key, val in v.items()})
    return rec


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
    reset_launches(counted)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = main_avatar_torch.main(argv, num_epochs=1)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {fn.__name__: launch_count(fn) for fn in counted}
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
            reset_launches(counted)
            t0 = time.perf_counter()
            trainer = main_avatar_torch.main(["-c", cfg, "-m", "test"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            launches = {fn.__name__: launch_count(fn) for fn in counted}
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


def template_samples(net, step, items) -> torch.Tensor:
    """The template step's samples on ``items``' rays (rays x samples,
    3), from the SMPL-guided near/far, without the depth jitter."""
    from animatablegaussians_torch.utils import nerf as nerf_util

    with torch.no_grad():
        near, far = net.smpl_guided_near_far(items, items["ray_o"],
                                             items["ray_d"], items["near"],
                                             items["far"])
        pts, _ = nerf_util.sample_pts_on_rays(
            items["ray_o"], items["ray_d"], near, far, step.n_samples)
    return pts.reshape(-1, 3)


def template_stage_ms(net, step, items, reps: int = 3) -> dict:
    """Device ms (CUDA events, mean of ``reps`` after one warm-up) of the
    template step's stages on ``items``' rays: the body's and the hands'
    nearest-face searches (the kernel), the SMPL-sphere near/far, the root
    finding, the MLPs' forward with the eikonal normal and its double
    backward, and Adam."""
    from animatablegaussians_torch.ops import geometry3d as g3d
    from animatablegaussians_torch.ops.root_finding import root_finding

    flat = template_samples(net, step, items)
    with torch.no_grad():
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


def nearest_face_check(net, step, items) -> dict:
    """The nearest-face kernel (``csrc/nearest_face.cu``) against
    ``nearest_face_plain`` on the card at the template step's shapes: the
    step's samples on ``items``' rays against the live body, each live
    hand (the left one's faces flipped, as ``fuse_hands`` does) and a
    closed hand of MANO's 778 vertices and 1,552 faces beside the right
    one (the template cell's hand, ``portbench/template_inputs.ellipsoid``:
    the capture's hands have 20 faces). Per
    search: points whose distance, face or weights differ in any bit, the
    kernel's and the plain version's device ms (CUDA events), the bound
    (48 FP32 operations a pair at 67 TFLOP/s, the benchmark's count) and
    one launch a call. Returns the kernel's JSON record."""
    from animatablegaussians_torch.ops import geometry3d as g3d
    from portbench.template_inputs import ellipsoid

    flat = template_samples(net, step, items)
    faces = items["mano_face_closed"]
    hv, hf = ellipsoid(items["right_live_mano_v"].mean(0).cpu().numpy(),
                       np.array([0.09, 0.03, 0.045]) * TPL_BODY_SCALE, "x",
                       97, 9)
    searches = {
        "body": (items["live_smpl_v"], items["smpl_faces"]),
        "left hand": (items["left_live_mano_v"], torch.flip(faces, [1])),
        "right hand": (items["right_live_mano_v"], faces),
        "a hand at MANO's counts": (
            torch.as_tensor(hv, dtype=torch.float32, device=flat.device),
            torch.as_tensor(hf, device=flat.device))}
    bits = (lambda t: t.view(torch.int32))
    rows = {}
    for name, (v, f) in searches.items():
        reset_launches([g3d.nearest_face])
        profiling.reset_counters("nearest_face.calls")
        got = g3d.nearest_face(flat, v, f)
        want = g3d.nearest_face_plain(flat, v, f)
        calls = profiling.counters().get("nearest_face.calls", 0)
        launches = launch_count(g3d.nearest_face)
        bad = ((bits(got[0]) != bits(want[0])) | (got[1] != want[1])
               | (bits(got[2]) != bits(want[2])).any(-1))
        pairs = flat.shape[0] * f.shape[0]
        rows[name] = r = dict(
            pairs=pairs, mismatching=int(bad.sum()),
            max_d=float((got[0] - want[0]).abs().max()),
            max_bary=float((got[2] - want[2]).abs().max()),
            launches=launches, calls=calls,
            ms=cuda_ms(lambda: g3d.nearest_face(flat, v, f), 10),
            plain_ms=cuda_ms(lambda: g3d.nearest_face_plain(flat, v, f), 1,
                             warmup=1),
            bound_ms=bound(0.0, pairs * 48.0)[0])
        phase("nearest_face", f"{name}: {flat.shape[0]} points x "
              f"{f.shape[0]} faces, kernel against nearest_face_plain: "
              f"{r['mismatching']} points differ in a bit (max |d| "
              f"{r['max_d']:.3e}, max |weights| {r['max_bary']:.3e}); "
              f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.4f} ms (operations, "
              f"{100 * r['bound_ms'] / r['ms']:.2f}%); launches "
              f"{launches} = calls {calls}: {launches == calls}")
    if any(r["mismatching"] or r["launches"] != r["calls"]
           for r in rows.values()):
        raise AssertionError(f"nearest_face kernel vs plain: {rows}")
    total = {k: sum(r[k] for r in rows.values())
             for k in ("ms", "plain_ms", "bound_ms")}
    phase("nearest_face", f"the four searches: kernel {total['ms']:.3f} "
          f"ms, plain {total['plain_ms']:.3f} ms, bound "
          f"{total['bound_ms']:.4f} ms")
    return dict(
        name="nearest_face", route="cuda",
        source="animatablegaussians_torch/csrc/nearest_face.cu",
        replaces="none: the JAX package's search is plain jnp; the "
                 "published CUDA op utils/posevocab_custom_ops/"
                 "nearest_face.py:30-61",
        bound_ms=total["bound_ms"], bound_by="operations", library_ms=None,
        max_abs_err=max(max(r["max_d"], r["max_bary"])
                        for r in rows.values()),
        ms=total["ms"], plain_ms=total["plain_ms"], searches=rows)


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
    reset_launches(counted)
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
    launches = {fn.__name__: launch_count(fn) for fn in counted}
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
    reset_launches(counted)
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
    launches = {fn.__name__: launch_count(fn) for fn in counted}
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


def template_phase(card: str, records: list) -> dict:
    """Phase 17: the template stack as a user runs it on a full-width
    capture of its own (see the module docstring); adds each kernel's
    launches in the template CLI's run (none) to its record as
    ``template_launches``, and returns the nearest-face kernel's record
    (``nearest_face_check``) with its launches in that run."""
    import glob

    import yaml

    import main_template_torch
    from animatablegaussians_torch.data import MvRgbDatasetAvatarReX
    from animatablegaussians_torch.ops import fir
    from animatablegaussians_torch.ops import geometry3d as g3d
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
        reset_launches(counted + (g3d.nearest_face,))
        profiling.reset_counters("nearest_face.calls")
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
        launches = {fn.__name__: launch_count(fn) for fn in counted}
        nf_launches = launch_count(g3d.nearest_face)
        nf_calls = profiling.counters().get("nearest_face.calls", 0)
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
              f"template path runs no splat or FIR kernel), nearest_face "
              f"{nf_launches} of {nf_calls} calls (want all); median "
              f"{statistics.median(it_ms):.2f} ms/iteration with host I/O "
              f"over {len(it_ms)} after {TPL_WARMUP} warm-up "
              f"{['%.1f' % t for t in it_ms]}; export at (256, 256, 128): "
              f"SDF {tm['sdf_s']:.2f} s, marching cubes {tm['mcubes_s']:.2f}"
              f" s, PLY {tm['write_s']:.2f} s, {run.n_verts} vertices, "
              f"{run.n_faces} faces; peak {peak:.2f} GiB ({card})")
        if (any(launches.values()) or not nf_launches == nf_calls > 0
                or not run.n_faces > 0):
            raise AssertionError(f"template: launches {launches}, "
                                 f"nearest_face {nf_launches} of "
                                 f"{nf_calls}, {run.n_faces} faces")

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
        nf_record = nearest_face_check(run.net, run.step, items)
        nf_record["template_launches"] = nf_launches
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
    return nf_record


def gan_phase(card: str, records: list) -> None:
    """Phase 19: the StyleGAN2 family at the avatar heads' widths
    (``GAN_KW``). (a) Each generator's forward at B = 1 (DualStyleUNetV2
    in its three modes, SWGANUnet), two styles mixed at the default
    inject_index and fixed noise, through the FIR kernel against through
    its plain version (bit for bit under deterministic cuDNN), ms each
    way. (b) StyleGenerator at
    1024^2 (n_mlp 8), forward and backward at B = GAN_B: ms and peak
    memory. (c) One GAN step at B = GAN_B: G the base DualStyleUNetV2, D
    the Discriminator on G's 6-channel [front | back] output and on seeded
    real maps; the D half d_logistic_loss + GAN_R1_GAMMA / 2 * d_r1_loss
    (the R1 penalty: the second derivative through the FIR kernel), an
    Adam step, the G half g_nonsaturating_loss, an Adam step. Step 0's
    losses and gradients per group through the kernel against the plain
    path (RTOL_LOSS, RTOL_GRAD), then GAN_WARMUP + GAN_TIMED steps:
    ms/step, peak memory, the FIR launches of one step by direction, the
    device's busy time under torch.profiler and the FIR kernel's share of
    it. (d) ``fir_phase`` on that step's ``fir_calls`` records. The FIR
    record gains the timed steps' launches (``gan_launches``), one step's
    by direction with their device times, the second derivative's times
    (``bwd2_*``) and the step's largest |kernel - plain|."""
    import random

    from animatablegaussians_torch.models.discriminator import Discriminator
    from animatablegaussians_torch.models.stylegan import StyleGenerator
    from animatablegaussians_torch.models.styleunet_v2 import (
        DualStyleUNetV2, SWGANUnet)
    from animatablegaussians_torch.ops import fir
    from animatablegaussians_torch.training import losses as tl

    t_phase = time.perf_counter()
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(19)

    def build(cls, seed, **kw):
        net = cls(generator=torch.Generator().manual_seed(seed), device=dev,
                  **kw)
        with torch.no_grad():            # the noise weights start at zero
            for name, p in net.named_parameters():
                if name.endswith("noise.weight"):
                    p.fill_(0.1)
        return net

    # (a) each generator's forward through the kernel and the plain version
    cond = torch.randn((1, GAN_KW["inp_size"], GAN_KW["inp_size"], 3),
                       generator=gen, device=dev)
    styles = [torch.randn((1, GAN_KW["style_dim"]), generator=gen,
                          device=dev) for _ in range(2)]
    G = None
    for i, (label, cls, kw) in enumerate((
            ("DualStyleUNetV2 base", DualStyleUNetV2, dict(mode="base")),
            ("DualStyleUNetV2 add_dwt", DualStyleUNetV2,
             dict(mode="add_dwt")),
            ("DualStyleUNetV2 wo_dwt", DualStyleUNetV2, dict(mode="wo_dwt")),
            ("SWGANUnet", SWGANUnet, {}))):
        net = build(cls, 100 + i, **GAN_KW, **kw)
        noise = net.make_noise(gen)

        def fwd(plain, net=net, noise=noise):
            random.seed(GAN_INJECT_SEED)
            with torch.no_grad():
                return net(styles, cond, noise=noise, plain=plain)[0]

        torch.backends.cudnn.deterministic = True
        reset_launches([fir.upfirdn2d_fir])
        out_k = fwd(False)
        n_k = launch_count(fir.upfirdn2d_fir)
        out_p = fwd(True)
        n_p = launch_count(fir.upfirdn2d_fir) - n_k
        torch.backends.cudnn.deterministic = False
        scale = float(out_p.abs().max())

        def gap(a, b):
            return float((a - b).abs().max()) / scale

        k1, k2, p1 = fwd(False), fwd(False), fwd(True)
        random.seed(GAN_INJECT_SEED)
        index = random.randint(1, net.n_latent - 1)
        want = (1, GAN_KW["out_size"], GAN_KW["out_size"],
                GAN_KW["out_ch"] * len(net.BRANCHES))
        ms_k, ms_p = (cuda_ms(lambda p=p: fwd(p), 5, 2)
                      for p in (False, True))
        phase("gan", f"{label}: {sum(p.numel() for p in net.parameters())} "
              f"parameters, inject_index {index} of {net.n_latent}; "
              f"{tuple(out_k.shape)}, {n_k} FIR launches (plain route "
              f"{n_p}); kernel vs plain under deterministic cuDNN: "
              f"{'bit for bit' if torch.equal(out_k, out_p) else 'DIFFER'}"
              f"; under the default algorithms max |diff| / max |plain| "
              f"{gap(k1, p1):.2e} (the kernel route twice {gap(k1, k2):.2e})"
              f"; {ms_k:.2f} ms a forward through the kernel, {ms_p:.2f} "
              f"plain ({card})")
        if not (tuple(out_k.shape) == want and scale > 0
                and bool(torch.isfinite(out_k).all()) and n_k > 0
                and n_p == 0 and torch.equal(out_k, out_p)):
            raise AssertionError(f"{label}: forward through the kernel "
                                 f"disagrees or is malformed")
        if kw.get("mode") == "base":
            G = net
        del net, out_k, out_p, k1, k2, p1, fwd
        torch.cuda.empty_cache()

    # (b) StyleGenerator at 1024^2, forward and backward
    sg = build(StyleGenerator, 110, size=GAN_KW["out_size"],
               style_dim=GAN_KW["style_dim"], n_mlp=8, channel_multiplier=2)
    z = [torch.randn((GAN_B, GAN_KW["style_dim"]), generator=gen,
                     device=dev)]
    sg_noise = sg.make_noise(gen)

    def sg_step():
        sg.zero_grad(set_to_none=True)
        img = sg(z, noise=sg_noise)[0]
        img.square().mean().backward()
        return img

    img = sg_step()
    if not (tuple(img.shape) == (GAN_B, GAN_KW["out_size"],
                                 GAN_KW["out_size"], 3)
            and bool(torch.isfinite(img).all())
            and all(bool(torch.isfinite(p.grad).all())
                    for p in sg.parameters() if p.grad is not None)):
        raise AssertionError("StyleGenerator: malformed or non-finite")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sg_ms = cuda_ms(sg_step, 3, 1)
    phase("gan", f"StyleGenerator(1024, n_mlp 8): "
          f"{sum(p.numel() for p in sg.parameters())} parameters; forward "
          f"+ backward at B = {GAN_B}: {sg_ms:.2f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})")
    del sg, img, sg_noise
    torch.cuda.empty_cache()

    # (c) one GAN step: D half (logistic + R1, Adam), G half (Adam)
    D = build(Discriminator, 120, size=GAN_KW["out_size"],
              img_channel=2 * GAN_KW["out_ch"],
              channel_max=GAN_KW["channel_max"])
    side = GAN_KW["inp_size"]
    cond_b = torch.randn((GAN_B, side, side, 3), generator=gen, device=dev)
    z_b = [torch.randn((GAN_B, GAN_KW["style_dim"]), generator=gen,
                       device=dev)]
    real = torch.randn((GAN_B, GAN_KW["out_size"], GAN_KW["out_size"],
                        2 * GAN_KW["out_ch"]), generator=gen, device=dev)
    noise = G.make_noise(gen)

    def d_half(plain):
        D.requires_grad_(True)
        D.zero_grad(set_to_none=True)
        with torch.no_grad():
            fake = G(z_b, cond_b, noise=noise, plain=plain)[0]
        d_loss = tl.d_logistic_loss(D(real, plain=plain),
                                    D(fake, plain=plain))
        r1 = tl.d_r1_loss(lambda x: D(x, plain=plain), real)
        (d_loss + GAN_R1_GAMMA / 2 * r1).backward()
        return {"d_logistic": d_loss.detach(), "r1": r1.detach()}

    def g_half(plain):
        D.requires_grad_(False)
        G.zero_grad(set_to_none=True)
        fake = G(z_b, cond_b, noise=noise, plain=plain)[0]
        g_loss = tl.g_nonsaturating_loss(D(fake, plain=plain))
        g_loss.backward()
        return {"g_nonsaturating": g_loss.detach()}

    def halves(plain):
        terms = d_half(plain)
        g_d = grad_snapshot(D)
        terms.update(g_half(plain))
        return terms, g_d, grad_snapshot(G)

    t_k, gd_k, gg_k = halves(False)
    t_p, gd_p, gg_p = halves(True)
    loss_err = {k: abs(float(t_k[k]) - float(t_p[k]))
                / max(abs(float(t_p[k])), 1e-30) for k in t_p}
    grad_err = {**{f"G.{g}": e for g, e in grad_errors(G, gg_k,
                                                       gg_p).items()},
                **{f"D.{g}": e for g, e in grad_errors(D, gd_k,
                                                       gd_p).items()}}
    phase("gan", f"step 0 at B = {GAN_B}, kernel path vs plain path: loss "
          "terms " + ", ".join(f"{k} {float(t_k[k]):.6f} (rel {e:.1e})"
                               for k, e in loss_err.items())
          + f" (limit {RTOL_LOSS:g}); gradients " + ", ".join(
              f"{g} {e:.2e}" for g, e in grad_err.items())
          + f" (limit {RTOL_GRAD:g})")
    if not (all(math.isfinite(float(v)) for v in t_k.values())
            and max(loss_err.values()) <= RTOL_LOSS
            and max(grad_err.values()) <= RTOL_GRAD):
        raise AssertionError("GAN step: kernel path disagrees with plain")
    del gd_k, gg_k, gd_p, gg_p

    g_opt = torch.optim.Adam(G.parameters(), lr=GAN_LR, betas=GAN_BETAS)
    d_opt = torch.optim.Adam(D.parameters(), lr=GAN_LR, betas=GAN_BETAS)

    def step():
        terms = d_half(False)
        d_opt.step()
        terms.update(g_half(False))
        g_opt.step()
        return terms

    def check(i, terms):
        vals = {k: float(v) for k, v in terms.items()}
        phase("gan", f"step {i}: " + ", ".join(f"{k} {v:.6f}"
                                               for k, v in vals.items()))
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"GAN step {i}: non-finite {vals}")

    for i in range(GAN_WARMUP):
        check(i, step())
    with fir_calls() as launches:
        check(GAN_WARMUP, step())
    by_dir = {label: sum(1 for _, order, _ in launches if order == d)
              for d, (_, label) in enumerate(FIR_DIRECTIONS)}
    reset_launches([fir.upfirdn2d_fir])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_gan = []
    for i in range(GAN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        terms = step()
        torch.cuda.synchronize()
        t_gan.append((time.perf_counter() - t0) * 1e3)
        check(GAN_WARMUP + 1 + i, terms)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gan_launches = launch_count(fir.upfirdn2d_fir)
    med = statistics.median(t_gan)
    phase("gan", f"FIR launches of one step by direction: {by_dir}; "
          f"{gan_launches} in {GAN_TIMED} timed steps")
    if not (gan_launches == GAN_TIMED * len(launches)
            and min(by_dir.values()) > 0):
        raise AssertionError(f"GAN step FIR launches {gan_launches}, "
                             f"{by_dir}")
    phase("gan", f"median {med:.2f} ms/step over {GAN_TIMED} steps "
          f"{['%.2f' % t for t in t_gan]} after {GAN_WARMUP + 1} warm-up; "
          f"peak memory {peak:.2f} GiB ({card})")
    busy, rows, _ = device_profile(step, top=10 ** 6)
    if busy is None:
        phase("gan", "torch.profiler saw no device time in the GAN step: "
              "busy share not measured")
    else:
        fir_busy = sum(ms for name, ms, _ in rows if "fir_kernel" in name)
        phase("gan", f"one step: device busy {busy:.3f} ms of a median "
              f"{med:.2f} ms (idle {100 * (1 - busy / med):.1f}%); the FIR "
              f"kernel {fir_busy:.3f} ms of it "
              f"({100 * fir_busy / busy:.2f}%)")
        for name, ms, calls in rows[:8]:
            phase("gan", f"  {ms:9.3f} ms {calls:5d} calls  {name[:70]}")

    # (d) each distinct FIR call of the step, in each direction
    res = fir_phase(launches, card, dev, step=True)
    fir_ms = sum(res[p + "device_ms"] for p, _ in FIR_DIRECTIONS)
    phase("gan", f"FIR kernel device time of one step, summed over its "
          f"{len(launches)} launches: {fir_ms:.3f} ms"
          + ("" if busy is None else
             f", {100 * fir_ms / busy:.2f}% of the busy {busy:.3f} ms"))
    rec = next(r for r in records if r["name"] == "upfirdn2d_fir")
    rec["gan_launches"] = gan_launches
    rec["gan_step_launches"] = by_dir
    rec["gan_device_ms"] = {label: res[p + "device_ms"]
                            for p, label in FIR_DIRECTIONS}
    rec.update({k: v for k, v in res.items() if k.startswith("bwd2_")})
    rec["gan_max_abs_err"] = res["max_abs_err"]
    del G, D, g_opt, d_opt, launches
    torch.cuda.empty_cache()
    phase("gan", f"phase 19 took {time.perf_counter() - t_phase:.1f} s")


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms for the block."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def set_remat(net, on: bool) -> None:
    """The three heads' ``remat``, as ``AvatarNet({"remat": on})`` sets it
    (models/avatar.py)."""
    for head in (net.position_net, net.other_net, net.color_net):
        head.remat = on


def remat_fir_count(net) -> int:
    """FIR forwards that remat's recompute adds to a train step's backward,
    from the heads' structure: each decoder stage of each branch reruns its
    up-conv's blur, whose output the backward of the noise injection and
    leaky ReLU after it needs; the ToRGB's upsample of the skip saves no
    tensor, so the recompute stops before it (torch.utils.checkpoint's
    early stop). One a stage and branch: ``len(convs1)`` a head (two
    StyledConvs a stage, two branches)."""
    return sum(len(h.convs1) for h in (net.position_net, net.other_net,
                                       net.color_net))


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def routes_phase(card: str, tmp: str, driver_opt: dict,
                 records: list) -> dict:
    """Phase 20: the train path's routes at full width. (a) remat: a
    B = 1 and a B = 2 step with remat against the same steps without it
    (deterministic cuDNN: losses RTOL_REMAT_LOSS, gradients
    RTOL_REMAT_GRAD a group), the remat step's FIR launches by direction
    against ``fir_count`` + ``remat_fir_count``, the render with remat
    against without it bit for bit; then ms/step (median of REMAT_TIMED
    after REMAT_WARMUP), the device's busy ms of one step and the peak
    memory for each B of REMAT_BS with and without remat. (b) the
    data-parallel step on a one-rank NCCL group: the reduction leaves the
    rank's gradients bit for bit, the step against make_train_step on the
    same item and draws (losses bit for bit, gradients RTOL_DP_GRAD), the
    all-reduce's device time and bytes for the full gradient. (c) a B = 1
    step with random_style: finite, a style draw that differs between two
    steps, kernels against plain=True at phase 9's limits. (d)
    ``main_avatar_torch -m train`` under torchrun's variables for a world
    of one on phase 15's capture, resuming its epoch_latest: an NCCL
    group, the rank on cuda:0, use_dp off, one epoch, epoch_latest's
    net.pt loading strictly into a fresh AvatarNet, the group torn down.
    The FIR record gains the remat step's launches by direction
    (``remat_step_launches``). Returns (a)'s median ms/step by (B,
    remat)."""
    import torch.distributed as dist
    import yaml

    import main_avatar_torch
    from animatablegaussians_torch.parallel import data_parallel as dp
    from animatablegaussians_torch.tools import render_fixture as rf
    from animatablegaussians_torch.training import avatar_trainer as at
    from animatablegaussians_torch.training import lpips as tlp
    from animatablegaussians_torch.training.driver import AvatarTrainer

    t_phase = time.perf_counter()
    dev = torch.device("cuda:0")
    W, H = rf.IMG_W, rf.IMG_H
    net, items = rf.build(dev, keys=rf.TRAIN_KEYS)
    fixture_state = {k: v.clone() for k, v in net.state_dict().items()}
    n_pts = net.n_points
    lpips = tlp.LPIPS(tlp.init_random(rf.LPIPS_SEED), device=dev)
    tkw = dict(loss_weight=rf.LOSS_WEIGHT, lpips=lpips,
               patch_size=rf.PATCH_SIZE, img_w=W, img_h=H)
    gen = torch.Generator(device=dev).manual_seed(20)
    n_fir, n_fir_grad = fir_count(net)
    n_remat = remat_fir_count(net)

    def inputs(b: int, seed: int = 0):
        """(step, batch, draws) for B = b: the single step at B = 1."""
        if b == 1:
            return (at.make_train_step(net, **tkw), items,
                    at.make_draws(gen, n_pts))
        return (at.make_train_step_batched(net, **tkw),
                rf.sequence(items, b, seed=seed),
                [at.make_draws(gen, n_pts) for _ in range(b)])

    # (a) remat against no remat, deterministic cuDNN
    for b in (1, 2):
        step, batch, draws = inputs(b)
        runs = {}
        for on in (False, True):
            set_remat(net, on)
            net.load_state_dict(fixture_state)
            state = at.make_train_state(net, rf.LR_INIT, rf.ITER_NUM)
            with cudnn_deterministic(), fir_calls() as calls:
                terms = step.loss_and_grads(state, batch, draws)
            by_dir = {label: sum(1 for _, o, _ in calls if o == d)
                      for d, (_, label) in enumerate(FIR_DIRECTIONS[:2])}
            runs[on] = (terms, grad_snapshot(net), by_dir)
            net.zero_grad(set_to_none=True)
        (t_off, g_off, d_off), (t_on, g_on, d_on) = runs[False], runs[True]
        loss_err = {k: abs(float(t_on[k]) - float(t_off[k]))
                    / max(abs(float(t_off[k])), 1e-30) for k in t_off}
        grad_err = grad_errors(net, g_on, g_off)
        want_off = {"forward": n_fir, "first derivative": n_fir_grad}
        want_on = {"forward": n_fir + n_remat,
                   "first derivative": n_fir_grad}
        phase("routes", f"remat, B = {b} step 0 against no remat "
              "(deterministic cuDNN): loss terms " + ", ".join(
                  f"{k} {float(t_on[k]):.6f} (rel {e:.1e})"
                  for k, e in loss_err.items())
              + f" (limit {RTOL_REMAT_LOSS:g}); gradients " + ", ".join(
                  f"{g} {e:.2e}" for g, e in grad_err.items())
              + f" (limit {RTOL_REMAT_GRAD:g}); FIR launches by direction "
              f"{d_on} with remat (want {want_on}: the recompute's "
              f"{n_remat} forwards), {d_off} without (want {want_off})")
        if not (max(loss_err.values()) <= RTOL_REMAT_LOSS
                and max(grad_err.values()) <= RTOL_REMAT_GRAD
                and d_on == want_on and d_off == want_off):
            raise AssertionError(f"remat at B = {b}: {loss_err} {grad_err} "
                                 f"{d_on} {d_off}")
        if b == 1:
            rec = next(r for r in records if r["name"] == "upfirdn2d_fir")
            rec["remat_step_launches"] = d_on
        del runs, g_on, g_off, step, batch, draws
    net.load_state_dict(fixture_state)
    renders = {}
    for on in (False, True):
        set_remat(net, on)
        with cudnn_deterministic():
            renders[on] = net.render(items, img_w=W, img_h=H)
    same = all(torch.equal(renders[True][k], renders[False][k])
               for k in ("rgb_map", "mask_map", "depth_map"))
    phase("routes", f"render with remat against without: bit for bit "
          f"{same}")
    if not same:
        raise AssertionError("remat changed the render")
    del renders

    phase("routes", f"(a) comparisons took {time.perf_counter() - t_phase:.1f}"
          " s")
    t_part = time.perf_counter()
    # ms/step, device busy and peak memory by B, without and with remat
    peaks, step_ms = {}, {}
    for b in REMAT_BS:
        for on in (False, True):
            if not on and b > 4:
                est = peaks[4] + (peaks[4] - peaks[2]) * (b - 4) / 2
                if est > REMAT_PEAK_LIMIT_GIB:
                    phase("routes", f"B = {b} without remat skipped: peak "
                          f"extrapolated from B = 2 ({peaks[2]:.2f} GiB) "
                          f"and B = 4 ({peaks[4]:.2f} GiB) is {est:.2f} "
                          f"GiB > {REMAT_PEAK_LIMIT_GIB:g} GiB")
                    continue
                phase("routes", f"B = {b} without remat: extrapolated peak "
                      f"{est:.2f} GiB (limit {REMAT_PEAK_LIMIT_GIB:g})")
            set_remat(net, on)
            net.load_state_dict(fixture_state)
            state = at.make_train_state(net, rf.LR_INIT, rf.ITER_NUM)
            step, batch, _ = inputs(b, seed=b)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t = []
            for i in range(REMAT_WARMUP + REMAT_TIMED):
                d = (at.make_draws(gen, n_pts) if b == 1 else
                     [at.make_draws(gen, n_pts) for _ in range(b)])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, terms = step(state, batch, d)
                torch.cuda.synchronize()
                if i >= REMAT_WARMUP:
                    t.append((time.perf_counter() - t0) * 1e3)
                if not all(math.isfinite(float(v)) for v in terms.values()):
                    raise AssertionError(f"B = {b}, remat {on}: non-finite "
                                         f"{terms}")
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if not on:
                peaks[b] = peak
            d = (at.make_draws(gen, n_pts) if b == 1 else
                 [at.make_draws(gen, n_pts) for _ in range(b)])
            busy = device_busy(lambda: step(state, batch, d))
            med = step_ms[(b, on)] = statistics.median(t)
            phase("routes", f"B = {b}, remat {'on ' if on else 'off'}: "
                  f"median {med:.2f} ms/step ({med / b:.2f} ms/frame) over "
                  f"{['%.2f' % x for x in t]} after {REMAT_WARMUP} warm-up; "
                  + ("device busy not measured (torch.profiler saw no "
                     "device time)" if busy is None else
                     f"device busy {busy:.3f} ms (idle "
                     f"{100 * (1 - busy / med):.1f}%)")
                  + f"; peak memory {peak:.2f} GiB ({card})")
            del state, step, batch
    set_remat(net, False)
    phase("routes", f"(a) the B sweep took {time.perf_counter() - t_part:.1f}"
          " s")
    t_part = time.perf_counter()

    # (b) the data-parallel step on a one-rank NCCL group
    net.load_state_dict(fixture_state)
    group_dir = tempfile.mkdtemp(prefix="group-", dir=tmp)
    rank_dev = dp.init_group(dev, 0, 1, "file://" + os.path.join(
        group_dir, "rendezvous"))
    try:
        backend = dist.get_backend()
        step = at.make_train_step(net, **tkw)
        dp_step = dp.make_dp_train_step(step)
        draws = at.make_draws(gen, n_pts)
        state = at.make_train_state(net, rf.LR_INIT, rf.ITER_NUM)
        with cudnn_deterministic():
            t_single = step.loss_and_grads(state, items, draws)
            g_single = grad_snapshot(net)
            before, reduce = {}, dp.reduce_gradients

            def spy(net_):
                before.update(grad_snapshot(net_))
                return reduce(net_)

            dp.reduce_gradients = spy
            try:
                t_dp = dp_step.loss_and_grads(state, items, draws)
            finally:
                dp.reduce_gradients = reduce
        g_dp = grad_snapshot(net)
        kept = (g_dp.keys() == before.keys()
                and all(torch.equal(g_dp[n], before[n]) for n in g_dp))
        loss_same = t_dp.keys() == t_single.keys() and all(
            torch.equal(t_dp[k], t_single[k]) for k in t_single)
        grad_err = grad_errors(net, g_dp, g_single)
        grads = [p.grad for p in net.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        n_bytes = flat.numel() * flat.element_size()
        ar_ms = device_ms(lambda: dist.all_reduce(flat), DP_ALLREDUCE_REPS)
        # the whole reduction a DP step adds (flatten, all-reduce, copy
        # back: 656 tensors, host-bound), wall time to a synchronize
        red_ms = statistics.median(wall_ms(
            lambda: dp.reduce_gradients(net), DP_ALLREDUCE_REPS))
        state, terms = dp_step(state, items, at.make_draws(gen, n_pts))
        phase("routes", f"data parallel on a one-rank {backend} group, rank "
              f"device {rank_dev}: the reduction left the rank's gradients "
              f"bit for bit {kept}; against make_train_step on the same "
              f"item and draws (deterministic cuDNN): losses bit for bit "
              f"{loss_same}, gradients " + ", ".join(
                  f"{g} {e:.2e}" for g, e in grad_err.items())
              + f" (limit {RTOL_DP_GRAD:g}); all-reduce of the full "
              f"gradient ({n_bytes} bytes, {len(grads)} tensors in one "
              f"flat buffer): {ar_ms:.4f} ms device time over "
              f"{DP_ALLREDUCE_REPS} calls; reduce_gradients (flatten, "
              f"all-reduce, copy back) median {red_ms:.3f} ms wall ({card});"
              f" a full DP step: "
              f"total_loss {float(terms['total_loss']):.6f}, iter "
              f"{state.iter_idx}")
        if not (backend == "nccl" and rank_dev == dev and kept and loss_same
                and max(grad_err.values()) <= RTOL_DP_GRAD
                and state.iter_idx == 1
                and math.isfinite(float(terms["total_loss"]))):
            raise AssertionError(f"data parallel: {backend} {kept} "
                                 f"{loss_same} {grad_err}")
        del g_single, g_dp, before, flat, grads, state, dp_step
    finally:
        dist.destroy_process_group()
    if dist.is_initialized():
        raise AssertionError("data parallel: the group is still up")
    phase("routes", "data parallel: the group is torn down")

    # (c) random_style: one B = 1 step, kernels against plain
    net.load_state_dict(fixture_state)
    net.random_style = True
    sd = at.draws_style_dim(net)
    d1, d2 = (at.make_draws(gen, n_pts, sd) for _ in range(2))
    state = at.make_train_state(net, rf.LR_INIT, rf.ITER_NUM)
    t_plain = at.make_train_step(net, plain=True, **tkw).loss_and_grads(
        state, items, d1)
    g_plain = grad_snapshot(net)
    step = at.make_train_step(net, **tkw)
    t_kern = step.loss_and_grads(state, items, d1)
    g_kern = grad_snapshot(net)
    loss_err = {k: abs(float(t_kern[k]) - float(t_plain[k]))
                / max(abs(float(t_plain[k])), 1e-30) for k in t_plain}
    grad_err = grad_errors(net, g_kern, g_plain)
    state, terms = step(state, items, d2)
    differs = not torch.equal(d1["style"], d2["style"])
    phase("routes", f"random_style, B = 1 step 0 kernel path vs plain "
          "path: loss terms " + ", ".join(
              f"{k} {float(t_kern[k]):.6f} (rel {e:.1e})"
              for k, e in loss_err.items())
          + f" (limit {RTOL_LOSS:g}); gradients " + ", ".join(
              f"{g} {e:.2e}" for g, e in grad_err.items())
          + f" (limit {RTOL_GRAD:g}); style {tuple(d1['style'].shape)} "
          f"in [{float(d1['style'].min()):.4f}, "
          f"{float(d1['style'].max()):.4f}], differs in the next step "
          f"{differs}; next step total_loss "
          f"{float(terms['total_loss']):.6f}")
    if not (max(loss_err.values()) <= RTOL_LOSS
            and max(grad_err.values()) <= RTOL_GRAD and differs
            and all(math.isfinite(float(v)) for v in terms.values())):
        raise AssertionError(f"random_style: {loss_err} {grad_err}")
    net.random_style = False
    del state, step, g_plain, g_kern, net, items, lpips, fixture_state
    torch.cuda.empty_cache()

    phase("routes", f"(b) and (c) took {time.perf_counter() - t_part:.1f} s")

    # (d) the launch path under torchrun's variables, a world of one
    opt = {k: dict(v) for k, v in driver_opt.items()}
    opt["train"].update(
        net_ckpt_dir=os.path.join(tmp, "ckpt_routes"),
        prev_ckpt=os.path.join(driver_opt["train"]["net_ckpt_dir"],
                               "epoch_latest"),
        eval_interval=10 ** 9, ckpt_interval=dict(epoch=1, batch=10 ** 9))
    cfg = os.path.join(tmp, "routes.yaml")
    with open(cfg, "w") as fp:
        yaml.safe_dump(opt, fp)
    seen, init_group = {}, dp.init_group

    def spy_init(*args, **kw):
        rank_dev = init_group(*args, **kw)
        seen.update(device=rank_dev, backend=dist.get_backend(),
                    world=dist.get_world_size())
        return rank_dev

    env = dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    dp.init_group = spy_init
    t0 = time.perf_counter()
    try:
        trainer = main_avatar_torch.main(["-c", cfg, "-m", "train"],
                                         num_epochs=1)
    finally:
        dp.init_group = init_group
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.perf_counter() - t0
    latest = os.path.join(opt["train"]["net_ckpt_dir"], "epoch_latest")
    ckpt = torch.load(os.path.join(latest, "net.pt"), map_location=dev,
                      weights_only=True)
    fresh = AvatarTrainer._build_net(opt["train"]["data"]["data_dir"],
                                     opt["model"], dev)
    fresh.load_state_dict(ckpt["avatar_net"], strict=True)
    names = [k for k in ckpt["avatar_net"] if k.startswith("module.")]
    phase("routes", f"main_avatar_torch -m train under WORLD_SIZE=1 RANK=0 "
          f"LOCAL_RANK=0: group {seen}, trainer on {trainer.device}, "
          f"use_dp {trainer.use_dp}, {len(trainer.terms)} steps to "
          f"iteration {trainer.iter_idx} in {wall:.1f} s; epoch_latest "
          f"net.pt loads strictly into a fresh AvatarNet "
          f"({len(ckpt['avatar_net'])} keys, {len(names)} 'module.'); "
          f"group torn down {not dist.is_initialized()}")
    if not (seen.get("backend") == "nccl" and seen.get("world") == 1
            and seen.get("device") == dev and trainer.device == dev
            and not trainer.use_dp and trainer.rank == 0
            and len(trainer.terms) == ROUTES_CLI_STEPS
            and ckpt["iter_idx"] == trainer.iter_idx and not names
            and not dist.is_initialized()
            and all(math.isfinite(v) for t in trainer.terms
                    for v in t.values())):
        raise AssertionError(f"launch path: {seen} {trainer.device} "
                             f"{trainer.use_dp} {len(trainer.terms)} steps")
    del trainer, fresh, ckpt
    torch.cuda.empty_cache()
    phase("routes", f"phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return step_ms


def gs3d_inputs(net, items) -> dict:
    """Phase 21's scene, on the CPU: phase 3's posed Gaussians and seeded
    colours (``splat_inputs``), the raw canonical scaling and opacity
    they carry, the pad mask and the camera."""
    with torch.no_grad():
        means3d, _, rots, _, colors = splat_inputs(net, items)
        g = net.cano_gaussian
        base = dict(xyz=means3d, rotation=rots, colors=colors,
                    scaling=g.scaling, opacity=g.opacity, valid=net.valid,
                    extr=items["extr"], intr=items["intr"])
        return {k: v.detach().cpu() for k, v in base.items()}


def gs3d_scene(base: dict, dev):
    """A 3DGS ``GaussianParams`` on ``dev`` from ``gs3d_inputs``: SH degree
    ``GS_SH_DEGREE``, the DC term ``rgb_to_sh`` of the colours, the rest
    seeded normals; the log-scales jittered by ``GS_SCALE_JITTER``."""
    from animatablegaussians_torch.models.gaussian_model import GaussianParams
    from animatablegaussians_torch.ops.sh import rgb_to_sh
    n = base["xyz"].shape[0]
    gen = torch.Generator(device=dev).manual_seed(GS_SEED)
    rest = GS_REST_STD * torch.randn((n, (GS_SH_DEGREE + 1) ** 2 - 1, 3),
                                     generator=gen, device=dev)
    jitter = GS_SCALE_JITTER * torch.randn((n, 3), generator=gen,
                                           device=dev)
    to = lambda k: base[k].to(dev).clone()
    return GaussianParams(xyz=to("xyz"),
                          features_dc=rgb_to_sh(to("colors"))[:, None, :],
                          features_rest=rest, scaling=to("scaling") + jitter,
                          rotation=to("rotation"), opacity=to("opacity"))


def gs3d_render(scene, valid, cam, img_w: int, img_h: int, plain=False,
                colors=None) -> dict:
    """``render`` of the scene: its SH colours, or ``colors``."""
    from animatablegaussians_torch.ops.rasterize.api import render
    bg = torch.ones(3, device=scene.xyz.device)
    return render(scene.get_xyz, scene.get_scaling, scene.get_rotation,
                  scene.get_opacity, colors, bg, cam["extr"], cam["intr"],
                  img_w, img_h, valid_mask=valid, plain=plain,
                  shs=None if colors is not None else scene.get_features,
                  max_sh_degree=GS_SH_DEGREE)


def gs3d_step(scene, valid, cam, img_w: int, img_h: int, cots,
              plain=False):
    """(output, gradients of each field, view-space gradient norms) of
    one backward of the image, depth and mask against the cotangents
    ``cots``; the gradients stay in the fields' ``.grad``."""
    scene.zero_grad(set_to_none=True)
    out = gs3d_render(scene, valid, cam, img_w, img_h, plain=plain)
    out["means2d"].retain_grad()
    loss = sum((out[k] * c).sum()
               for k, c in zip(("render", "depth", "mask"), cots))
    loss.backward()
    grads = {f: getattr(scene, f).grad.clone() for f in scene.FIELDS}
    return out, grads, out["means2d"].grad.norm(dim=-1)


def gs3d_compare(out_k, out_p, grads_k=None, grads_p=None) -> dict:
    """Kernel path against plain path: the images at ``ATOL_BLEND``, each
    field's gradient (relative L2) at ``GS_RTOL_GRAD``; raises beyond."""
    errs = {n: float((out_k[k] - out_p[k]).detach().abs().max())
            for n, k in (("color", "render"), ("depth", "depth"),
                         ("alpha", "mask"))}
    bad = {n: e for n, e in errs.items() if not e <= ATOL_BLEND[n]}
    if bad or out_k["n_pairs"] != out_p["n_pairs"]:
        raise AssertionError(f"gs3d: kernel path disagrees with plain: "
                             f"{errs}, n_pairs {out_k['n_pairs']} vs "
                             f"{out_p['n_pairs']}")
    for f, g in (grads_p or {}).items():
        errs[f] = float((grads_k[f] - g).norm() / g.norm())
    bad = {f: e for f, e in errs.items()
           if f not in ATOL_BLEND and not e <= GS_RTOL_GRAD}
    if bad:
        raise AssertionError(f"gs3d: gradients apart beyond "
                             f"{GS_RTOL_GRAD:g}: {errs}")
    return errs


def gs3d_optimizer(scene, extent: float):
    return torch.optim.Adam(
        [{"params": [getattr(scene, f)],
          "lr": GS_XYZ_LR * extent if f == "xyz" else GS_LR[f]}
         for f in scene.FIELDS], eps=GS_EPS)


def follow(x, kept, n_new: int, fill):
    """Per-row values ``x`` of the old rows on the new rows: the kept rows'
    in order, then ``fill`` on the appended rows."""
    x = x[kept]
    tail = torch.full((n_new - x.shape[0],) + tuple(x.shape[1:]), fill,
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, tail])


def check_surgery(opt, old, new, kept, before: dict, reset=()) -> None:
    """After ``grow_adam_state``: ``opt`` holds ``new``'s parameters and
    none of ``old``'s; a kept row's moments are bit for bit its old ones,
    an appended row's are zero (every row's for a field in ``reset``), and
    each ``step`` is the one before."""
    held = {id(p) for grp in opt.param_groups for p in grp["params"]}
    for f in new.FIELDS:
        p_new = getattr(new, f)
        if id(p_new) not in held or id(getattr(old, f)) in held:
            raise AssertionError(f"surgery: {f} not rebound")
        st, was = opt.state[p_new], before[f]
        n_kept = int(kept.sum())
        for k in ("exp_avg", "exp_avg_sq"):
            m = st[k]
            if m.shape != p_new.shape:
                raise AssertionError(f"surgery: {f} {k} {tuple(m.shape)}")
            if f in reset:
                ok = not m.any()
            else:
                ok = (torch.equal(m[:n_kept], was[k][kept])
                      and not m[n_kept:].any())
            if not ok:
                raise AssertionError(f"surgery: {f} {k} moments misplaced")
        if not torch.equal(st["step"], was["step"]):
            raise AssertionError(f"surgery: {f} step {st['step']} "
                                 f"against {was['step']}")


def split_noise(scene, norms, thr: float, extent: float, gen) -> torch.Tensor:
    """The split's (m n_split, 3) standard normals for the rows that
    ``densify_and_split`` selects (gradient norm at ``thr`` or above and
    max scale above ``GS_PERCENT_DENSE`` x ``extent``), drawn from the CPU
    generator ``gen`` and copied to the scene's device, so that the card
    and the CPU split alike."""
    big = torch.max(scene.get_scaling, dim=1).values \
        > GS_PERCENT_DENSE * extent
    m = int(((norms >= thr) & big).sum())
    return torch.randn((m * GS_N_SPLIT, 3), generator=gen).to(
        scene.xyz.device)


def densify_round(scene, norms, radii, valid, thr: float, extent: float,
                  opt=None):
    """Phase 21's densification round: clone, split (its normals from
    ``split_noise`` with a CPU generator seeded ``GS_SPLIT_SEED``, drawn
    before the step's clock starts), prune with ``radii`` and ``extent``,
    reset_opacity. The per-row inputs follow the rows: an appended row has
    gradient norm 0 (as the reference pads it), radius 0 (its
    ``max_radii2D``) and is valid (it copies a valid row). With ``opt``,
    each step's ``grow_adam_state`` is checked (``check_surgery``).
    -> (scene, valid, a record per step: N before and after, rows kept and
    appended, the scene and its valid rows after the step, ms of the step
    and of its surgery)."""
    from animatablegaussians_torch.models import densify as D
    sync = (torch.cuda.synchronize if scene.xyz.device.type == "cuda"
            else (lambda: None))
    gen = torch.Generator().manual_seed(GS_SPLIT_SEED)
    rows = dict(norms=norms, radii=radii, valid=valid)
    steps = []
    # each step -> (new scene, kept mask; None where every row is kept)
    plan = (
        ("clone", lambda s, _: (D.densify_and_clone(
            s, rows["norms"], thr, extent, GS_PERCENT_DENSE), None), ()),
        ("split", lambda s, noise: D.densify_and_split(
            s, rows["norms"], thr, extent, n_split=GS_N_SPLIT,
            percent_dense=GS_PERCENT_DENSE, noise=noise, return_kept=True),
         ()),
        ("prune", lambda s, _: D.prune(
            s, GS_MIN_OPACITY, extent, GS_MAX_SCREEN, rows["radii"],
            return_kept=True), ()),
        ("reset_opacity", lambda s, _: (D.reset_opacity(s), None),
         ("opacity",)))
    for name, fn, reset in plan:
        noise = (split_noise(scene, rows["norms"], thr, extent, gen)
                 if name == "split" else None)
        sync()
        t0 = time.perf_counter()
        new, kept = fn(scene, noise)
        sync()
        t1 = time.perf_counter()
        surgery_ms = None
        if opt is not None:
            before = {f: dict(opt.state[getattr(scene, f)])
                      for f in scene.FIELDS}
            t2 = time.perf_counter()
            D.grow_adam_state(opt, scene, new, kept, reset=reset)
            sync()
            surgery_ms = (time.perf_counter() - t2) * 1e3
        if kept is None:
            kept = torch.ones(scene.num_points, dtype=torch.bool,
                              device=scene.xyz.device)
        if opt is not None:
            check_surgery(opt, scene, new, kept, before, reset)
        n_new = new.num_points
        rows = dict(norms=follow(rows["norms"], kept, n_new, 0.0),
                    radii=follow(rows["radii"], kept, n_new, 0),
                    valid=follow(rows["valid"], kept, n_new, True))
        n_kept = int(kept.sum())
        steps.append(dict(step=name, n_before=scene.num_points,
                          n_after=n_new, kept=n_kept,
                          appended=n_new - n_kept, scene=new,
                          valid=rows["valid"], ms=(t1 - t0) * 1e3,
                          surgery_ms=surgery_ms))
        scene = new
    return scene, rows["valid"], steps


def gs3d_threshold(scene, norms, radii, extent: float) -> float:
    """``GS_GRAD_QUANTILE`` of the visible Gaussians' gradient norms,
    lowered to the median of the visible large ones' and of the small
    ones' where lower (zero norms left out); raises if either set is
    empty."""
    big = torch.max(scene.get_scaling, dim=1).values \
        > GS_PERCENT_DENSE * extent
    live = (radii > 0) & (norms > 0)
    thr = float(torch.quantile(norms[live], GS_GRAD_QUANTILE))
    for name, sel in (("large", live & big), ("small", live & ~big)):
        if not bool(sel.any()):
            raise AssertionError(f"gs3d: no visible {name} Gaussian with a "
                                 "gradient: the round cannot both clone "
                                 "and split")
        thr = min(thr, float(torch.median(norms[sel])))
    return thr


def gs3d_drive(base: dict, dev, img_w: int, img_h: int) -> dict:
    """Phase 21 (a)-(e) on ``dev``, each check raising on failure; the
    CPU copies are the reference. Returns what (f) times and prints."""
    from animatablegaussians_torch.ops.rasterize.api import (
        mark_visible, precompute_sh_colors)
    cpu = torch.device("cpu")
    scene = gs3d_scene(base, dev)
    valid = base["valid"].to(dev)
    cam = {k: base[k].to(dev) for k in ("extr", "intr")}
    colors = base["colors"].to(dev)
    r = dict(n_points=scene.num_points)

    # (a) the SH render through the kernels against plain=True and the
    # colors= route on the same geometry; SH colours card against CPU
    with torch.no_grad():
        out_k = gs3d_render(scene, valid, cam, img_w, img_h)
        out_p = gs3d_render(scene, valid, cam, img_w, img_h, plain=True)
        out_c = gs3d_render(scene, valid, cam, img_w, img_h, colors=colors)
        r["render_err"] = gs3d_compare(out_k, out_p)
        r["n_pairs"], r["n_pairs_colors"] = out_k["n_pairs"], out_c["n_pairs"]
        if r["n_pairs"] != r["n_pairs_colors"]:
            raise AssertionError(f"gs3d: n_pairs {r['n_pairs']} with SH "
                                 f"against {r['n_pairs_colors']} with colors")
        for k in ("render", "depth", "mask"):
            if not torch.isfinite(out_k[k]).all():
                raise AssertionError(f"gs3d: {k} has non-finite values")
        r["coverage"] = float((out_k["mask"] > 0.5).float().mean())
        if not r["coverage"] > 0:
            raise AssertionError("gs3d: empty mask")
        feats = scene.get_features
        sh_dev = precompute_sh_colors(feats, GS_SH_DEGREE, scene.xyz,
                                      cam["extr"])
        sh_cpu = precompute_sh_colors(feats.cpu(), GS_SH_DEGREE,
                                      scene.xyz.cpu(), cam["extr"].cpu())
        r["sh_err"] = float((sh_dev.cpu() - sh_cpu).abs().max())
        if not r["sh_err"] <= GS_ATOL_SH:
            raise AssertionError(f"gs3d: SH colours {r['sh_err']:.3e} apart")
        # (e) mark_visible on the card against the CPU
        vis = mark_visible(scene.xyz, cam["extr"])
        vis_cpu = mark_visible(scene.xyz.cpu(), cam["extr"].cpu())
        r["visible"], r["visible_cpu"] = int(vis.sum()), int(vis_cpu.sum())
        if not torch.equal(vis.cpu(), vis_cpu):
            raise AssertionError(f"gs3d: mark_visible {r['visible']} on "
                                 f"{dev} against {r['visible_cpu']}")
    del out_k, out_p, out_c, sh_dev, sh_cpu, feats

    # (b) one Adam step: gradients through blend_bwd.cu against plain=True
    gen = torch.Generator(device=dev).manual_seed(GS_SEED + 1)
    cots = (torch.randn((img_h, img_w, 3), generator=gen, device=dev),
            torch.randn((img_h, img_w), generator=gen, device=dev),
            torch.randn((img_h, img_w), generator=gen, device=dev))
    out_p, grads_p, _ = gs3d_step(scene, valid, cam, img_w, img_h, cots,
                                  plain=True)
    out_k, grads_k, norms = gs3d_step(scene, valid, cam, img_w, img_h, cots)
    r["step_err"] = gs3d_compare(out_k, out_p, grads_k, grads_p)
    radii = out_k["radii"].detach()
    with torch.no_grad():
        pts = scene.xyz[valid]
        extent = 0.5 * float(torch.linalg.norm(pts.max(0).values
                                               - pts.min(0).values))
    opt = gs3d_optimizer(scene, extent)
    opt.step()
    del out_p, grads_p, out_k, grads_k, pts

    # (c) the densification round with (d)'s surgery, on the card and on
    # the CPU from the same parameters, norms, radii and split draws
    thr = gs3d_threshold(scene, norms, radii, extent)
    r.update(extent=extent, threshold=thr, scene=scene, valid=valid,
             cam=cam, cots=cots, colors=colors, norms=norms, radii=radii)
    cpu_scene = type(scene)(**{f: getattr(scene, f).detach().cpu().clone()
                               for f in scene.FIELDS})
    new, new_valid, r["steps"] = densify_round(scene, norms, radii, valid,
                                               thr, extent, opt)
    ref, ref_valid, ref_steps = densify_round(
        cpu_scene, norms.cpu(), radii.cpu(), valid.cpu(), thr, extent)
    counts = lambda steps: [(s["n_after"], s["kept"]) for s in steps]
    if counts(r["steps"]) != counts(ref_steps):
        raise AssertionError(f"gs3d: the round's counts on {dev} "
                             f"{counts(r['steps'])} against the CPU's "
                             f"{counts(ref_steps)}")
    for name in ("clone", "split"):
        if not next(s for s in r["steps"] if s["step"] == name)["appended"]:
            raise AssertionError(f"gs3d: {name} selected no row")
    if not torch.equal(new_valid.cpu(), ref_valid):
        raise AssertionError("gs3d: the valid rows differ from the CPU's")
    pruned = next(s for s in r["steps"] if s["step"] == "prune")
    pruned = {k: pruned[k] for k in ("scene", "valid")}
    for s in r["steps"] + ref_steps:
        del s["scene"], s["valid"]
    r["round_err"] = {}
    for f in new.FIELDS:
        a, b = getattr(new, f).detach().cpu(), getattr(ref, f).detach()
        r["round_err"][f] = float((a - b).abs().max()) if b.numel() else 0.0
        scale = max(1.0, float(b.abs().max())) if b.numel() else 1.0
        if not r["round_err"][f] <= GS_RTOL_ROUND * scale:
            raise AssertionError(f"gs3d: the round's {f} on {dev} is "
                                 f"{r['round_err'][f]:.3e} from the CPU's")
    del cpu_scene, ref, ref_valid, ref_steps

    # (d) a step through the kernels against plain=True at the new N: on
    # the opaque scene after the prune, then after the opacity reset, where
    # one more Adam step follows
    out_p, grads_p, _ = gs3d_step(pruned["scene"], pruned["valid"], cam,
                                  img_w, img_h, cots, plain=True)
    out_k, grads_k, _ = gs3d_step(pruned["scene"], pruned["valid"], cam,
                                  img_w, img_h, cots)
    r["pruned_step_err"] = gs3d_compare(out_k, out_p, grads_k, grads_p)
    r["pruned_n_pairs"] = out_k["n_pairs"]
    r["pruned_coverage"] = float((out_k["mask"] > 0.5).float().mean())
    if not r["pruned_coverage"] > 0:
        raise AssertionError("gs3d: empty mask after the prune")
    del pruned, out_p, grads_p, out_k, grads_k
    out_p, grads_p, _ = gs3d_step(new, new_valid, cam, img_w, img_h, cots,
                                  plain=True)
    out_k, grads_k, _ = gs3d_step(new, new_valid, cam, img_w, img_h, cots)
    r["new_step_err"] = gs3d_compare(out_k, out_p, grads_k, grads_p)
    r["new_n_pairs"] = out_k["n_pairs"]
    r["new_coverage"] = float((out_k["mask"] > 0.5).float().mean())
    opt.step()
    for f in new.FIELDS:
        p = getattr(new, f)
        if opt.state[p]["exp_avg"].shape != p.shape \
                or not torch.isfinite(p).all():
            raise AssertionError(f"gs3d: {f} after the second step")
    r.update(new=new, new_valid=new_valid, opt=opt)
    return r


def gs3d_phase(card: str, base: dict, records: list) -> None:
    """Phase 21: the generic 3DGS layer (SH colours, densification, the
    Adam surgery) on phase 3's 531,520 posed Gaussians at 1500x2048:
    ``gs3d_drive``'s checks on the card, then (f) its times, peak memory
    and launches, which join each kernel's record as ``gs3d_launches``."""
    from animatablegaussians_torch.ops import fir
    from animatablegaussians_torch.ops.rasterize import blend, expand
    from animatablegaussians_torch.ops.rasterize.api import \
        precompute_sh_colors
    from animatablegaussians_torch.tools import render_fixture as rf
    t_phase = time.perf_counter()
    dev = torch.device("cuda:0")
    W, H = rf.IMG_W, rf.IMG_H
    kernels = (expand.expand_pairs, blend.blend_tiles, blend.blend_backward,
               fir.upfirdn2d_fir)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    r = gs3d_drive(base, dev, W, H)
    torch.cuda.synchronize()
    launches = {fn.__name__: launch_count(fn) for fn in kernels}
    want = dict(GS_LAUNCHES, upfirdn2d_fir=0)
    phase("gs3d", f"kernel launches in (a)-(d): {launches} (want {want}: "
          "the SH and colors= renders, three steps; no FIR)")
    if launches != want:
        raise AssertionError(f"gs3d: launches {launches}, want {want}")
    for rec in records:
        rec["gs3d_launches"] = launches[rec["name"]]
    e = r["render_err"]
    phase("gs3d", f"(a) {r['n_points']} Gaussians, SH degree {GS_SH_DEGREE}"
          f" ({r['n_points']} x {(GS_SH_DEGREE + 1) ** 2} x 3 f32), kernel "
          "path vs plain path: " + ", ".join(
              f"{n} {v:.3e} (atol {ATOL_BLEND[n]:g})" for n, v in e.items())
          + f"; n_pairs {r['n_pairs']} (the colors= route "
          f"{r['n_pairs_colors']}); mask coverage {r['coverage']:.4f}; "
          f"precompute_sh_colors card vs CPU {r['sh_err']:.3e} (limit "
          f"{GS_ATOL_SH:g})")
    phase("gs3d", "(b) one Adam step, kernel path vs plain path, gradient "
          "relative L2 per field: " + ", ".join(
              f"{k} {v:.3e}" for k, v in r["step_err"].items()
              if k not in ATOL_BLEND) + f" (limit {GS_RTOL_GRAD:g})")
    phase("gs3d", f"(c) scene_extent {r['extent']:.6f} (half the valid "
          f"points' bounding-box diagonal), gradient threshold "
          f"{r['threshold']:.6e}: " + "; ".join(
              f"{s['step']} N {s['n_before']} -> {s['n_after']} (kept "
              f"{s['kept']}, appended {s['appended']})" for s in r["steps"])
          + "; counts equal to the CPU's, values within "
          + ", ".join(f"{f} {v:.2e}" for f, v in r["round_err"].items())
          + f" (limit {GS_RTOL_ROUND:g} x max(1, |field|))")
    phase("gs3d", "(d) Adam surgery after each step: kept rows' moments "
          "bit for bit, appended rows' zero (opacity's zeroed by the "
          "reset, as the reference's replace_tensor_to_optimizer), step "
          f"kept; at N {r['new'].num_points}, kernel path vs plain path: "
          + "; ".join(
              f"{label}: " + ", ".join(f"{k} {v:.3e}" for k, v in
                                       r[f"{key}_step_err"].items())
              + f" (gradient limit {GS_RTOL_GRAD:g}); n_pairs "
              f"{r[f'{key}_n_pairs']}, mask coverage "
              f"{r[f'{key}_coverage']:.4f}"
              for label, key in (("the step after the prune", "pruned"),
                                 ("after the reset", "new"))))
    phase("gs3d", f"(e) mark_visible: {r['visible']} of {r['n_points']} in "
          f"front of the near plane on the card, {r['visible_cpu']} on the "
          "CPU, the same rows")

    # (f) times, after the checks (these launches are not counted above)
    scene, valid, cam = r["scene"], r["valid"], r["cam"]
    with torch.no_grad():
        fns = {"SH degree 3": lambda: gs3d_render(scene, valid, cam, W, H),
               "colors=": lambda: gs3d_render(scene, valid, cam, W, H,
                                              colors=r["colors"])}
        t = {k: [] for k in fns}
        for _ in range(GS_TIMED):           # interleaved, after warm-up
            for k, fn in fns.items():
                t[k] += wall_ms(fn, 2)[1:]
        feats = scene.get_features
        sh_ms = cuda_ms(lambda: precompute_sh_colors(
            feats, GS_SH_DEGREE, scene.xyz, cam["extr"]), 20)
    step = lambda s, v: gs3d_step(s, v, cam, W, H, r["cots"])
    t_step = wall_ms(lambda: step(scene, valid), GS_TIMED + 1)[1:]
    t_new = wall_ms(lambda: step(r["new"], r["new_valid"]),
                    GS_TIMED + 1)[1:]
    profiles = [(scene.num_points, statistics.median(t_step),
                 device_profile(lambda: step(scene, valid), top=10 ** 6)),
                (r["new"].num_points, statistics.median(t_new),
                 device_profile(lambda: step(r["new"], r["new_valid"]),
                                top=10 ** 6))]
    med = {k: statistics.median(v) for k, v in t.items()}
    phase("gs3d", f"(f) render, median of {GS_TIMED}: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in med.items())
        + f" (SH costs {med['SH degree 3'] - med['colors=']:+.2f} ms; "
        f"precompute_sh_colors {sh_ms:.3f} ms by CUDA events); forward + "
        f"backward {statistics.median(t_step):.2f} ms at N "
        f"{scene.num_points}, {statistics.median(t_new):.2f} ms at N "
        f"{r['new'].num_points}; {card}")
    phase("gs3d", "(f) the round (first run, with its syncs): " + ", ".join(
        f"{s['step']} {s['ms']:.2f} ms + surgery {s['surgery_ms']:.2f} ms"
        for s in r["steps"])
        + f"; in all {sum(s['ms'] for s in r['steps']):.2f} ms and "
        f"{sum(s['surgery_ms'] for s in r['steps']):.2f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    # (f) where a step's time goes: its device time against its wall time
    for n, wall, (busy, rows, owners) in profiles:
        print_profile(f"one gs3d forward + backward at N {n}", busy,
                      rows[:8], owners, wall)
        if busy is not None:
            ms = {k: sum(t for name, t, _ in rows if k in name)
                  for k in GS_KERNEL_NAMES}
            phase("gs3d", f"(f) the kernels' device time in that step at N "
                  f"{n}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                       ms.items())
                  + f", together {sum(ms.values()):.3f} ms of the busy "
                  f"{busy:.3f} ms and the wall {wall:.2f} ms; {card}")
    del r, scene, valid, fns, feats, profiles
    torch.cuda.empty_cache()
    phase("gs3d", f"phase 21 took {time.perf_counter() - t_phase:.1f} s")


def _rel_err(a, b) -> float:
    """max |a - b| over the largest |b| (floor 1e-30), on the CPU."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _noise_jpegs(root: str, n: int, w: int, h: int, seed: int) -> list:
    """``n`` colour JPEGs of w x h at quality 90 with bench_loader's
    photographic noise (a cubic upsampling of N(0, 1) at 1/8 size)."""
    import cv2
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        tex = cv2.resize(rng.standard_normal((h // 8, w // 8, 3)), (w, h),
                         interpolation=cv2.INTER_CUBIC)
        p = os.path.join(root, f"decode_{i:02d}.jpg")
        cv2.imwrite(p, (np.clip(0.5 + 0.25 * tex, 0, 1) * 255).astype(
            np.uint8), [cv2.IMWRITE_JPEG_QUALITY, 90])
        paths.append(p)
    return paths


def item_stage_ms(ds) -> dict:
    """Host ms of ``DiskDataset.__getitem__`` (``item``), and of its
    stages on the same files, median over its first three items."""
    from animatablegaussians_torch.data import native_io
    from animatablegaussians_torch.utils import exr

    t = {k: [] for k in ("item", "colour decode", "mask decode",
                         "boundary mask", "EXR read", "float conversion")}

    def clock(name, fn):
        t0 = time.perf_counter()
        out = fn()
        t[name].append(time.perf_counter() - t0)
        return out

    for i in range(3):
        path = {n: os.path.join(ds.root, f"{n}_{i:04d}.{e}") for n, e in
                (("color", "jpg"), ("mask", "jpg"), ("pose", "exr"))}
        clock("item", lambda: ds[i])
        color = clock("colour decode",
                      lambda: native_io.decode_jpeg(path["color"]))
        raw = clock("mask decode", lambda: native_io.decode_jpeg(
            path["mask"], grayscale=True))
        boundary, binarized = clock("boundary mask",
                                    lambda: native_io.boundary_mask(raw))
        clock("EXR read", lambda: exr.read_exr(path["pose"]))
        clock("float conversion", lambda: (
            color.astype(np.float32) / 255.0, binarized.astype(np.float32),
            boundary.astype(np.float32)))
    return {k: 1e3 * statistics.median(v) for k, v in t.items()}


def loader_fed_part(card: str, root: str, records: list,
                    bare_step_ms: float, b2_step_ms: float):
    """Phase 22 (a): ``tools/bench_loader``'s loop on a dataset of
    LOADER_FRAMES frames at 1500x2048 (the JAX tool's default is 24), at
    B = 1 (``make_train_step``) and B = 2 (``make_train_step_batched``),
    LOADER_THREADS decode threads, LOADER_WARMUP + LOADER_TIMED steps. The
    first batch the loader put on the card equals ``DiskDataset``'s read of
    the same indices bit for bit; the steps' kernel launches are phase 9's
    (B = 1) and phase 14's (B = 2) a step; the losses are finite. Returns
    the fixture's net (for (d)'s points)."""
    from animatablegaussians_torch.data.loader import PrefetchLoader
    from animatablegaussians_torch.ops import fir
    from animatablegaussians_torch.ops.rasterize.blend import (
        blend_backward, blend_tiles)
    from animatablegaussians_torch.ops.rasterize.expand import expand_pairs
    from animatablegaussians_torch.tools import bench_loader as bl
    from animatablegaussians_torch.tools import render_fixture as rf
    from animatablegaussians_torch.training import lpips as tlp

    dev = torch.device("cuda:0")
    W, H = rf.IMG_W, rf.IMG_H
    t0 = time.perf_counter()
    bl.build_dataset(root, LOADER_FRAMES, W, H, rf.MAP_H)
    build_s = time.perf_counter() - t0
    net, _ = rf.build(dev)
    fixture_state = {k: v.clone() for k, v in net.state_dict().items()}
    lpips = tlp.LPIPS(tlp.init_random(rf.LPIPS_SEED), device=dev)
    ds = bl.DiskDataset(root, LOADER_FRAMES)
    item = item_stage_ms(ds)
    phase("loader", f"(a) one DiskDataset item on the host, median of 3 "
          "items: " + ", ".join(f"{k} {v:.2f} ms" for k, v in item.items())
          + f" ({os.cpu_count()} cores)")
    n_fir, n_fir_grad = fir_count(net)
    counted = (expand_pairs, blend_tiles, blend_backward, fir.upfirdn2d_fir)
    n_total = LOADER_WARMUP + LOADER_TIMED
    beside = {1: f"phase 9's bare B = 1 step {bare_step_ms:.2f} ms",
              2: f"phase 20's bare B = 2 step {b2_step_ms:.2f} ms"}
    for b in (1, 2):
        net.load_state_dict(fixture_state)
        run = bl.make_run(net, 0 if b == 1 else b, dev, lpips=lpips,
                          img_w=W, img_h=H)
        loader = PrefetchLoader(ds, batch_size=b, shuffle=True,
                                num_threads=LOADER_THREADS, prefetch=2,
                                device=dev)
        first_idx = loader.index_batches(1)[0]
        kept = []

        def run_keep(batch):
            if not kept:                # the first batch, as it arrived
                kept.append({k: v.clone() for k, v in batch.items()})
            return run(batch)

        reset_launches(counted)
        res = bl.timed_loop(run_keep, loader, LOADER_TIMED,
                            warm=LOADER_WARMUP,
                            sync=torch.cuda.synchronize)
        launches = {fn.__name__: launch_count(fn) for fn in counted}
        want = dict(expand_pairs=b * n_total, blend_tiles=b * n_total,
                    blend_backward=b * n_total,
                    upfirdn2d_fir=n_total * (n_fir + n_fir_grad))
        reads = [ds[int(i)] for i in first_idx]
        same = {k: bool(torch.equal(v.cpu(), torch.from_numpy(np.stack(
            [r[k] for r in reads])))) for k, v in kept[0].items()}
        bad = [t for t in res["terms"]
               if not all(math.isfinite(v) for v in t.values())]
        phase("loader", f"(a) B = {b}: {res['it_s']:.3f} it/s, "
              f"{res['ms_step']:.2f} ms/step over {LOADER_TIMED} steps "
              f"after {LOADER_WARMUP} warm-up ({LOADER_THREADS} decode "
              f"threads, {LOADER_FRAMES} frames); mean loader wait "
              f"{1e3 * res['wait_mean_s']:.2f} ms a step (max "
              f"{1e3 * max(res['waits']):.2f}); {beside[b]}; dataset "
              f"built in {build_s:.1f} s ({card})")
        phase("loader", f"(a) B = {b}: kernel launches {launches} (want "
              f"{want}: {n_fir} + {n_fir_grad} FIRs and "
              f"{b} splat{'s' if b > 1 else ''} a step); first batch on "
              f"the card equals DiskDataset's read of items "
              f"{[int(i) for i in first_idx]}: {same}; step 0 terms "
              + ", ".join(f"{k} {v:.6f}" for k, v in res["terms"][0].items()))
        if launches != want or not all(same.values()) or bad:
            raise AssertionError(f"loader-fed B = {b}: launches "
                                 f"{launches} (want {want}), first batch "
                                 f"{same}, non-finite {bad[:1]}")
        for r in records:
            r["loader_launches" if b == 1 else "loader_b2_launches"] = \
                launches[r["name"]]
        del run, loader, kept
    net.load_state_dict(fixture_state)
    del lpips, fixture_state
    return net


def decode_part(card: str, root: str) -> None:
    """Phase 22 (b): DECODE_FILES colour JPEGs at 1500x2048 through
    ``decode_jpeg_batch`` at 1 and LOADER_THREADS threads against
    ``decode_jpeg`` one file at a time, bit for bit; ms an image."""
    from animatablegaussians_torch.data import image_io, native_io
    from animatablegaussians_torch.tools import render_fixture as rf

    paths = _noise_jpegs(root, DECODE_FILES, rf.IMG_W, rf.IMG_H, seed=22)
    one = np.stack([native_io.decode_jpeg(p) for p in paths])
    ms = {}
    for n in (1, LOADER_THREADS):
        t = []
        for _ in range(DECODE_REPS):
            t0 = time.perf_counter()
            out = native_io.decode_jpeg_batch(paths, n_threads=n)
            t.append((time.perf_counter() - t0) * 1e3 / len(paths))
            if not np.array_equal(out, one):
                raise AssertionError(f"decode_jpeg_batch at {n} threads "
                                     "differs from decode_jpeg")
        ms[n] = statistics.median(t)
    t0 = time.perf_counter()
    for p in paths:
        native_io.decode_jpeg(p)
    ms_one = (time.perf_counter() - t0) * 1e3 / len(paths)
    phase("loader", f"(b) codec {image_io.CODEC}: {len(paths)} JPEGs "
          f"{rf.IMG_W}x{rf.IMG_H} q90, decode_jpeg_batch equal to "
          f"decode_jpeg bit for bit; ms an image, median of "
          f"{DECODE_REPS}: 1 thread {ms[1]:.2f}, {LOADER_THREADS} threads "
          f"{ms[LOADER_THREADS]:.2f} ({ms[1] / ms[LOADER_THREADS]:.2f}x); "
          f"decode_jpeg in a loop {ms_one:.2f} (host: {os.cpu_count()} "
          f"cores; {card})")


def body_models_part(card: str, root: str) -> None:
    """Phase 22 (c): one forward of SMPL, SMPL+H, MANO and FLAME (with its
    contour) at the real archives' sizes (``capture_fixture.FAMILIES``,
    random tensors), the card against the CPU at B = BODY_B (each output
    within BODY_RTOL of its largest magnitude); ms a forward by CUDA
    events."""
    from animatablegaussians_torch.models import smplx
    from animatablegaussians_torch.tools import capture_fixture as cf

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(22)
    make = dict(smpl=lambda p, d: smplx.SMPL.from_npz(p, device=d),
                smplh=lambda p, d: smplx.SMPLH.from_npz(
                    p, num_betas=16, device=d),
                mano=lambda p, d: smplx.MANO.from_npz(p, device=d),
                flame=lambda p, d: smplx.FLAME.from_npz(
                    p, device=d, use_face_contour=True))
    dims = dict(smpl=dict(betas=10, global_orient=3, body_pose=69,
                          transl=3),
                smplh=dict(betas=16, global_orient=3, body_pose=63,
                           left_hand_pose=6, right_hand_pose=6, transl=3),
                mano=dict(betas=10, global_orient=3, hand_pose=6, transl=3),
                flame=dict(betas=10, global_orient=3, neck_pose=3,
                           jaw_pose=3, leye_pose=3, reye_pose=3,
                           expression=10, transl=3))
    for fam, spec in cf.FAMILIES.items():
        path = cf.write_body_model(os.path.join(root, f"{fam}.npz"), fam)
        args = {k: torch.from_numpy((0.3 * rng.standard_normal(
            (BODY_B, d))).astype(np.float32)) for k, d in dims[fam].items()}
        m_card, m_cpu = make[fam](path, dev), make[fam](path, "cpu")
        with torch.no_grad():
            card_args = {k: v.to(dev) for k, v in args.items()}
            got = m_card(**card_args)
            want = m_cpu(**args)
            ms = cuda_ms(lambda: m_card(**card_args), 20)
        errs = {k: _rel_err(got[k], want[k])
                for k in ("vertices", "joints", "A", "full_pose")}
        phase("body", f"(c) {fam}: {spec['n_verts']} vertices, "
              f"{spec['n_joints']} joints, joints out "
              f"{tuple(got['joints'].shape)}; card vs CPU " + ", ".join(
                  f"{k} {e:.1e}" for k, e in errs.items())
              + f" (limit {BODY_RTOL:g}); {ms:.3f} ms a forward at B = "
              f"{BODY_B} ({card})")
        if max(errs.values()) > BODY_RTOL or not torch.isfinite(
                got["vertices"]).all():
            raise AssertionError(f"{fam}: card vs CPU {errs}")


def feature2d_part(card: str, net) -> None:
    """Phase 22 (d): a tri-plane sample of the fixture's Gaussians
    (normalized into [-1, 1]) from a FEAT_SIZE^2 x (3 FEAT_DIM) plane
    stack, its backward and a gradient of a gradient through
    ``grid_sample2d``; UNet5 at nf UNET_NF on UNET_SIDE^2. The card
    against the CPU on the same inputs (FEAT_RTOL of each output's largest
    magnitude, UNET_RTOL for the U-Net), ms by CUDA events."""
    from animatablegaussians_torch.models import feature2d as f2d
    from animatablegaussians_torch.utils.geometry import normalize_vert_bbox

    dev = torch.device("cuda:0")
    xyz = normalize_vert_bbox(net.cano_gaussian.xyz.detach())[None]
    tri = f2d.TriPlaneFeature(FEAT_DIM, FEAT_SIZE, device=dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    cot = torch.randn((1, xyz.shape[1], 3 * FEAT_DIM), generator=gen,
                      device=dev)

    def passes(fmap, pts, c):
        """forward, the first derivatives and the gradient of the squared
        point gradient, each in (fmap, points)."""
        fmap = fmap.detach().requires_grad_(True)
        pts = pts.detach().requires_grad_(True)
        out = f2d.triplane_sample(pts, fmap)
        g_f, g_p = torch.autograd.grad((out * c).sum(), [fmap, pts],
                                       create_graph=True)
        h_f, h_p = torch.autograd.grad((g_p ** 2).sum(), [fmap, pts])
        return dict(out=out, g_fmap=g_f, g_pts=g_p, gg_fmap=h_f, gg_pts=h_p)

    fmap = tri(1)
    got = passes(fmap, xyz, cot)
    want = passes(fmap.cpu(), xyz.cpu(), cot.cpu())
    errs = {k: _rel_err(got[k], want[k]) for k in got}
    fm = fmap.detach()

    def fwd():
        with torch.no_grad():
            f2d.triplane_sample(xyz, fm)

    def fwd_bwd():
        f = fm.requires_grad_(True)
        torch.autograd.grad((f2d.triplane_sample(xyz, f) * cot).sum(), f)

    def double():
        passes(fm, xyz, cot)

    ms = dict(forward=cuda_ms(fwd, 5), forward_backward=cuda_ms(fwd_bwd, 5),
              double_backward=cuda_ms(double, 3))
    phase("feature2d", f"(d) triplane_sample of {xyz.shape[1]} Gaussians "
          f"from (1, {3 * FEAT_DIM}, {FEAT_SIZE}, {FEAT_SIZE}): card vs CPU "
          + ", ".join(f"{k} {e:.1e}" for k, e in errs.items())
          + f" (limit {FEAT_RTOL:g}); ms " + ", ".join(
              f"{k} {v:.3f}" for k, v in ms.items()) + f" ({card})")
    if max(errs.values()) > FEAT_RTOL:
        raise AssertionError(f"triplane_sample card vs CPU {errs}")
    del got, want
    unet = f2d.UNet5(3, 3, UNET_NF, device=dev)
    x = torch.randn((1, 3, UNET_SIDE, UNET_SIDE), generator=gen, device=dev)
    with torch.no_grad():
        y = unet(x)
        unet_cpu = f2d.UNet5(3, 3, UNET_NF, device="cpu")
        unet_cpu.load_state_dict(unet.state_dict())
        err = _rel_err(y, unet_cpu(x.cpu()))
        ms_u = cuda_ms(lambda: unet(x), 5)
    xg = x.clone().requires_grad_(True)
    ms_ub = cuda_ms(lambda: unet(xg).sum().backward(), 3)
    phase("feature2d", f"(d) UNet5 nf {UNET_NF} on {UNET_SIDE}^2: card vs "
          f"CPU {err:.1e} (limit {UNET_RTOL:g}); {ms_u:.3f} ms forward, "
          f"{ms_ub:.3f} ms forward + backward ({card})")
    if err > UNET_RTOL or not torch.isfinite(y).all():
        raise AssertionError(f"UNet5 card vs CPU {err}")


def leftovers_part(card: str, root: str) -> None:
    """Phase 22 (e): the eleven losses of ``training/losses.py``, the card
    against the CPU (LOSS_RTOL; crop_square and mask_center exact;
    random_crop_center's card draws inside the mask's box); three
    ``BaseTrainer`` iterations of a ConvStack with Adam on the card, its
    files (loss.txt, a TensorBoard event file, batch_3 / epoch_1 /
    epoch_latest) and a resume that restores the weights and Adam's state
    bit for bit."""
    from animatablegaussians_torch.models import feature2d as f2d
    from animatablegaussians_torch.training import base_trainer as btr
    from animatablegaussians_torch.training import losses as L
    from animatablegaussians_torch.utils import synthetic

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(22)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    u = lambda *s: torch.from_numpy(  # noqa: E731
        rng.random(s).astype(np.float32))
    cases = dict(
        mse=(L.mse, (f(64, 64), f(64, 64))),
        tv_loss=(L.tv_loss, (f(256, 256, 3),)),
        eikonal_loss=(L.eikonal_loss, (f(4096, 3),)),
        second_order_smoothness=(L.second_order_smoothness, (f(64, 99),)),
        weighted_mse=(L.weighted_mse, (f(64, 64), f(64, 64), u(64, 64))),
        cosine_distance=(L.cosine_distance, (f(4096, 3), f(4096, 3))),
        iou_loss=(L.iou_loss, (u(4, 128, 128), u(4, 128, 128))),
        kld_loss=(L.kld_loss, (f(64, 32), 0.3 * f(64, 32))))
    errs = {}
    for name, (fn, args) in cases.items():
        a = args[0].clone().requires_grad_(True)
        ac = args[0].to(dev).requires_grad_(True)
        want = fn(a, *args[1:])
        got = fn(ac, *[x.to(dev) for x in args[1:]])
        want.backward()
        got.backward()
        errs[name] = max(_rel_err(got, want), _rel_err(ac.grad, a.grad))
    mask = torch.from_numpy(synthetic.make_items(
        img_w=1500, img_h=2048)["mask_img"])
    img = u(2048, 1500, 3)
    c_card = L.mask_center(mask.to(dev))
    c_cpu = L.mask_center(mask)
    crop_same = torch.equal(L.crop_square(img.to(dev), c_card, 512).cpu(),
                            L.crop_square(img, c_cpu, 512))
    gen = torch.Generator(device=dev).manual_seed(22)
    draws = torch.stack([L.random_crop_center(gen, mask.to(dev), 512)
                         for _ in range(64)]).cpu()
    ys = torch.nonzero(mask.any(1))[:, 0]
    xs = torch.nonzero(mask.any(0))[:, 0]
    inside = bool(((draws[:, 0] >= xs.min()) & (draws[:, 0] <= xs.max())
                   & (draws[:, 1] >= ys.min())
                   & (draws[:, 1] <= ys.max())).all())
    phase("leftovers", "(e) losses and gradients, card vs CPU: " + ", ".join(
        f"{k} {e:.1e}" for k, e in errs.items())
        + f" (limit {LOSS_RTOL:g}); mask_center {c_card.tolist()} "
        f"(CPU {c_cpu.tolist()}), crop_square equal {crop_same}, 64 "
        f"random_crop_center draws inside the mask's box {inside}")
    if (max(errs.values()) > LOSS_RTOL or not torch.equal(c_card.cpu(), c_cpu)
            or not crop_same or not inside):
        raise AssertionError(f"losses card vs CPU {errs}")

    class Items:
        x = rng.random((4, 3, 64, 64)).astype(np.float32)

        def __len__(self):
            return len(self.x)

        def __getitem__(self, i):
            return dict(x=self.x[i], y=self.x[i][::-1].copy())

    def trainer(d):
        torch.manual_seed(22)
        net = f2d.ConvStack(3, 3, 8, kernel_size=3, layer_num=2,
                            use_relu=True, device=dev)
        opt = torch.optim.Adam(net.parameters(), lr=1e-3)

        def step(items, g):
            opt.zero_grad(set_to_none=True)
            x = items["x"][None] + 0.01 * torch.randn(
                items["x"][None].shape, generator=g, device=g.device)
            loss = L.mse(net(x), items["y"][None])
            loss.backward()
            opt.step()
            return {"mse": loss.detach()}

        opt_d = {"train": {"loss_weight": {"mse": 1.0}, "net_ckpt_dir": d,
                           "ckpt_interval": {"epoch": 1, "batch": 3},
                           "eval_interval": 3}}
        tr = btr.BaseTrainer(opt_d, step, net, Items(), optimizer=opt,
                             mini_test_fn=lambda t: tests.append(
                                 t.iter_idx), device=dev)
        tr.log_interval = 1
        return tr

    tests = []
    d = os.path.join(root, "base_trainer")
    a = trainer(d)
    t0 = time.perf_counter()
    a.train(iter_num=3, num_threads=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    files = sorted(os.listdir(d))
    events = [f for sub in files if os.path.isdir(os.path.join(d, sub))
              and not sub.startswith(("batch_", "epoch_"))
              for f in os.listdir(os.path.join(d, sub))
              if f.startswith("events.out.tfevents")]
    with open(os.path.join(d, "loss.txt")) as fp:
        lines = fp.read().splitlines()
    b = trainer(os.path.join(root, "base_trainer_b"))
    epoch = b.load_ckpt(os.path.join(d, "batch_3"))
    same_w = all(torch.equal(v, b.net.state_dict()[k])
                 for k, v in a.net.state_dict().items())
    sa, sb = a.optimizer.state_dict()["state"], \
        b.optimizer.state_dict()["state"]
    same_opt = all(torch.equal(sa[p][k].cpu(), sb[p][k].cpu())
                   for p in sa for k in ("exp_avg", "exp_avg_sq", "step"))
    phase("leftovers", f"(e) BaseTrainer: 3 iterations on the card in "
          f"{wall:.2f} s (loader start, checkpoints and TensorBoard "
          f"included), iter {a.iter_idx} epoch {a.epoch_idx}, mini-tests at "
          f"{tests}, files {files}, TensorBoard event files {len(events)}, "
          f"loss.txt {len(lines)} lines (last: {lines[-1] if lines else ''!r})"
          f"; resumed from batch_3: epoch {epoch} iter {b.iter_idx}, weights "
          f"bit for bit {same_w}, Adam state bit for bit {same_opt}")
    if not (a.iter_idx == b.iter_idx == 3 and epoch == 1 and same_w
            and same_opt and len(lines) == 3 and events and tests == [3]
            and {"batch_3", "epoch_1", "epoch_latest"} <= set(files)):
        raise AssertionError("BaseTrainer on the card")


def loader_phase(card: str, records: list, bare_step_ms: float,
                 b2_step_ms: float) -> None:
    """Phase 22: the slice that finished the port. (a) the loader-fed
    train path (``loader_fed_part``), (b) the batched JPEG decode
    (``decode_part``), (c) the body-model families
    (``body_models_part``), (d) the 2D feature fields
    (``feature2d_part``), (e) the losses and ``BaseTrainer``
    (``leftovers_part``). Its files go to a directory under build/,
    removed at the end."""
    from animatablegaussians_torch.utils import cuda_build

    t_phase = time.perf_counter()
    cuda_build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="loader-", dir=cuda_build.BUILD_ROOT)
    try:
        t = time.perf_counter()
        net = loader_fed_part(card, root, records, bare_step_ms, b2_step_ms)
        phase("loader", f"(a) took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        decode_part(card, root)
        body_models_part(card, root)
        phase("loader", f"(b), (c) took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        feature2d_part(card, net)
        del net
        torch.cuda.empty_cache()
        leftovers_part(card, root)
        phase("loader", f"(d), (e) took {time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase("loader", f"phase 22 took {time.perf_counter() - t_phase:.1f} s")


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
    gs3d_base = gs3d_inputs(net, items)      # phase 21's scene

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
    reset_launches(fwd_kernels)
    out = net.render(items, **kw)
    out_seq = net.render_sequence(seq, **kw)
    torch.cuda.synchronize()
    launches = {fn.__name__: launch_count(fn) for fn in fwd_kernels}
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
    reset_launches(counted)
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
    launches = {fn.__name__: launch_count(fn) for fn in counted}
    want_fir = n_steps * (n_fir + n_fir_grad)
    phase("train", f"kernel launches in {n_steps} train steps: {launches} "
          f"(FIR: want {want_fir}, {n_fir} forward + {n_fir_grad} backward "
          "a step)")
    if (launch_count(blend_backward) != n_steps
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
    n_grad = sum(int(grad) for _, _, grad in calls)
    if (len(calls), n_grad) != (n_fir, n_fir_grad):
        raise AssertionError(f"FIR: {len(calls)} launches ({n_grad} with a "
                             f"gradient) in a train forward, want {n_fir} "
                             f"({n_fir_grad})")
    fir_record = fir_phase(calls, card, dev)
    records.append(fir_record)
    del calls

    # -- 12. render, sequence and B = 1 step: FIRs through the kernel vs
    # through the library call, both eager
    seq = rf.sequence(items, FRAMES)
    with heads_eager():
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
    routes = {"kernel": heads_eager, "library": fir_through_library}
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
    reset_launches([fir.upfirdn2d_fir])
    hands = net.generate_mean_hands(pose)
    n_hands = launch_count(fir.upfirdn2d_fir)
    hands_p = net.generate_mean_hands(pose, plain=True)
    hand_err = max(float((hands[k] - hands_p[k]).abs().max()) for k in hands)
    phase("hands", f"generate_mean_hands: {n_hands} FIR launches (want "
          f"{n_fir}); kernel path vs plain path max |diff| {hand_err:.3e} "
          f"(atol {ATOL_FIR_IMG:g})")
    if not (n_hands == n_fir and hand_err <= ATOL_FIR_IMG):
        raise AssertionError("generate_mean_hands: kernel path")
    net.load_state_dict(fixture_state)
    reset_launches([fir.upfirdn2d_fir])
    h_kern = net.render(hitems, hand_vals=hands, **kw)
    n_hands = launch_count(fir.upfirdn2d_fir)
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
    reset_launches([fir.upfirdn2d_fir])
    t_kern = step_b.loss_and_grads(state, batch, b_draws[0])
    n_step = launch_count(fir.upfirdn2d_fir)
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

    reset_launches(counted)
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
    b2_launches = {fn.__name__: launch_count(fn) for fn in counted}
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

        # -- 17. the template stack on a capture of its own ---------------
        torch.cuda.empty_cache()
        nf_record = template_phase(card, records)

        # -- 19. the StyleGAN2 family and one GAN step at full width ------
        torch.cuda.empty_cache()
        gan_phase(card, records)

        # -- 20. the train path's routes (on phase 15's capture) ----------
        torch.cuda.empty_cache()
        route_ms = routes_phase(card, tmp, driver_opt, records)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 21. the generic 3DGS layer on phase 3's Gaussians ---------------
    torch.cuda.empty_cache()
    gs3d_phase(card, gs3d_base, records)

    # -- 22. the loader-fed train path, the batched decode, the body
    # models, the 2D feature fields, the losses and BaseTrainer ----------
    torch.cuda.empty_cache()
    loader_phase(card, records, step_med, route_ms[(2, False)])

    print(json.dumps({"kernels": records + [nf_record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
