"""What the ``gpu`` tests of several files share: the card, the full-width
fixture, the tolerances that hold a kernel path to its plain path, the
kernels' launch counters, and the FIR call recorder and comparison.

Not a test module (pytest collects ``test_*.py``); a test file imports
what it uses, the fixtures included. A test marked ``gpu`` asks for
``card`` (or a fixture built on it), which skips without a CUDA device:
whether there is a card is decided here at run time, never at import.
This module imports neither JAX nor the JAX package. On a machine with a
CUDA device: ``python -m pytest -m gpu tests/test_torch_*.py -q`` (or one
file)."""

from __future__ import annotations

import contextlib
import os

import numpy as np
import pytest
import torch

from animatablegaussians_torch.utils import profiling

# (Gaussian, tile) pairs the JAX package bins for the full-width fixture at
# init (its preprocess + tile_rect on exact-KNN scales, recomputed on the
# CPU by tests/test_torch_rasterize.py::test_full_fixture_pair_count_
# matches_jax). BENCH_r05.json's 1,065,157 is, as read from
# bench.py:219-221 (not rerun), the count its train loop printed after its
# warm-up and timed Adam steps, not at init.
JAX_N_PAIRS = 1_291_771
# kernel vs plain version on the card: the per-pair arithmetic rounds
# identically (the kernels are built with -fmad=false); the plain version
# forms the transmittance with cumprod and the colour sums with bmm, so
# sums differ in order (~1e-7 relative), and a pixel whose transmittance
# sits within rounding of the 1e-4 cutoff may differ by one contribution
# (< 1e-4). Depth is weighted by z ~ 2.
ATOL_BLEND = {"color": 1e-5, "depth": 3e-5, "alpha": 1e-5}
# a step through the kernels vs through the plain versions, or with the
# FIRs through the library call: loss terms, and each parameter group's
# gradient as a relative L2 error. Beyond the blend's differences above,
# carried back through the CNN heads, the card is not deterministic run to
# run: an L1 residual within rounding of 0 takes the other sign, LPIPS's
# max pools route a near-tie to the other input, and cuDNN's transposed
# and backward convs sum in a run-dependent order; each such event moves
# the gradients of the few Gaussians under one pixel. On the H100 the
# groups read <= 6e-5 without such an event and 4.9e-4 to 1.8e-3 in
# cano_gaussian with one, at B = 1 and B = 2 alike; the same path run
# twice differed by up to 4e-3 in LPIPS's part of that gradient
RTOL_LOSS = 1e-5
RTOL_GRAD = 1e-2
# FIR kernel vs its plain version, relative to the largest |plain| of the
# call: forward, the same products and sums in the same order
# (-fmad=false); backward, the plain side is autograd through its slices,
# which adds each input element's terms in another order
RTOL_FIR = 1e-5
# the paths with the FIRs through the kernel against through the library
# call (and the mean hands' kernel path against plain): the kernel's taps
# are the SVD factors, whose outer product differs from the 2-D kernel by
# ~1e-8, and the sums run in another order, ~1e-7 relative per FIR; the
# fixture's position/other heads output exactly zero, so only the colours
# can move, by the colour head's rounding
ATOL_FIR_IMG = 1e-4
# the capture of the entry-point tests: frames (two cameras each),
# pretrain iterations and the heads' width; each frame's pose map moves
# its texels by this times N(0, 1) metres, so that the animation's PCA has
# frames that differ
DRIVER_FRAMES, DRIVER_PRETRAIN, DRIVER_CHANNEL_MAX = 3, 2, 512
DRIVER_POSE_JITTER = 0.01
# a frame of the animation or the scored renders, the least share of its
# pixels with alpha > 1/255: about half the smallest reading on the H100
# (0.0812 of a frame, PERF.md), so that an avatar the frames barely show
# fails (random-init heads alone read 0.0046)
ANIM_COVER_MIN = 0.04

# the launch counter (utils/profiling.counters) of each kernel wrapper
LAUNCH_COUNTER = {"expand_pairs": "expand.launches",
                  "blend_tiles": "blend.fwd.launches",
                  "blend_backward": "blend.bwd.launches",
                  "upfirdn2d_fir": "fir.launches",
                  "nearest_face": "nearest_face.launches"}


@pytest.fixture(scope="module")
def card():
    """cuda:0 with TF32 off for matmuls and convolutions (as the
    configurations run) and the kernels built; skips without a CUDA
    device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from animatablegaussians_torch.utils import cuda_build
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.load()
    yield torch.device("cuda:0")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags
    torch.cuda.empty_cache()


@pytest.fixture(scope="module")
def full_width(card):
    """The full-width fixture on the card (``tools/render_fixture.py``:
    531,520 Gaussians, three heads at channel_max 512, 1500x2048), built
    once a module: (net, one frame's train and hand items, the fixture's
    weights)."""
    from animatablegaussians_torch.tools import render_fixture as rf
    net, items = rf.build(card, keys=rf.TRAIN_KEYS + rf.HAND_KEYS)
    state = {k: v.clone() for k, v in net.state_dict().items()}
    yield net, items, state
    del net, items, state
    torch.cuda.empty_cache()


@pytest.fixture
def full(full_width):
    """(net, items) of ``full_width`` at the fixture's weights, whatever
    the test before trained: the position and other heads output exactly
    0, so the kernel and plain paths place the Gaussians identically."""
    net, items, state = full_width
    net.load_state_dict(state)
    net.zero_grad(set_to_none=True)
    return net, items


@pytest.fixture(scope="module")
def train_kw(card):
    """The bench's train-step settings on the card
    (``tools/render_fixture.py``): L1 + 0.1 LPIPS (random weights, seed
    7) on a 512 crop + 0.005 offset, at 1500x2048."""
    from animatablegaussians_torch.tools import render_fixture as rf
    from animatablegaussians_torch.training import lpips as tlp
    return dict(loss_weight=rf.LOSS_WEIGHT,
                lpips=tlp.LPIPS(tlp.init_random(rf.LPIPS_SEED), device=card),
                patch_size=rf.PATCH_SIZE, img_w=rf.IMG_W, img_h=rf.IMG_H)


def reset_launches(*fns) -> None:
    """Zeroes the launch counters of the kernel wrappers ``fns``."""
    profiling.reset_counters(*(LAUNCH_COUNTER[fn.__name__] for fn in fns))


def launches(*fns) -> dict:
    """Each kernel wrapper's launches since its counter was reset, by
    name."""
    c = profiling.counters()
    return {fn.__name__: c.get(LAUNCH_COUNTER[fn.__name__], 0) for fn in fns}


def kernels():
    """The avatar path's kernel wrappers: expand, forward blend, backward
    blend, FIR."""
    from animatablegaussians_torch.ops import fir
    from animatablegaussians_torch.ops.rasterize.blend import (
        blend_backward, blend_tiles)
    from animatablegaussians_torch.ops.rasterize.expand import expand_pairs
    return expand_pairs, blend_tiles, blend_backward, fir.upfirdn2d_fir


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


def splat_inputs(net, items):
    """The fixture's posed Gaussians: its zeroed position/other heads leave
    the create_from_pcd attributes, so these are exactly what the render
    splats, skinned to the frame's pose; colours are uniform from a seeded
    generator."""
    g = net.cano_gaussian
    gen = torch.Generator(device=g.xyz.device).manual_seed(1)
    vals = dict(positions=g.xyz, rotations=g.get_rotation)
    vals = net.transform_cano2live(vals, items)
    colors = torch.rand((net.n_points, 3), generator=gen,
                        device=g.xyz.device)
    return (vals["positions"], g.get_scaling, vals["rotations"],
            g.get_opacity.reshape(-1), colors)


def param_groups(net) -> dict:
    """Top-level parameter group -> its parameters (name, tensor)."""
    groups = {}
    for name, p in net.named_parameters():
        groups.setdefault(name.split(".")[0], []).append((name, p))
    return groups


def grad_snapshot(net) -> dict:
    return {name: p.grad.detach().clone() for name, p in
            net.named_parameters() if p.grad is not None}


def grad_errors(net, g_a: dict, g_b: dict) -> dict:
    """Relative L2 error of ``g_a`` against ``g_b`` per parameter group;
    groups the loss does not reach are left out, and both must reach the
    same parameters."""
    out = {}
    for group, named in param_groups(net).items():
        names = [n for n, _ in named if n in g_b]
        assert sorted(names) == sorted(n for n, _ in named if n in g_a), \
            f"{group}: the two paths reach different parameters"
        if names:
            a = torch.cat([g_a[n].reshape(-1) for n in names])
            b = torch.cat([g_b[n].reshape(-1) for n in names])
            out[group] = float((a - b).norm() / b.norm())
    return out


def rel_err(a, b) -> float:
    """max |a - b| over the largest |b| (floor 1e-30), on the CPU."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def loss_errors(got: dict, want: dict) -> dict:
    """Each loss term of ``got`` against ``want``, relative."""
    return {k: abs(float(got[k]) - float(v)) / max(abs(float(v)), 1e-30)
            for k, v in want.items()}


def assert_step_matches(net, got, want, rtol_loss=RTOL_LOSS,
                        rtol_grad=RTOL_GRAD) -> None:
    """A step's (loss terms, gradients) against another route's."""
    loss_err = loss_errors(got[0], want[0])
    grad_err = grad_errors(net, got[1], want[1])
    print(f"loss terms {loss_err}, gradients {grad_err}")
    assert max(loss_err.values()) <= rtol_loss, loss_err
    assert max(grad_err.values()) <= rtol_grad, grad_err


def finite(terms) -> bool:
    return all(np.isfinite(float(v)) for v in terms.values())


def compare_images(a: dict, b: dict, atol) -> dict:
    """max |a - b| of colour, depth and alpha, each within ``atol`` (a
    number, or one a channel as ``ATOL_BLEND``)."""
    errs = {"color": float((a["rgb_map"] - b["rgb_map"]).abs().max()),
            "depth": float((a["depth_map"] - b["depth_map"]).abs().max()),
            "alpha": float((a["mask_map"] - b["mask_map"]).abs().max())}
    tol = atol if isinstance(atol, dict) else dict.fromkeys(errs, atol)
    assert all(e <= tol[n] for n, e in errs.items()), (errs, tol)
    return errs


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms for the block."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


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


def by_direction(calls, orders=(0, 1, 2)) -> dict:
    """``fir_calls``' launches counted by order."""
    return {o: sum(1 for _, order, _ in calls if order == o) for o in orders}


def check_fir_calls(calls, dev, step: bool = False) -> None:
    """The FIR kernel against its plain version at each distinct call of
    ``calls`` (``fir_calls`` records): the forward bit for bit, each
    derivative within RTOL_FIR of autograd through the plain version. The
    first derivative is checked for every call; the second (the gradient
    of the VJP with respect to its cotangent, through ``_FIRGrad``) for
    the calls ``step``'s record shows it launched."""
    from animatablegaussians_torch.ops.fir import (upfirdn2d_fir,
                                                   upfirdn2d_fir_plain)
    seconds = {key for key, order, _ in calls if step and order == 2}
    gen = torch.Generator(device=dev).manual_seed(4)
    for shape, kv, kh, up, down, pad in dict.fromkeys(
            key for key, _, _ in calls):
        args = (kv, kh, up, down, pad)
        second = (shape, *args) in seconds
        x = torch.randn(shape, generator=gen, device=dev)
        yk, yp = upfirdn2d_fir(x, *args), upfirdn2d_fir_plain(x, *args)
        assert torch.equal(yk, yp), (shape, args,
                                     float((yk - yp).abs().max()))
        g = torch.randn(yk.shape, generator=gen, device=dev)
        r = torch.randn(shape, generator=gen, device=dev)
        routes = (upfirdn2d_fir, upfirdn2d_fir_plain)
        xs = [x.clone().requires_grad_(True) for _ in routes]
        gs = [g.clone().requires_grad_(second) for _ in routes]
        firsts = [torch.autograd.grad(fn(xi, *args), xi, gi,
                                      create_graph=second)[0]
                  for fn, xi, gi in zip(routes, xs, gs)]
        pairs = [firsts]
        if second:
            pairs.append([torch.autograd.grad(f, gi, r)[0]
                          for f, gi in zip(firsts, gs)])
        for order, (k, p) in enumerate(pairs, 1):
            k, p = k.detach(), p.detach()
            err = float((k - p).abs().max() / p.abs().max())
            assert err <= RTOL_FIR, (shape, args, order, err)


def _library_weight(kv, kh, flip: bool, c: int, device):
    """The depthwise weight (C, 1, kh, kw) of ``fir_library``."""
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
    assert up == 2 and down == 1 and min(crop) >= 0 and set(extra) <= {
        0, 1}, f"no one-call library yardstick for {up}, {down}, {pad}"
    return torch.nn.functional.conv_transpose2d(
        x, _library_weight(kv, kh, False, c, x.device), stride=2,
        padding=crop, output_padding=extra, groups=c)


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
    """The port's FIRs through ``fir_library`` for the block, the heads
    run eagerly."""
    from animatablegaussians_torch.ops import fir
    inner = fir.upfirdn2d_fir
    fir.upfirdn2d_fir = fir_library
    try:
        with heads_eager():
            yield
    finally:
        fir.upfirdn2d_fir = inner


def write_capture(tmp: str) -> dict:
    """The entry-point tests' full-width synthetic capture under ``tmp``
    (``tools/capture_fixture.py``: DRIVER_FRAMES frames x 2 cameras of
    1500x2048 JPEGs, map_h 1024 = 531,520 Gaussians, SMPL-X's real shapes)
    and the training config on it with the bench's settings at
    DRIVER_CHANNEL_MAX (checkpoints under ``tmp/ckpt``): 2 steps a frame an
    epoch, a mini-test and a batch checkpoint at step 4."""
    from animatablegaussians_torch.tools import capture_fixture as cf
    data_dir = os.path.join(tmp, "capture")
    smpl_path = cf.write_capture(data_dir, n_frames=DRIVER_FRAMES,
                                 pose_map_jitter=DRIVER_POSE_JITTER,
                                 **cf.FULL)
    return dict(
        train=dict(
            dataset="MvRgbDatasetAvatarReX",
            data=dict(data_dir=data_dir, frame_range=[0, DRIVER_FRAMES],
                      used_cam_ids=[0, 1], load_smpl_pos_map=True,
                      smpl_model_path=smpl_path),
            net_ckpt_dir=os.path.join(tmp, "ckpt"),
            ckpt_interval=dict(epoch=1, batch=4), eval_interval=4,
            eval_training_ids=[0, 0], lr_init=5e-4,
            loss_weight=dict(l1=1.0, lpips=0.1, offset=0.005),
            lpips_weights="random", finetune_color=False, batch_size=1,
            num_workers=8, random_bg_color=True),
        model=dict(with_viewdirs=True, channel_max=DRIVER_CHANNEL_MAX))


def write_config(opt: dict, path: str) -> str:
    import yaml
    with open(path, "w") as fp:
        yaml.safe_dump(opt, fp)
    return path


def render_checkpoint(opt: dict, path: str, dev) -> str:
    """A checkpoint of ``opt``'s AvatarNet with the position and other
    heads' ToRGB weights zeroed (``render_fixture.zero_head_outputs``),
    written to ``path`` in the reference layout: the Gaussians keep their
    canonical opacity and scales, as in the full-width fixture, so the
    frames cover the avatar, while all three heads' conv work is
    unchanged."""
    from animatablegaussians_torch.tools import render_fixture as rf
    from animatablegaussians_torch.training import checkpoint as ck
    from animatablegaussians_torch.training.driver import AvatarTrainer

    net = AvatarTrainer._build_net(opt["train"]["data"]["data_dir"],
                                   opt.get("model", {}), dev)
    rf.zero_head_outputs(net)
    ck.save_checkpoint(path, net)
    del net
    return path
