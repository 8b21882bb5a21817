"""The CNN heads' CUDA graph (``models/heads_graph.py``, ``AvatarNet._heads``).

On the CPU: when the graph may engage (no autograd graph recorded, the
kernels and not their plain versions, no forward hook on the heads), that
a CPU call, a training render, a plain one and a hooked one run the eager
heads with the same bits as the view encoder and ``_head_outputs`` called
directly, and what the cache key holds.

Marked ``gpu`` (skipped without a CUDA device), with cuDNN's
deterministic algorithms: a replay against the eager forward, bit for
bit, for ``render`` at the one-frame cell's size and for
``render_sequence`` at F = 8 and F = 3 (with its default algorithms,
within the spread of two eager forwards); weights loaded, a parameter
reassigned and a hook added after a capture; a render's outputs kept
across the next render; ``fir.launches`` a render either way; and the
replayed kernels put down to the ``heads`` span by the correlation id of
their ``cudaGraphLaunch``. On a machine with a CUDA device:
``python -m pytest tests/test_torch_heads_graph.py -q``."""

import contextlib
import json

import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from animatablegaussians_torch.models import heads_graph as HG
from animatablegaussians_torch.utils import profiling as P
from animatablegaussians_torch.utils import synthetic
from on_card import card  # noqa: F401

GRAPH_COUNTERS = ("heads.graph.captures", "heads.graph.replays",
                  "heads.graph.eager")


@pytest.fixture(autouse=True)
def _fresh():
    P.reset()
    P.reset_counters()
    yield
    P.reset()
    P.reset_counters()


def _net_and_items(map_h, img, device, channel_max=None, n_joints=4):
    from animatablegaussians_torch.models.avatar import AvatarNet
    pos, nml, lbs = synthetic.make_cano_map(map_h, n_joints)
    opt = {} if channel_max is None else {"channel_max": channel_max}
    net = AvatarNet(opt, pos, lbs, cano_nml_map=nml, device=device)
    items = synthetic.make_items(n_joints, img, img, cano_pos_map=pos)
    return net, {k: torch.as_tensor(v, device=device)
                 for k, v in items.items()}


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    return _net_and_items(64, 48, "cpu", channel_max=8)


def _direct(net, items, plain=False):
    """The heads as the render called them before the graph: the view
    encoder, then ``_head_outputs``."""
    pose = items["smpl_pos_map"][..., :3][None]
    front, back = net._encode_viewdirs(net._viewdir_half_map(items)[None])
    return net._head_outputs(pose, front, back, plain)


def _same(a, b):
    for x, y in zip(a, b):
        assert x.shape == y.shape and torch.equal(x, y)


# -- CPU: the policy and the key ---------------------------------------------

def test_graph_engages_only_without_autograd_plain_or_hooks(tiny):
    net, _ = tiny
    with torch.no_grad():
        tensors = net._graph_tensors()
        want = list(net.position_net.parameters()) + list(
            net.position_net.buffers())
        assert tensors is not None
        assert {id(t) for t in want} <= {id(t) for t in tensors}
        assert len(tensors) == sum(
            len(m._parameters) + len(m._buffers)
            for h in net._head_nets() for m in h.modules())
        assert net._graph_tensors(plain=True) is None
        for mod, reg in ((net.color_net.convs1[3].conv, "forward_hook"),
                         (net.position_net, "forward_pre_hook"),
                         (net.viewdir_net[0], "forward_hook")):
            fn = ((lambda m, a, o: None) if reg == "forward_hook"
                  else (lambda m, a: None))
            h = getattr(mod, f"register_{reg}")(fn)
            try:
                assert net._graph_tensors() is None, (mod, reg)
            finally:
                h.remove()
        h = nn.modules.module.register_module_forward_hook(
            lambda m, a, o: None)
        try:
            assert net._graph_tensors() is None
        finally:
            h.remove()
        assert net._graph_tensors() is not None
    assert torch.is_grad_enabled() and net._graph_tensors() is None


@pytest.mark.parametrize("case", ["no_grad", "training", "plain", "hook"])
def test_cpu_heads_run_eager_with_the_same_bits(tiny, case):
    net, items = tiny
    hook = None
    if case == "hook":
        hook = net.other_net.register_forward_hook(lambda m, a, o: None)
    try:
        pose = items["smpl_pos_map"][..., :3][None]
        grad = torch.enable_grad() if case == "training" else torch.no_grad()
        with grad:
            vmaps = net._viewdir_half_map(items)[None]
            got = net._heads(pose, vmaps, plain=case == "plain")
            want = _direct(net, items, plain=case == "plain")
        _same(got, want)
        assert all(o.requires_grad == (case == "training") for o in got)
        out = net.render(items, img_w=48, img_h=64,
                         training=case == "training", plain=case == "plain")
        assert torch.isfinite(out["rgb_map"]).all()
    finally:
        if hook is not None:
            hook.remove()
    assert not net._graphs.graphs
    assert not set(GRAPH_COUNTERS) & set(P.counters())   # CPU: not counted


def test_module_tensors_reads_the_tree_in_a_fixed_order():
    a = nn.Sequential(nn.Conv2d(1, 2, 3, bias=False), nn.BatchNorm2d(2))
    b = nn.Linear(2, 2)
    got = HG.module_tensors([a, b])
    conv, bn = a[0], a[1]
    assert [id(t) for t in got] == [
        id(t) for t in (conv.weight, None, bn.weight, bn.bias,
                        bn.running_mean, bn.running_var,
                        bn.num_batches_tracked, b.weight, b.bias)]
    h = bn.register_forward_pre_hook(lambda m, x: None)
    assert HG.module_tensors([a, b]) is None
    h.remove()
    assert len(HG.module_tensors([a, b])) == 9


def test_key_holds_shapes_flags_styles_scalars_and_addresses(tiny):
    net, items = tiny
    pose = items["smpl_pos_map"][..., :3][None]
    vmaps = torch.zeros(1, 32, 64)
    style = torch.ones(1, 512)
    with torch.no_grad():
        tensors = net._graph_tensors()
    base = HG.key((pose, vmaps, None), tensors, (1.0,))
    assert HG.key((pose.clone(), vmaps + 1, None), tensors, (1.0,)) == base
    assert HG.key((torch.cat([pose, pose]), vmaps, None), tensors,
                  (1.0,)) != base
    assert HG.key((pose, vmaps[:, :16], None), tensors, (1.0,)) != base
    assert HG.key((pose.double(), vmaps, None), tensors, (1.0,)) != base
    assert HG.key((pose, vmaps, style), tensors, (1.0,)) != base
    assert HG.key((pose, vmaps, None), tensors, (0.5,)) != base
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = not flags[0]
        assert HG.key((pose, vmaps, None), tensors, (1.0,)) != base
        torch.backends.cudnn.allow_tf32 = flags[0]
        torch.backends.cuda.matmul.allow_tf32 = not flags[1]
        assert HG.key((pose, vmaps, None), tensors, (1.0,)) != base
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    assert HG.key((pose, vmaps, None), tensors, (1.0,)) == base
    # weights copied in place keep the key; one reassigned changes it
    conv = net.other_net.convs2[1].conv
    old = conv.weight
    net.load_state_dict(net.state_dict())
    with torch.no_grad():
        assert HG.key((pose, vmaps, None), net._graph_tensors(),
                      (1.0,)) == base
        conv.weight = nn.Parameter(old.detach().clone())
        try:
            assert HG.key((pose, vmaps, None), net._graph_tensors(),
                          (1.0,)) != base
        finally:
            conv.weight = old


# -- on the card -------------------------------------------------------------

ZZR_MAP, ZZR_IMG, JOINTS = 1024, 1024, 55


def _cudnn_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic)


def _set_cudnn_flags(flags):
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


@pytest.fixture(scope="module")
def avatar(card):
    """The one-frame cell's avatar on the card: 1024^2 maps and image, the
    full widths, TF32 off as the configurations run; with four poses.
    cuDNN runs its deterministic algorithms here: with its default ones
    the eager heads are not reproducible from run to run (the transposed
    convolutions' data-gradient engine adds in no fixed order), so
    neither is the graph, and only the tests below that say so run with
    the default ones."""
    flags = _cudnn_flags()
    _set_cudnn_flags((False, False, True))
    torch.manual_seed(0)
    net, _ = _net_and_items(ZZR_MAP, ZZR_IMG, "cuda", n_joints=JOINTS)
    poses = []
    for seed in range(4):
        it = synthetic.make_items(JOINTS, ZZR_IMG, ZZR_IMG, seed=seed,
                                  angle=0.3)
        it = {k: torch.as_tensor(v, device="cuda") for k, v in it.items()
              if k in ("cano2live_jnt_mats", "cano2live_jnt_mats_woRoot",
                       "extr", "intr")}
        it["smpl_pos_map"] = net.get_pose_map(it)
        poses.append(it)
    yield net, poses
    _set_cudnn_flags(flags)
    del net
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _eager(net):
    """The heads run eagerly in the block: a forward hook that changes
    nothing, on the colour head."""
    h = net.color_net.register_forward_hook(lambda m, a, o: None)
    try:
        yield
    finally:
        h.remove()


def _render(net, it):
    return net.render(it, img_w=ZZR_IMG, img_h=ZZR_IMG)


def _fresh_graphs(net):
    net._graphs.graphs.clear()
    torch.cuda.synchronize()
    P.reset_counters()


KEYS = ("rgb_map", "mask_map", "depth_map", "offset", "pos_map",
        "cano_tex_map")


@pytest.mark.gpu
def test_render_replay_matches_eager_bitwise(avatar):
    net, poses = avatar
    _fresh_graphs(net)
    first = _render(net, poses[0])                  # captures
    replay = _render(net, poses[0])                 # replays
    with _eager(net):
        eager = _render(net, poses[0])
    c = P.counters()
    assert [c.get(k, 0) for k in GRAPH_COUNTERS] == [1, 1, 1]
    for k in KEYS:
        assert torch.equal(replay[k], eager[k]), k
        assert torch.equal(first[k], eager[k]), k
    # the heads' raw outputs too, against the eager forward called directly
    with torch.no_grad():
        it = poses[1]
        pose = it["smpl_pos_map"][..., :3][None]
        vmaps = net._viewdir_half_map(it)[None]
        got = [o.clone() for o in net._heads(pose, vmaps)]
        _same(got, net._heads_eager(pose, vmaps))
    assert P.counters()["heads.graph.replays"] == 2


# with cuDNN's default algorithms two eager forwards of a head differ by
# up to 1.25e-6 of the output's largest magnitude on the H100 (PERF.md),
# and a replay against an eager forward by as much: the bound, with room
DEFAULT_CUDNN_RTOL = 1e-5


@pytest.mark.gpu
def test_default_cudnn_replay_within_the_eager_spread(avatar):
    net, poses = avatar
    _fresh_graphs(net)
    flags = _cudnn_flags()
    _set_cudnn_flags((False, False, False))
    try:
        with torch.no_grad():
            it = poses[1]
            pose = it["smpl_pos_map"][..., :3][None]
            vmaps = net._viewdir_half_map(it)[None]
            eager = [o.clone() for o in net._heads_eager(pose, vmaps)]
            again = [o.clone() for o in net._heads_eager(pose, vmaps)]
            net._heads(pose, vmaps)                 # captures
            replay = [o.clone() for o in net._heads(pose, vmaps)]
        for name, got in (("eager", again), ("replay", replay)):
            rel = [float((g - e).abs().max() / e.abs().max())
                   for g, e in zip(got, eager)]
            print(f"default cuDNN, {name} against eager: {rel}")
            assert max(rel) <= DEFAULT_CUDNN_RTOL, (name, rel)
        assert P.counters()["heads.graph.replays"] == 1
    finally:
        _set_cudnn_flags(flags)


@pytest.mark.gpu
@pytest.mark.parametrize("frames", [8, 3])
def test_render_sequence_replay_matches_eager_bitwise(avatar, frames):
    net, poses = avatar
    _fresh_graphs(net)
    seq = {k: torch.stack([poses[f % len(poses)][k] for f in range(frames)])
           for k in poses[0]}
    kw = dict(img_w=ZZR_IMG, img_h=ZZR_IMG)
    first = net.render_sequence(seq, **kw)
    replay = net.render_sequence(seq, **kw)
    with _eager(net):
        eager = net.render_sequence(seq, **kw)
    for k in ("rgb_map", "mask_map", "depth_map"):
        assert torch.equal(replay[k], eager[k]), k
        assert torch.equal(first[k], eager[k]), k
    c = P.counters()
    assert [c.get(k, 0) for k in GRAPH_COUNTERS] == [1, 1, 1]


@pytest.mark.gpu
def test_weights_parameters_and_hooks_after_a_capture(avatar):
    net, poses = avatar
    _fresh_graphs(net)
    it = poses[2]
    before = _render(net, it)["rgb_map"]
    _render(net, it)
    saved = {k: v.clone() for k, v in net.state_dict().items()}
    try:
        # other weights, copied in place: the same graph reads them
        other = {k: (v * 1.5 if k.startswith("color_net.to_rgbs") else v)
                 for k, v in saved.items()}
        net.load_state_dict(other)
        loaded = _render(net, it)["rgb_map"]
        with _eager(net):
            want = _render(net, it)["rgb_map"]
        assert torch.equal(loaded, want)
        assert not torch.equal(loaded, before)
        assert P.counters()["heads.graph.captures"] == 1
        # a parameter reassigned: a new capture, as the eager path renders
        conv = net.position_net.convs1[5].conv
        old = conv.weight
        conv.weight = nn.Parameter(old.detach() * 1.25)
        try:
            swapped = _render(net, it)["rgb_map"]
            assert P.counters()["heads.graph.captures"] == 2
            swapped2 = _render(net, it)["rgb_map"]
            with _eager(net):
                want = _render(net, it)["rgb_map"]
            assert torch.equal(swapped, want) and torch.equal(swapped2, want)
        finally:
            conv.weight = old
        # a hook that changes the output: the eager path, with the hook
        h = net.other_net.register_forward_hook(lambda m, a, o: o * 0.5)
        try:
            eager = P.counters().get("heads.graph.eager", 0)
            hooked = _render(net, it)["rgb_map"]
            assert P.counters()["heads.graph.eager"] == eager + 1
        finally:
            h.remove()
        assert not torch.equal(hooked, _render(net, it)["rgb_map"])
    finally:
        net.load_state_dict(saved)


@pytest.mark.gpu
def test_a_render_keeps_its_outputs_across_the_next(avatar):
    net, poses = avatar
    _fresh_graphs(net)
    _render(net, poses[3])
    a = _render(net, poses[0])                      # a replay
    kept = {k: a[k].clone() for k in KEYS}
    b = _render(net, poses[1])                      # the next replay
    for k in KEYS:
        assert torch.equal(a[k], kept[k]), k
    assert not torch.equal(a["pos_map"], b["pos_map"])


@pytest.mark.gpu
def test_fir_launches_a_render_with_and_without_the_graph(avatar):
    net, poses = avatar
    _fresh_graphs(net)
    counts = []
    for mode in ("capture", "replay", "replay", "eager"):
        P.reset_counters("fir.launches")
        if mode == "eager":
            with _eager(net):
                _render(net, poses[0])
        else:
            _render(net, poses[0])
        counts.append(P.counters()["fir.launches"])
    assert counts == [99] * 4


@pytest.mark.gpu
def test_replayed_kernels_go_to_heads_by_the_graph_launch(avatar, tmp_path):
    """A traced replay with cuDNN's default algorithms: every kernel the
    ``cudaGraphLaunch`` of the heads started carries its correlation id,
    the launch lies inside the ``heads`` span (``graphed_frames`` 1) on
    the trace's clock, and the replay runs as many kernels as the eager
    heads launch, beside the kernel that copies the pose maps in."""
    net, poses = avatar
    _fresh_graphs(net)
    flags = _cudnn_flags()
    _set_cudnn_flags((False, False, False))         # as the cells run
    try:
        _render(net, poses[0])                      # the capture
        torch.cuda.synchronize()
        _check_traced_replay(net, poses, tmp_path)
    finally:
        _set_cudnn_flags(flags)


def _check_traced_replay(net, poses, tmp_path):
    def traced(hooked: bool):
        P.reset()
        path = str(tmp_path / f"trace-{hooked}.json")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if hooked:
                with _eager(net):
                    _render(net, poses[0])
            else:
                _render(net, poses[0])
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
        base = raw["baseTimeNanoseconds"]
        heads = [((r["start_ns"] - base) / 1e3, (r["end_ns"] - base) / 1e3,
                  r["args"]) for r in P.spans() if r["name"] == "heads"]
        ev = raw["traceEvents"]
        calls = {e["args"]["correlation"]: e for e in ev
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
        in_heads = []
        for e in ev:
            if e.get("cat") != "kernel":
                continue
            c = calls.get(e["args"].get("correlation"))
            assert c is not None, e["name"]
            a, b = float(c["ts"]), float(c["ts"]) + float(c["dur"])
            if any(lo <= a and b <= hi for lo, hi, _ in heads):
                in_heads.append((c, e))
        return heads, in_heads

    heads, in_heads = traced(False)
    assert [h[2].get("graphed_frames") for h in heads] == [1]
    graph = [e for c, e in in_heads if c["name"] == "cudaGraphLaunch"]
    copies = [c["name"] for c, e in in_heads
              if c["name"] != "cudaGraphLaunch"]
    assert len({c["args"]["correlation"] for c, _ in in_heads
                if c["name"] == "cudaGraphLaunch"}) == 1
    eager_heads, eager_in = traced(True)
    assert {h[2].get("graphed_frames") for h in eager_heads} == {0}
    print(f"heads kernels: replay {len(graph)} and {copies} copying the "
          f"inputs, eager {len(eager_in)}")
    assert len(graph) == len(eager_in) > 4000
    assert set(copies) <= {"cudaLaunchKernel"} and len(copies) <= 3
    assert sum("fir_kernel" in e["name"] for e in graph) == 99
