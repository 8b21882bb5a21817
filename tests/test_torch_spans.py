"""The port's spans and counters (``utils/profiling.py``): nothing recorded
without a profiler, nesting, parents, call ids and threads (the autograd
engine's and others), the cap and its drop count, the counters of a CPU
render and train step, and the spans on the clock of a CPU
``torch.profiler`` trace that ``profiling.trace`` exports."""

import glob
import json
import os
import threading
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from animatablegaussians_torch.ops import fir
from animatablegaussians_torch.ops.rasterize import api, blend, expand
from animatablegaussians_torch.utils import profiling as P
from animatablegaussians_torch.utils import synthetic


@pytest.fixture(autouse=True)
def _fresh():
    P.reset()
    P.reset_counters()
    yield
    P.reset()
    P.reset_counters()


def _recording():
    """A CPU profile: spans record inside it."""
    return profile(activities=[ProfilerActivity.CPU])


@P.span("decorated")
def _decorated(x):
    return x + 1


@P.span("with_args", level=2)
def _decorated_args(x):
    return x + 2


def test_no_profiler_no_record_and_no_allocation():
    x = torch.ones(2)
    for _ in range(3):   # the per-name idle objects exist after this
        with P.span("a"), P.span("b"):
            _decorated(x)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(2000):
            with P.span("a") as sp:
                sp.set(pairs=1)
            with P.span("b"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.size_diff > 0 and d.traceback[0].filename == P.__file__]
    assert grown == []
    assert P.spans() == [] and P.counters() == {}
    assert P.span("a") is P.span("a")   # one idle object a name


def test_nesting_parents_calls_and_args():
    with _recording():
        with P.span("root", frame=3) as sp:
            with P.span("child"):
                _decorated(torch.ones(1))
            sp.set(pairs=7)
        with P.span("second"):
            _decorated_args(torch.ones(1))
    rec = {r["name"]: r for r in P.spans()}
    assert [r["name"] for r in P.spans()] == ["root", "child", "decorated",
                                              "second", "with_args"]
    assert rec["with_args"]["args"] == {"level": 2}
    assert rec["with_args"]["parent"] == rec["second"]["id"]
    root, child, dec, second = (rec[n] for n in ("root", "child",
                                                 "decorated", "second"))
    assert root["parent"] is None and root["call"] == root["id"]
    assert child["parent"] == root["id"] and dec["parent"] == child["id"]
    assert child["call"] == dec["call"] == root["id"]
    assert second["parent"] is None and second["call"] == second["id"]
    assert [r["depth"] for r in (root, child, dec, second)] == [0, 1, 2, 0]
    assert root["args"] == {"frame": 3, "pairs": 7}
    for r in (root, child, dec, second):
        assert r["tid"] == threading.get_native_id()
        assert r["ident"] == threading.get_ident()
        assert r["start_ns"] <= r["end_ns"]
    assert root["start_ns"] <= child["start_ns"] <= dec["start_ns"]
    assert dec["end_ns"] <= child["end_ns"] <= root["end_ns"]
    # outside the profile nothing more is recorded
    with P.span("late"):
        pass
    assert len(P.spans()) == 5


class _Twice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return 2 * x

    @staticmethod
    def backward(ctx, g):
        with P.span("inner_bwd"):
            return 2 * g


def test_spans_of_other_threads_hang_under_the_main_thread():
    x = torch.ones(3, requires_grad=True)
    seen = {}

    def worker():
        with P.span("worker"):
            seen["tid"] = threading.get_native_id()

    with _recording():
        with P.span("train.step"):
            with P.span("backward"):
                _Twice.apply(x).sum().backward()
            t = threading.Thread(target=worker)
            t.start()
            t.join()
    rec = {r["name"]: r for r in P.spans()}
    step, bwd = rec["train.step"], rec["backward"]
    # a span opened inside autograd's backward is a child of ``backward``
    assert rec["inner_bwd"]["parent"] == bwd["id"]
    assert rec["inner_bwd"]["call"] == step["id"]
    # a thread with no span open takes the main thread's innermost one
    w = rec["worker"]
    assert w["tid"] == seen["tid"] != step["tid"]
    assert w["parent"] == step["id"] and w["call"] == step["id"]
    assert w["depth"] == 1


def test_cap_drops_the_newest_and_counts_them(monkeypatch):
    monkeypatch.setattr(P, "SPAN_CAP", 5)
    with _recording():
        for i in range(8):
            with P.span(f"s{i}"):
                pass
    assert [r["name"] for r in P.spans()] == [f"s{i}" for i in range(5)]
    assert P.counters()[P.DROPPED] == 3
    P.reset()
    assert P.spans() == [] and P.DROPPED not in P.counters()


def test_counters():
    P.count("a")
    P.count("a", 4)
    P.count("b", 2)
    assert P.counters() == {"a": 5, "b": 2}
    P.reset_counters("a")
    assert P.counters() == {"b": 2}
    P.reset_counters()
    assert P.counters() == {}


def _tiny_net():
    from animatablegaussians_torch.models.avatar import AvatarNet
    pos, nml, lbs = synthetic.make_cano_map(64, 4)
    net = AvatarNet({"channel_max": 8}, pos, lbs, cano_nml_map=nml,
                    device="cpu")
    items = synthetic.make_items(4, 48, 64, cano_pos_map=pos)
    return net, {k: torch.as_tensor(v) for k, v in items.items()}


def test_counters_of_a_cpu_render_and_step():
    from animatablegaussians_torch.testing.animate import _to_u8
    from animatablegaussians_torch.training import avatar_trainer as at
    # kernel launches are counted by ``profiling.count``, not on the wrappers
    for fn in (fir.upfirdn2d_fir, expand.expand_pairs, blend.blend_tiles,
               blend.blend_backward):
        assert not hasattr(fn, "launches")
    torch.manual_seed(0)
    net, items = _tiny_net()
    out = net.render(items, img_w=48, img_h=64)
    u8 = _to_u8(out["rgb_map"])
    assert u8.dtype == np.uint8 and u8.shape == (64, 48, 3)
    state = at.make_train_state(net, 1e-3, 10)
    step = at.make_train_step(net, loss_weight={"l1": 1.0, "offset": 0.1},
                              img_w=48, img_h=64)
    gen = torch.Generator().manual_seed(1)
    _, terms = step(state, items, at.make_draws(gen, net.n_points))
    assert torch.isfinite(terms["total_loss"])
    c = P.counters()
    # the CPU runs the kernels' plain versions, which launch no kernel
    for k in ("fir.launches", "expand.launches", "blend.fwd.launches",
              "blend.bwd.launches"):
        assert c.get(k, 0) == 0, k
    assert c["splat.frames"] == 2
    assert c["splat.pairs"] >= out["n_pairs"] > 0
    assert c["host.waits"] == 3   # two pair counts and one readback
    assert P.spans() == []        # no profiler, no spans


def test_render_and_step_spans_on_a_cpu_profile():
    from animatablegaussians_torch.testing.animate import _to_u8
    from animatablegaussians_torch.training import avatar_trainer as at
    torch.manual_seed(0)
    net, items = _tiny_net()
    state = at.make_train_state(net, 1e-3, 10)
    step = at.make_train_step(net, loss_weight={"l1": 1.0, "offset": 0.1},
                              img_w=48, img_h=64)
    draws = at.make_draws(torch.Generator().manual_seed(1), net.n_points)
    with _recording():
        out = net.render(items, img_w=48, img_h=64)
        _to_u8(out["rgb_map"])
        step(state, items, draws)
    rec = P.spans()
    by_id = {r["id"]: r for r in rec}
    roots = [r["name"] for r in rec if r["parent"] is None]
    assert roots == ["render", "readback", "train.step"]

    def path(r):
        names = [r["name"]]
        while r["parent"] is not None:
            r = by_id[r["parent"]]
            names.append(r["name"])
        return "/".join(reversed(names))

    paths = {path(r) for r in rec}
    for p in ("render/heads", "render/select_skin", "render/splat.preprocess",
              "render/splat.binning/wait.pairs", "render/splat.blend",
              "readback/wait.readback", "readback/readback.convert",
              "train.step/render/heads", "train.step/losses",
              "train.step/backward/splat.blend_bwd", "train.step/adam"):
        assert p in paths, p
    binning = [r for r in rec if r["name"] == "splat.binning"]
    assert binning[0]["args"]["pairs"] == out["n_pairs"]
    assert len(binning) == 2


def test_plain_blend_ops_lie_inside_their_span_on_the_trace_clock(tmp_path):
    rng = np.random.default_rng(0)
    n, w, h = 60, 64, 48
    means = torch.as_tensor(rng.uniform([-0.8, -0.6, 2.0], [0.8, 0.6, 4.0],
                                        (n, 3)), dtype=torch.float32)
    scales = torch.as_tensor(rng.uniform(0.02, 0.12, (n, 3)),
                             dtype=torch.float32)
    q = torch.as_tensor(rng.standard_normal((n, 4)), dtype=torch.float32)
    q = q / q.norm(dim=1, keepdim=True)
    opac = torch.as_tensor(rng.uniform(0.2, 0.9, n), dtype=torch.float32)
    colors = torch.as_tensor(rng.uniform(0, 1, (n, 3)), dtype=torch.float32)
    intr = torch.tensor([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]])
    with P.trace(str(tmp_path)):
        out = api.render(means, scales, q, opac, colors, torch.zeros(3),
                         torch.eye(4), intr, w, h, plain=True)
    assert out["n_pairs"] > 0
    path, = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    prog = [e for e in ev if e.get("cat") == "program"]
    names = sorted(e["name"] for e in prog)
    assert names == ["splat.binning", "splat.blend", "splat.preprocess",
                     "wait.pairs"]
    for e in prog:
        assert e["ph"] == "X" and e["pid"] == os.getpid()
        assert e["tid"] == threading.get_native_id()
    sp, = [e for e in prog if e["name"] == "splat.blend"]
    assert sp["args"]["parent"] is None and sp["args"]["call"] == sp["args"][
        "id"]
    # ops only the blend runs (its cumulative product and colour sums)
    ops = [e for e in ev if e.get("cat") == "cpu_op"
           and e["name"] in ("aten::cumprod", "aten::bmm")]
    assert ops
    for e in ops:
        assert sp["ts"] <= e["ts"] and e["ts"] + e["dur"] <= sp["ts"] + sp[
            "dur"], e["name"]
    pre, = [e for e in prog if e["name"] == "splat.preprocess"]
    assert pre["ts"] + pre["dur"] <= sp["ts"]
