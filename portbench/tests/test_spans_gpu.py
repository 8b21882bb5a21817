"""On the card: the program's spans and the device trace share a clock.
Two renders and one B = 1 step are profiled the way ``run.Stretch``
profiles a cell's stretch; every forward and backward blend kernel,
matched to its launching runtime call by correlation id, was launched
inside its ``splat.*`` span on the same thread, and every FIR kernel of
the forward inside ``heads``. Run on a machine with a CUDA device:
``python -m pytest portbench/tests/test_spans_gpu.py -q``."""

import json
import os

import pytest
import torch

from portbench import run as R
from portbench.yardstick import spans as S
from portbench.yardstick.trace import Trace

SEED = 2_147_485_017
CASES = [("zzr-frame", 2, {"splat.blend": "blend_forward_kernel"}),
         ("zzr-train-b1", 1, {"splat.blend": "blend_forward_kernel",
                              "splat.blend_bwd": "blend_backward_kernel"})]


@pytest.mark.gpu
@pytest.mark.parametrize("cell, calls, blends", CASES)
def test_kernels_launch_inside_their_spans(cell, calls, blends):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from animatablegaussians_torch.utils import profiling
    profiling.reset()
    res = R.run(cell, SEED, 0.5, True,
                overrides={"traffic": {"trace_calls": calls}})
    assert res["correct"]
    with open(os.path.join(S.OUT_DIR, f"trace-{cell}.json")) as f:
        raw = json.load(f)
    base = raw["baseTimeNanoseconds"]
    recs = [dict(r, a=(r["start_ns"] - base) / 1e3,
                 b=(r["end_ns"] - base) / 1e3)
            for r in profiling.spans() if r["end_ns"] is not None]
    ev = raw["traceEvents"]
    runtime = [e for e in ev if e.get("cat") == "cuda_runtime"
               and "args" in e]
    thread = S.thread_map(recs, runtime)
    roots = [r for r in recs if r["parent"] is None]
    assert len(roots) >= calls
    # every thread that opened a span is matched to its runtime calls
    assert set(thread.values()) == {r["tid"] for r in recs}
    launch = {e["args"]["correlation"]: e for e in runtime}

    def inside(e, names):
        th = thread.get(e["tid"])
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        return [r for r in recs if r["name"] in names and r["tid"] == th
                and r["a"] <= a and b <= r["b"]]

    seen = dict.fromkeys(list(blends.values()) + ["fir_kernel"], 0)
    for e in ev:
        if e.get("cat") != "kernel":
            continue
        call = launch.get(e["args"].get("correlation"))
        for span, kernel in blends.items():
            if kernel in e["name"]:
                assert call is not None, e["name"]
                assert inside(call, {span}), (kernel, call)
                seen[kernel] += 1
        if "fir_kernel" in e["name"]:
            assert call is not None
            if not inside(call, {"backward"}) and thread.get(
                    call["tid"]) == roots[0]["tid"]:
                assert inside(call, {"heads"}), call
                seen["fir_kernel"] += 1
    frames = calls * R.cell(cell)["traffic"].get("frames_per_call", 1)
    assert seen["blend_forward_kernel"] == frames
    assert seen.get("blend_backward_kernel", calls) == calls
    assert seen["fir_kernel"] == 99 * calls
    att = S.Attribution(ev, base, profiling.spans(), Trace(ev))
    cover = S.coverage(att)
    print(cell, json.dumps(cover), json.dumps(att.by_name()[:12]))
    assert cover["spanned_device_share"] >= 0.95
