"""Structured tracing / profiling utilities.

Port of ``animatablegaussians_tpu/utils/profiling.py``. The reference only
has commented-out CUDA-event timers (ref: main_avatar.py:167-172, 248-262;
base_trainer.py:225-227); here per-stage wall timers wait for the device
(``torch.cuda.synchronize`` on each CUDA device a result lives on), and
``trace`` captures a ``torch.profiler`` Chrome trace that ``trace_report``
sums by kernel name.

The JAX package's ``trace_report`` maps anonymous XLA fusions to source
lines through the compiled HLO (its ``jitted_fn`` / ``fn_args``
arguments). Eager PyTorch has no fusions to resolve, and a kernel's name is
its own; the port has no counterpart and refuses those arguments.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

# the Chrome-trace categories of device work: kernels, copies and memsets
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _tensors(result) -> Iterator[torch.Tensor]:
    """The tensors of a result: a tensor, or nested lists / tuples / dicts
    of them."""
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, dict):
        for v in result.values():
            yield from _tensors(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            yield from _tensors(v)


def sync(result) -> None:
    """Wait until the device work behind ``result``'s tensors is done
    (``torch.cuda.synchronize`` on each CUDA device among them)."""
    for dev in {t.device for t in _tensors(result)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulates per-stage wall times; ``block=True`` waits for the
    device work behind the stage's result (the cudaEventSynchronize
    timing the reference comments out)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result=None, block: bool = True):
        t0 = time.perf_counter()
        out = {}
        try:
            yield out
        finally:
            val = out.get("result", result)
            if block and val is not None:
                sync(val)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for k in sorted(self.totals):
            n = self.counts[k]
            lines.append(f"{k}: total {self.totals[k]:.3f}s, "
                         f"mean {self.totals[k] / max(n, 1) * 1e3:.2f}ms "
                         f"over {n} calls")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "agt_trace")):
    """``torch.profiler`` capture around a code region (CPU ops, and the
    CUDA device's when there is one), written as a Chrome trace
    ``<log_dir>/<time>.pt.trace.json`` (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{time.time_ns()}.pt.trace.json"))


def time_fn(fn, *args, iters: int = 10, warmup: int = 2,
            **kw) -> float:
    """Steady-state seconds/call of ``fn`` (waits for the device after the
    warm-up and after the timed calls)."""
    for _ in range(warmup):
        sync(fn(*args, **kw))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kw)
    sync(out)
    return (time.perf_counter() - t0) / iters


def host_sync(result) -> float:
    """Read a scalar of ``result``'s first tensor on the host: a completion
    barrier that holds on any backend, since the value must exist."""
    leaf = next(_tensors(result))
    return float(leaf.sum())


def time_fn_synced(fn, *args, iters: int = 10, warmup: int = 2,
                   **kw) -> float:
    """``time_fn`` with a host-scalar barrier instead of a synchronize."""
    for _ in range(warmup):
        host_sync(fn(*args, **kw))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kw)
    host_sync(out)
    return (time.perf_counter() - t0) / iters


def trace_report(trace_dir: str, jitted_fn=None, fn_args=(),
                 top: int = 25) -> str:
    """Sum the device events (``DEVICE_KINDS``: kernels, copies and
    memsets) of the newest Chrome trace under ``trace_dir`` by name, one
    line a name, the longest first: total ms, calls, name.

    Usage:
        with trace(d) as d:
            for _ in range(3): host_sync(step(...))
        print(trace_report(d))

    ``jitted_fn`` / ``fn_args`` (the JAX package's XLA-fusion-to-source
    mapping) have no counterpart here and are refused."""
    if jitted_fn is not None or fn_args:
        raise NotImplementedError(
            "trace_report maps no XLA fusions to source lines in the "
            "PyTorch port: kernel names are reported as they are")
    files = glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json*"),
                      recursive=True)
    if not files:
        return "no trace files found"
    path = max(files, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        tr = json.load(f)

    dur = collections.Counter()
    calls = collections.Counter()
    for e in tr.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in DEVICE_KINDS:
            dur[e["name"]] += e.get("dur", 0)
            calls[e["name"]] += 1
    if not dur:
        return f"no events of {DEVICE_KINDS} in {path}"
    return "\n".join(f"{d / 1e3:10.3f} ms {calls[n]:6d} calls  {n[:90]}"
                     for n, d in dur.most_common(top))
