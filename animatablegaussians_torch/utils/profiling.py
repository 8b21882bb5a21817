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

The program's own record: ``span(name, **args)`` marks a stretch of host
time (a context manager and a decorator) and ``count(name, n)`` adds to a
named counter. Spans record only while a ``torch.profiler`` is recording
(``torch.autograd.profiler._is_profiler_enabled``); otherwise a span is
one bool test and records nothing. A record's times are ``time.time_ns()``,
the clock of the profiler's trace: ``(ns - baseTimeNanoseconds) / 1000``
is its ``ts``. ``trace`` writes the spans into the Chrome trace it
exports. Counters are always on.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import glob
import gzip
import itertools
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch
from torch.autograd import profiler as _autograd_profiler

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
    ``<log_dir>/<time>.pt.trace.json`` (chrome://tracing, Perfetto) with
    the program's spans of the region as events of category
    ``program``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.time_ns()
    with profile(activities=acts) as prof:
        yield log_dir
    path = os.path.join(log_dir, f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, [r for r in spans() if r["start_ns"] >= t0])


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


# -- the program's spans and counters ---------------------------------------

SPAN_CAP = 1 << 16      # records kept; later spans are dropped and counted
DROPPED = "spans.dropped"

_records: list = []
_ids = itertools.count()  # next() is atomic: spans open on several threads
_counters: Dict[str, int] = {}
_counters_lock = threading.Lock()
_local = threading.local()
_main_stack: list = []  # the main thread's open spans


class _Record:
    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "call", "tid",
                 "ident", "args", "depth")


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        main = threading.current_thread() is threading.main_thread()
        _local.stack = _main_stack if main else []
        _local.tid = threading.get_native_id()
        _local.ident = threading.get_ident()
        return _local.stack


def _wrap(name: str, args: dict, fn):
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        if not _autograd_profiler._is_profiler_enabled:
            return fn(*a, **kw)
        with _Open(name, args):
            return fn(*a, **kw)
    return wrapper


class _Off:
    """What ``span`` gives while no profiler records: nothing to do."""
    __slots__ = ("name", "args")

    def __init__(self, name: str, args: dict):
        self.name, self.args = name, args

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass

    def __call__(self, fn):
        return _wrap(self.name, self.args, fn)


_OFF: Dict[str, _Off] = {}


class _Open:
    """A span being recorded: a record from ``__enter__`` to ``__exit__``.
    Its parent is the thread's innermost open span or, on a thread with
    none open (the autograd engine's), the main thread's; a span with no
    parent starts a call of its own."""
    __slots__ = ("name", "args", "rec", "stack")

    def __init__(self, name: str, args: dict):
        self.name, self.args, self.rec, self.stack = name, args, None, None

    def __enter__(self):
        stack = _stack()
        if len(_records) >= SPAN_CAP:
            count(DROPPED)
            return self
        parent = stack[-1] if stack else (
            _main_stack[-1] if _main_stack else None)
        r = _Record()
        r.id, r.name, r.args = next(_ids), self.name, dict(self.args)
        r.parent = parent.id if parent is not None else None
        r.call = parent.call if parent is not None else r.id
        r.depth = parent.depth + 1 if parent is not None else 0
        r.tid, r.ident, r.end_ns = _local.tid, _local.ident, None
        _records.append(r)
        stack.append(r)
        self.rec, self.stack = r, stack
        r.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        r = self.rec
        if r is not None:
            r.end_ns = time.time_ns()
            self.stack.remove(r)
        return False

    def set(self, **args) -> None:
        """Adds ``args`` to the span's record (a value known only inside
        it, such as a frame's pair count)."""
        if self.rec is not None:
            self.rec.args.update(args)

    def __call__(self, fn):
        return _wrap(self.name, self.args, fn)


def span(name: str, **args):
    """A named stretch of the program, recorded while a ``torch.profiler``
    records: ``with span("heads"): ...`` or ``@span("heads")``, ``args``
    small values kept with the record (``.set(**args)`` adds more inside
    the block). Otherwise it records nothing and allocates nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return _Open(name, args)
    if args:
        return _Off(name, args)
    off = _OFF.get(name)
    if off is None:
        off = _OFF[name] = _Off(name, {})
    return off


def spans() -> list:
    """The recorded spans, oldest first, as dicts: ``id``, ``name``,
    ``start_ns`` and ``end_ns`` (``time.time_ns()``; ``end_ns`` None while
    open), ``parent`` (an id or None), ``call`` (the id of the root span of
    the call), ``tid`` (the host thread's native id, the ``tid`` of the
    trace's host operations), ``ident`` (its ``threading.get_ident()``,
    whose low 32 bits are the ``tid`` of the trace's CUDA runtime calls),
    ``depth`` and ``args``."""
    return [dict(id=r.id, name=r.name, start_ns=r.start_ns, end_ns=r.end_ns,
                 parent=r.parent, call=r.call, tid=r.tid, ident=r.ident,
                 depth=r.depth, args=dict(r.args)) for r in _records]


def reset() -> None:
    """Drops the recorded spans and their drop count."""
    _records.clear()
    reset_counters(DROPPED)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name``; always on."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of the counters: ``fir.launches``, ``expand.launches``,
    ``blend.fwd.launches`` and ``blend.bwd.launches`` (the CUDA kernels'
    launches), ``splat.frames`` and ``splat.pairs`` (frames binned and
    their summed (Gaussian, tile) pairs), ``host.waits`` (the program's
    waits for the device) and ``spans.dropped``."""
    return dict(_counters)


def reset_counters(*names: str) -> None:
    """Zeroes the counters ``names``, or every counter."""
    with _counters_lock:
        if not names:
            _counters.clear()
        for n in names:
            _counters.pop(n, None)


def _add_spans(path: str, records: list) -> None:
    """Writes span ``records`` (as ``spans()`` gives them) into the Chrome
    trace at ``path`` as complete events of category ``program``, each on
    its thread's row (the host operations' native thread ids), on the
    trace's clock."""
    with open(path) as f:
        tr = json.load(f)
    base = tr.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    for r in records:
        if r["end_ns"] is None:
            continue
        tr["traceEvents"].append(dict(
            ph="X", cat="program", name=r["name"], pid=pid, tid=r["tid"],
            ts=(r["start_ns"] - base) / 1e3,
            dur=(r["end_ns"] - r["start_ns"]) / 1e3,
            args=dict(r["args"], id=r["id"], parent=r["parent"],
                      call=r["call"])))
    with open(path, "w") as f:
        json.dump(tr, f, default=str)
