"""The program's own spans against a profiled stretch: every device
operation put down to the span that launched it, every idle gap to the
innermost span open at its middle.

``animatablegaussians_torch.utils.profiling`` records spans while a
profiler records, on ``time.time_ns()``; the trace's ``ts`` is ``(ns -
baseTimeNanoseconds) / 1000``. An operation is matched by its correlation
id to the CUDA runtime call that launched it, and goes to the innermost
span open when that call started on the launching thread or, where that
thread had none open (the autograd engine's), on the main thread (the
thread of the root spans). Threads are matched as ``thread_map`` says.
A program that keeps no spans gives nothing to read.

    python3 -m portbench.yardstick.spans --workload <cell> --seed <n>

runs a traced run of the cell and prints its stretch by span.
"""

from __future__ import annotations

import bisect
import glob
import importlib
import json
import os
import sys
from collections import Counter

from portbench.yardstick.trace import DEVICE_CATS, HOST_CATS, MARKER, Trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_DIR = os.path.join(ROOT, "portbench_out")
PROGRAM = "animatablegaussians_torch.utils.profiling"
OUTSIDE = None   # the key of what no span holds
_cache = {}


def program_spans():
    """The program's span records, or None where it keeps none."""
    mod = sys.modules.get(PROGRAM)
    if mod is None:
        try:
            mod = importlib.import_module(PROGRAM)
        except ImportError:
            return None
    fn = getattr(mod, "spans", None)
    return fn() if callable(fn) else None


def load_raw(tr: Trace):
    """(events, baseTimeNanoseconds) of the trace file under ``OUT_DIR``
    that ``tr`` was read from (the newest whose stretch and operations
    are ``tr``'s), or None."""
    files = sorted(glob.glob(os.path.join(OUT_DIR, "trace-*.json")),
                   key=os.path.getmtime, reverse=True)
    for path in files:
        try:
            with open(path) as f:
                raw = json.load(f)
            t = Trace(raw["traceEvents"])
        except (OSError, ValueError, KeyError):
            continue
        if (t.lo, t.hi, len(t.device)) == (tr.lo, tr.hi, len(tr.device)):
            return raw["traceEvents"], raw.get("baseTimeNanoseconds", 0)
    return None


def of(m):
    """The ``Attribution`` of a run's stretch (``m`` as the metric readers
    get it), or None without a trace or without the program's spans."""
    tr = m.trace
    if tr is None:
        return None
    key = id(tr)
    if key not in _cache:
        recs = program_spans()
        raw = load_raw(tr) if recs else None
        _cache.clear()
        _cache[key] = (tr, None if raw is None else
                       Attribution(raw[0], raw[1], recs, tr))
    return _cache[key][1]


def thread_map(spans, host: list) -> dict:
    """The trace's host thread ids -> the spans' native thread ids. A
    thread matches where the trace uses its native id or the low 32 bits
    of its ``threading.get_ident()``; CUPTI's id does not always match
    that (PERF.md §6). A span thread left unmatched, the one with the
    fewest spans first, takes the unmatched trace thread with the most
    runtime calls inside its spans: a thread's calls fall inside its own
    spans, while another thread's calls fall inside them only where the
    two ran at once."""
    spans = list(spans)
    by_thread = {}
    for s in spans:
        by_thread.setdefault(s["tid"], []).append(s)
    starts = {}
    for e in host:
        starts.setdefault(e.get("tid"), []).append(float(e["ts"]))
    for ts in starts.values():
        ts.sort()
    out = {}
    for tid, ss in by_thread.items():
        for key in (tid, ss[0].get("ident", tid) & 0xFFFFFFFF):
            if key in starts:
                out[key] = tid
    left = set(starts) - set(out)
    for tid in sorted(set(by_thread) - set(out.values()),
                      key=lambda t: len(by_thread[t])):
        if not left:
            break
        inside = {}
        for key in left:
            ts = starts[key]
            inside[key] = sum(bisect.bisect_left(ts, s["b"])
                              - bisect.bisect_left(ts, s["a"])
                              for s in by_thread[tid])
        best = max(sorted(left), key=inside.get)
        if inside[best] > 0:
            out[best] = tid
            left.discard(best)
    return out


class Attribution:
    """A stretch's device seconds, idle seconds and kernel launches by
    span id (``OUTSIDE`` for none), from the trace's ``events``, its
    ``base_ns`` and the program's span ``records``."""

    def __init__(self, events: list, base_ns: int, records: list,
                 tr: Trace):
        self.tr = tr
        lo, hi = tr.lo, tr.hi
        spans = {}
        for r in records:
            if r.get("end_ns") is None:
                continue
            a = (r["start_ns"] - base_ns) / 1e3
            b = (r["end_ns"] - base_ns) / 1e3
            if b > lo and a < hi:
                spans[r["id"]] = dict(r, a=a, b=b)
        for s in spans.values():   # depth and root within the stretch
            chain = self._chain(spans, s)
            s["depth"], s["root"] = len(chain) - 1, chain[-1]["id"]
        self.spans = spans
        roots = Counter(s["tid"] for s in spans.values()
                        if s["parent"] not in spans)
        self.main = roots.most_common(1)[0][0] if roots else None
        host = [e for e in events
                if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
        thread = thread_map(spans.values(), host)
        calls = {}
        for e in host:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                calls[c] = (float(e["ts"]), thread.get(e.get("tid")))
        ops = []   # ((launch time, thread) or None, seconds, kernel?)
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS \
                    or "dur" not in e or MARKER in e.get("name", ""):
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if not (b > lo and a < hi):   # as the Trace clips them
                continue
            c = calls.get((e.get("args") or {}).get("correlation"))
            ops.append((c, (min(b, hi) - max(a, lo)) * 1e-6,
                        e.get("cat") == "kernel"))
        gaps = tr.gaps()

        # one sweep over the spans' edges answers every query
        queries = [(c[0], 2, i) for i, (c, _, _) in enumerate(ops) if c]
        queries += [(0.5 * (a + b), 2, len(ops) + j)
                    for j, (a, b) in enumerate(gaps)]
        edges = [(s["a"], 1, k) for k, s in spans.items()]
        edges += [(s["b"], 0, k) for k, s in spans.items()]
        held = [OUTSIDE] * (len(ops) + len(gaps))
        open_ = {}   # thread -> {span id: span}
        for t, kind, k in sorted(edges + queries, key=lambda q: q[:2]):
            if kind == 0:
                open_.get(spans[k]["tid"], {}).pop(k, None)
            elif kind == 1:
                open_.setdefault(spans[k]["tid"], {})[k] = spans[k]
            elif k < len(ops):
                th = ops[k][0][1]
                mine = open_.get(th) or open_.get(self.main) or {}
                held[k] = self._innermost(mine.values())
            else:
                held[k] = self._innermost(
                    s for d in open_.values() for s in d.values())

        self.device, self.idle, self.launches = {}, {}, {}
        for (c, s, kernel), k in zip(ops, held):
            self.device[k] = self.device.get(k, 0.0) + s
            self.launches[k] = self.launches.get(k, 0) + int(kernel)
        for (a, b), k in zip(gaps, held[len(ops):]):
            self.idle[k] = self.idle.get(k, 0.0) + (b - a) * 1e-6

    @staticmethod
    def _chain(spans: dict, s: dict) -> list:
        out = [s]
        while out[-1]["parent"] in spans and len(out) < 1000:
            out.append(spans[out[-1]["parent"]])
        return out

    @staticmethod
    def _innermost(candidates):
        best = None
        for s in candidates:
            if best is None or (s["depth"], s["a"]) > (best["depth"],
                                                      best["a"]):
                best = s
        return OUTSIDE if best is None else best["id"]

    def _keys(self, include, exclude=None) -> set:
        """Span ids that are, or lie below, a span whose name ``include``
        accepts, and neither are nor lie below one ``exclude`` accepts."""
        out = set()
        for k, s in self.spans.items():
            names = [x["name"] for x in self._chain(self.spans, s)]
            if any(map(include, names)) and not (
                    exclude and any(map(exclude, names))):
                out.add(k)
        return out

    def device_s(self, include, exclude=None) -> float:
        keys = self._keys(include, exclude)
        return sum(v for k, v in self.device.items() if k in keys)

    def idle_s(self, include, exclude=None) -> float:
        keys = self._keys(include, exclude)
        return sum(v for k, v in self.idle.items() if k in keys)

    def host_s(self, include) -> float:
        """Host seconds inside spans whose name ``include`` accepts (the
        outermost of nested ones), within the stretch."""
        lo, hi = self.tr.lo, self.tr.hi
        keys = self._keys(include)
        return sum((min(s["b"], hi) - max(s["a"], lo)) * 1e-6
                   for k, s in self.spans.items() if k in keys
                   and s["parent"] not in keys)

    def args_sum(self, name: str, arg: str) -> float:
        """The sum of the arg ``arg`` over the stretch's spans ``name``."""
        return sum(float(s["args"].get(arg, 0)) for s in self.spans.values()
                   if s["name"] == name)

    def root_keys(self) -> set:
        return {k for k, s in self.spans.items() if s["root"] == k}

    def by_name(self) -> list:
        """[name, device s, idle s, kernel launches] by span name, the
        roots' self time as "<root> (self)" and "outside every span"."""
        rows = {}
        roots = self.root_keys()
        for table, col in ((self.device, 0), (self.idle, 1),
                           (self.launches, 2)):
            for k, v in table.items():
                if k is OUTSIDE:
                    name = "outside every span"
                else:
                    name = self.spans[k]["name"] + (" (self)" if k in roots
                                                    else "")
                rows.setdefault(name, [0.0, 0.0, 0])[col] += v
        return sorted(([n] + v for n, v in rows.items()),
                      key=lambda r: -(r[1] + r[2]))


def coverage(a: Attribution) -> dict:
    """The stretch's coverage: device seconds put down to a span, idle
    seconds in a root's self time or outside every span."""
    dev = sum(a.device.values())
    idle = sum(a.idle.values())
    roots = a.root_keys()
    loose = sum(v for k, v in a.idle.items() if k is OUTSIDE or k in roots)
    return dict(device_s=dev, spanned_device_share=(
        1 - a.device.get(OUTSIDE, 0.0) / dev if dev else None),
        idle_s=idle, loose_idle_share=loose / idle if idle else None)


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    a = p.parse_args(argv)
    from portbench import run as R
    seen, reader = {}, R.reader

    def keep(name):   # the readers' view of the run, kept for the report
        fn = reader(name)
        return lambda m: fn(seen.setdefault("m", m))

    R.reader = keep
    try:
        res = R.run(a.workload, a.seed, a.seconds, True)
    finally:
        R.reader = reader
    m = seen.get("m")
    raw = load_raw(m.trace) if m and m.trace else None
    recs = program_spans()
    if not recs or raw is None:
        print("no spans to read", file=sys.stderr)
        return 1
    att = Attribution(raw[0], raw[1], recs, m.trace)
    n = m.traced_frames or 1
    print(json.dumps(dict(
        workload=a.workload, correct=res["correct"], frames=n,
        metrics={k: v["value"] for k, v in res["metrics"].items()},
        ref_pairs_mean=sum(m.pairs) / len(m.pairs) if m.pairs else None,
        window_s=m.trace.window_s, busy_s=m.trace.busy_s,
        spans=len(att.spans), calls=len(att.root_keys()),
        coverage=coverage(att),
        by_span_ms_a_frame=[[r[0], 1e3 * r[1] / n, 1e3 * r[2] / n,
                             r[3] / n] for r in att.by_name()])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
