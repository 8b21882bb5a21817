"""Reading a ``torch.profiler`` Chrome trace of a profiled stretch: device
operations by name, the device's busy time as the union of its kernel,
copy and memset intervals, and the idle gaps by the CUDA runtime or
driver call the host was in. The stretch is the span of the marker
kernels launched at its two ends on an idle device; where the profiler
lost one, that end is the outermost device operation, as the trace
holds nothing but the stretch.
"""

from __future__ import annotations

import bisect
import json

MARKER = "spin_kernel"   # torch.cuda._sleep's kernel
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


class Trace:
    """Events of one profiled stretch, in microseconds."""

    def __init__(self, events: list):
        self.device, self.host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e["dur"])
            if cat in DEVICE_CATS:
                self.device.append((e.get("name", cat), ts, ts + dur, cat))
            elif cat in HOST_CATS:
                self.host.append((e.get("name", cat), ts, ts + dur))
        if not self.device:
            raise ValueError("the trace holds no device operation")
        marks = sorted((a, b) for n, a, b, _ in self.device if MARKER in n)
        self.marked = len(marks) >= 2
        self.lo = marks[0][0] if self.marked else min(
            a for _, a, _, _ in self.device)
        self.hi = marks[-1][1] if self.marked else max(
            b for _, _, b, _ in self.device)
        self.device = [(n, max(a, self.lo), min(b, self.hi), c)
                       for n, a, b, c in self.device if b > self.lo
                       and a < self.hi]

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    def busy_intervals(self) -> list:
        out = []
        for _, a, b, _ in sorted(self.device, key=lambda e: e[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_s(self, match) -> float:
        """Summed device seconds of the operations whose name ``match``
        accepts."""
        return sum(b - a for n, a, b, _ in self.device if match(n)) * 1e-6

    def launches(self) -> int:
        """The program's kernel launches in the stretch (copies, memsets
        and the marker kernels left out)."""
        return sum(1 for n, _, _, c in self.device
                   if c == "kernel" and MARKER not in n)

    def top_ops(self, k: int = 10) -> list:
        tot = {}
        for n, a, b, _ in self.device:
            tot[n] = tot.get(n, 0.0) + (b - a) * 1e-6
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda r: -r[1])[:k]

    def gaps(self) -> list:
        """(start, end) of the stretch's stretches with no device work."""
        out, t = [], self.lo
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.hi > t:
            out.append((t, self.hi))
        return out

    def idle_by_host(self, k: int = 10) -> list:
        """The idle seconds summed by the innermost CUDA runtime or driver
        call running at each gap's middle (the profiler's own names; "host,
        outside any CUDA call" where none is). Calls nest, so the innermost
        one is the latest to start of those that still run."""
        host = sorted(self.host, key=lambda e: e[1])
        starts = [s for _, s, _ in host]
        tot = {}
        for a, b in self.gaps():
            mid = 0.5 * (a + b)
            name = "host, outside any CUDA call"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 20000, -1), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda r: -r[1])[:k]
