"""The benchmark of ``animatablegaussians_torch`` on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

run from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``: it names a configuration (``portbench/configs/<name>
.json``) and a traffic mix (``portbench/traffic/<name>.json``), whose
``driver`` names the loop that drives the program
(``portbench/drivers/<driver>.py``). A metric is read by
``portbench/metrics/<name>.py``, or by the file of its name's part before
the first dot. The run sets up the program and its inputs from the seed,
warms up, measures for ``--seconds`` (``--trace 1`` profiles a few calls
of that window), frees the program and holds a sample of what the window
produced against the plain reference under ``portbench/reference/``,
within the limits of ``portbench/limits/<cell>.json``. The last line of
standard output is the result, as JSON; the numbers compared are the last
lines of standard error. Without a CUDA device the run stops, with no
result.
"""

from __future__ import annotations

import os
import sys
import time

T_IMPORT = time.time()


def _process_start() -> float:
    """The process's start on the wall clock (``/proc``; else now)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(float(ln.split()[1]) for ln in f
                        if ln.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


T0 = min(_process_start(), T_IMPORT)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel and compiler caches at fixed paths inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = os.path.join(ROOT, "build", "portbench-cache", _sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import traceback  # noqa: E402
import types  # noqa: E402

MARK_CYCLES = 1000   # the stretch's marker kernels, about a microsecond
MARK_GAP_S = 0.005   # host time between a marker and the record's edge
FORBIDDEN = ("jax", "jaxlib", "flax", "animatablegaussians_tpu")
HERE = os.path.join(ROOT, "portbench")
OUT_DIR = os.path.join(ROOT, "portbench_out")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(name: str, bench: dict = None) -> dict:
    """The cell's entry, configuration, traffic and limits, by name."""
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return dict(
        entry=entry, bench=bench,
        cfg=load_json(ROOT, cfg["file"]),
        traffic=load_json(HERE, "traffic", entry["traffic"] + ".json"),
        limits=load_json(HERE, "limits", name + ".json"))


def metrics_of(bench: dict, name: str, trace: bool) -> list:
    """The cell's metrics: end-to-end without the trace, per-layer with."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(metric: str):
    """``metrics/<name>.py``, else ``metrics/<name before the first
    dot>.py``."""
    for stem in (metric, metric.split(".")[0]):
        path = os.path.join(HERE, "metrics", stem + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                f"portbench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {metric!r}")


def driver_class(name: str):
    return importlib.import_module(f"portbench.drivers.{name}").Driver


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class Stretch:
    """The profiled stretch of a ``--trace 1`` run: ``n`` calls of the
    window from call ``first``. The profiler starts one call earlier and
    keeps that call as its warm-up, whose events it drops, so that its
    own start lies outside the stretch; marker kernels launched on the
    idle device bound the stretch there, each some way from the edges of
    the profiler's record, which drops a kernel that it dates before its
    start."""

    def __init__(self, dev, first: int, n: int, label: str):
        self.dev, self.first, self.n = dev, first, n
        self.path = os.path.join(OUT_DIR, f"trace-{label}.json")
        self.frames, self.call_s, self.prof = [], [], None

    def pending(self, calls: int) -> bool:
        return calls < self.first + self.n

    def before(self, calls: int) -> None:
        import torch
        if calls == self.first - 1:
            from torch.profiler import ProfilerActivity, profile, schedule
            os.makedirs(OUT_DIR, exist_ok=True)
            if os.path.exists(self.path):   # never read an earlier run's
                os.remove(self.path)
            self.prof = profile(
                activities=[ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=self.n, repeat=1),
                on_trace_ready=lambda p: p.export_chrome_trace(self.path))
            self.prof.__enter__()
        elif calls == self.first:
            time.sleep(MARK_GAP_S)
            torch.cuda._sleep(MARK_CYCLES)

    def after(self, calls: int, frames: list, call_s: float) -> None:
        if calls == self.first - 1:
            self.prof.step()
        if not self.first <= calls < self.first + self.n:
            return
        self.frames.extend(frames)
        self.call_s.append(call_s)
        if calls == self.first + self.n - 1:
            import torch
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize(self.dev)
            time.sleep(MARK_GAP_S)
            self.prof.step()   # the last active step: the trace is written
            self.prof.__exit__(None, None, None)
            self.prof = None
        else:
            self.prof.step()

    def ms(self) -> str:
        return ", ".join(f"{1e3 * t:.3f}" for t in self.call_s)

    def trace(self):
        from portbench.yardstick.trace import Trace
        return Trace.load(self.path)


def run(workload: str, seed: int, seconds: float, trace: bool,
        device=None, overrides=None, fault=None, bench=None,
        control: bool = False, readings: bool = False) -> dict:
    """One run of a cell; -> the result dict. ``device`` defaults to the
    first CUDA device; ``overrides`` (dict of dicts) replaces entries of
    the configuration and the traffic, ``fault`` plants a fault in the
    driver (tests at small sizes use both). ``control`` adds the
    control's numbers under "control", ``readings`` every number the
    check compares under "numbers" and a train cell's leaf norms under
    "leaves" (``readings.py``; the benchmark's own runs do neither)."""
    import torch

    from portbench.drivers import common

    c = cell(workload, bench)
    for key, extra in (overrides or {}).items():
        target = c["traffic"] if key == "traffic" else c["cfg"].setdefault(
            key, {})
        target.update(extra)
    dev = torch.device(device or "cuda:0")
    ctx = types.SimpleNamespace(cfg=c["cfg"], traffic=c["traffic"],
                                seed=int(seed), device=dev, parts={})
    ctx.parts["imports"] = time.time() - T0
    common.precision(ctx.cfg)
    torch.set_num_threads(4)
    if dev.type == "cuda":
        from animatablegaussians_torch.utils import cuda_build
        with common.part(ctx, "kernels"):
            cuda_build.load()
    drv = driver_class(c["traffic"]["driver"])(ctx)
    drv.fault = fault
    drv.setup()
    setup_s = time.time() - T0 if dev.type == "cuda" else sum(
        ctx.parts.values())
    log("setup_s parts: " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in ctx.parts.items()))

    # -- the window --------------------------------------------------------
    # --trace 1 profiles calls 2..n+1 of the window for the device and the
    # CUDA runtime calls only: tracing the host's ops too slows every call
    # and swells the idle share it would measure
    stretch = Stretch(dev, 2, int(c["traffic"]["trace_calls"]),
                      workload) if trace else None
    lat, frames, failed, calls = [], 0, 0, 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_start = time.perf_counter()
    t_end = t_start
    while t_end - t_start < seconds or (stretch and stretch.pending(calls)):
        if stretch:
            stretch.before(calls)
        t = time.perf_counter()
        try:
            n, bad = drv.call()
        except Exception:  # a call that raises fails its frames; go on
            log(traceback.format_exc(limit=4))
            n = bad = drv.frames_per_call
        t_end = time.perf_counter()
        if stretch:
            stretch.after(calls, drv.last_frames, t_end - t)
        calls += 1
        frames += n
        failed += bad
        lat.append(1e3 * (t_end - t))
    window = dict(seconds=t_end - t_start, frames=frames, calls=calls,
                  latency_ms=lat)
    mem_peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
    log(f"window: {calls} calls, {frames} frames in {window['seconds']:.4f}"
        f" s; call ms median {sorted(lat)[len(lat) // 2]:.3f}, samples "
        f"{len(lat)}; device {power_limit() if dev.type == 'cuda' else dev}")

    # -- the check ---------------------------------------------------------
    t_check = time.perf_counter()
    traced = stretch.frames if stretch else []
    numbers = drv.check(traced)
    log(f"check: {time.perf_counter() - t_check:.3f} s")
    limits = c["limits"]
    correct = failed == 0 and all(
        numbers[k] <= limits[k] for k in limits)

    # -- per-layer metrics --------------------------------------------------
    result_metrics = {}
    tr = None
    if stretch:
        log(f"traced: {len(traced)} frames; call ms {stretch.ms()}")
        try:
            tr = stretch.trace()
            if not tr.marked:
                log("the trace lacks a marker kernel: the stretch is bounded "
                    "by its first and last device operation")
        except (OSError, ValueError) as e:  # the profiler lost the stretch
            log(f"the trace cannot be read: {e}")
            traced = []
    m = types.SimpleNamespace(
        window=window, setup_s=setup_s, trace=tr,
        traced_frames=len(traced), cfg=ctx.cfg, traffic=ctx.traffic,
        train=c["traffic"]["driver"] == "train",
        batch=int(c["traffic"].get("batch", 1)), n_points=drv.n_points,
        img_size=drv.img_size, pairs=None)
    wanted = metrics_of(c["bench"], workload, trace)
    m.pairs = drv.ref_pairs
    for spec in wanted:
        value = reader(spec["name"])(m)
        if value is not None:
            result_metrics[spec["name"]] = dict(value=value, unit=spec["unit"])

    found = forbidden_modules()
    if found and dev.type == "cuda":
        log(f"the run loaded {found}: the benchmark must not")
        raise SystemExit(3)
    device_info = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                       kind=(torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu"),
                       count=1, memory_peak_bytes=int(mem_peak))
    result = dict(correct=bool(correct), attempted=frames, failed=failed,
                  metrics=result_metrics, device=device_info)
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = dict(device_ops=tr.top_ops(10),
                                   idle_gaps=tr.idle_by_host(10))
    if control:
        result["control"] = drv.control()
    if readings:
        result["numbers"] = numbers
        result["leaves"] = getattr(drv, "leaves", None)
    result["checks"] = {k: dict(value=numbers[k], limit=limits[k])
                        for k in limits}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    c = cell(a.workload)
    import torch
    need = int(c["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"portbench needs {need} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            ": no result")
        return 2
    result = run(a.workload, a.seed, a.seconds, bool(a.trace))
    for k, v in result["checks"].items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
