"""The span readers against a hand-made stretch: a trace of runtime calls
and device operations, and the program's spans, with every value worked
by hand. Operations go to the span open on their launching thread (the
CUDA runtime's thread id the low 32 bits of the span's
``threading.get_ident()``, or matched by the calls inside the thread's
spans), else on the main thread; idle gaps to the innermost span open at
their middle."""

import json
import types

import pytest

from portbench import run as R
from portbench.yardstick import spans as S
from portbench.yardstick.trace import Trace

BASE = 1_790_000_000_000_000_000   # baseTimeNanoseconds
MAIN, AUTOGRAD = (11, (5 << 32) | 777), (22, (5 << 32) | 888)


def _span(id_, name, a_us, b_us, parent, thread=MAIN, **args):
    return dict(id=id_, name=name, start_ns=BASE + int(a_us * 1000),
                end_ns=BASE + int(b_us * 1000), parent=parent, call=1,
                tid=thread[0], ident=thread[1], depth=0, args=args)


SPANS = [
    _span(1, "train.step", 1010, 1990, None),
    _span(2, "heads", 1020, 1300, 1),
    _span(3, "splat.binning", 1300, 1400, 1, pairs=1000),
    _span(4, "wait.pairs", 1320, 1380, 3),
    _span(5, "losses", 1400, 1500, 1),
    _span(6, "backward", 1500, 1900, 1),
    _span(7, "splat.blend_bwd", 1600, 1700, 6, thread=AUTOGRAD),
]


def _ev(name, cat, ts, dur, tid=0, corr=None):
    e = dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=0, tid=tid)
    if corr is not None:
        e["args"] = dict(correlation=corr)
    return e


def _launch(ts, thread, corr):
    return _ev("cudaLaunchKernel", "cuda_runtime", ts, 5.0,
               thread[1] & 0xFFFFFFFF, corr)


EVENTS = [
    _ev("at::cuda::spin_kernel(long)", "kernel", 1000.0, 1.0, 7, 100),
    _ev("at::cuda::spin_kernel(long)", "kernel", 1999.0, 1.0, 7, 101),
    _launch(1030, MAIN, 1), _ev("fir_kernel", "kernel", 1040, 100, 7, 1),
    _launch(1200, MAIN, 8), _ev("fir_kernel", "kernel", 1210, 80, 7, 8),
    _launch(1310, MAIN, 2), _ev("expand_pairs_kernel", "kernel", 1390, 20,
                                7, 2),
    _launch(1410, MAIN, 3), _ev("sm90_xmma_fprop", "kernel", 1420, 50, 7, 3),
    _launch(1610, AUTOGRAD, 4), _ev("blend_backward_kernel", "kernel", 1620,
                                    60, 7, 4),
    # the autograd thread has no span open: the main thread's backward
    _launch(1710, AUTOGRAD, 5), _ev("dgrad_engine", "kernel", 1720, 100, 7,
                                    5),
    _launch(1950, MAIN, 6), _ev("Memcpy DtoH", "gpu_memcpy", 1950, 10, 7, 6),
    # no launching call in the trace: outside every span
    _ev("elementwise_kernel", "kernel", 1970, 5, 7, 99),
]
FRAMES = 2


def _m(tmp_path, monkeypatch, spans=SPANS):
    path = tmp_path / "trace-x.json"
    path.write_text(json.dumps(dict(baseTimeNanoseconds=BASE,
                                    traceEvents=EVENTS)))
    monkeypatch.setattr(S, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(S, "program_spans", lambda: spans)
    return types.SimpleNamespace(trace=Trace.load(str(path)),
                                 traced_frames=FRAMES)


def _other_thread_ids(events):
    """The events with each runtime call's thread id replaced by one that
    matches no span's: CUPTI's id is not always the low 32 bits of the
    thread's ``threading.get_ident()``."""
    ids = {MAIN[1] & 0xFFFFFFFF: 4242, AUTOGRAD[1] & 0xFFFFFFFF: 5353}
    return [dict(e, tid=ids[e["tid"]]) if e["cat"] == "cuda_runtime" else e
            for e in events]


@pytest.mark.parametrize("events", [EVENTS, _other_thread_ids(EVENTS)],
                         ids=["ident", "calls_inside_spans"])
def test_attribution_by_hand(events):
    a = S.Attribution(events, BASE, SPANS, Trace(events))
    us = {k: round(v * 1e6, 6) for k, v in a.device.items()}
    # fir 100 + 80 in heads; expand 20 in binning; conv 50 in losses; the
    # backward blend 60 on its own thread; dgrad 100 falls back to the main
    # thread's backward; the copy 10 in the step's self time; 5 outside
    assert us == {2: 180, 3: 20, 5: 50, 7: 60, 6: 100, 1: 10, None: 5}
    assert a.launches == {2: 2, 3: 1, 5: 1, 7: 1, 6: 1, 1: 0, None: 1}
    idle = {k: round(v * 1e6, 6) for k, v in a.idle.items()}
    # gaps: 1001-1040 (heads), 1140-1210 (heads), 1290-1390 (wait.pairs),
    # 1410-1420 (losses), 1470-1620 (backward), 1680-1720 (the middle at
    # 1700, where the blend's span has closed: backward), 1820-1950
    # (backward), 1960-1970 and 1975-1999 (the step's self time)
    assert idle == {2: 39 + 70, 4: 100, 5: 10, 6: 150 + 40 + 130,
                    1: 10 + 24}
    cov = S.coverage(a)
    assert cov["spanned_device_share"] == pytest.approx(420 / 425)
    assert cov["loose_idle_share"] == pytest.approx(34 / 573)
    rows = {r[0]: r[1:] for r in a.by_name()}
    assert rows["train.step (self)"][2] == 0
    assert rows["outside every span"][0] == pytest.approx(5e-6)
    host = [e for e in events if e["cat"] == "cuda_runtime"]
    spans = [dict(s, a=(s["start_ns"] - BASE) / 1e3,
                  b=(s["end_ns"] - BASE) / 1e3) for s in SPANS]
    assert sorted(S.thread_map(spans, host).values()) == [MAIN[0],
                                                          AUTOGRAD[0]]


def test_span_readers_by_hand(tmp_path, monkeypatch):
    m = _m(tmp_path, monkeypatch)
    want = {"heads_ms.train": 0.180 / FRAMES,
            "splat_ms.train": 0.080 / FRAMES,
            "losses_ms.train": 0.050 / FRAMES,
            "backward_ms.train": 0.100 / FRAMES,
            "heads_idle_ms.train": 0.109 / FRAMES,
            "splat_idle_ms.train": 0.100 / FRAMES,
            "host_wait_ms.train": 0.060 / FRAMES,
            "pairs_per_frame.train": 1000 / FRAMES}
    for name, value in want.items():
        assert R.reader(name)(m) == pytest.approx(value, rel=1e-9), name


def test_span_readers_read_nothing_without_the_program_s_spans(
        tmp_path, monkeypatch):
    names = ("heads_ms.x", "splat_ms.x", "losses_ms.x", "backward_ms.x",
             "heads_idle_ms.x", "splat_idle_ms.x", "host_wait_ms.x",
             "pairs_per_frame.x")
    # a program with no span API, one that recorded none, no trace
    for spans in (None, []):
        m = _m(tmp_path, monkeypatch, spans)
        for name in names:
            assert R.reader(name)(m) is None, name
    m = types.SimpleNamespace(trace=None, traced_frames=2)
    for name in names:
        assert R.reader(name)(m) is None, name


def test_the_trace_file_is_found_by_its_stretch(tmp_path, monkeypatch):
    m = _m(tmp_path, monkeypatch)
    other = [dict(e, ts=e["ts"] + 5000) for e in EVENTS]
    (tmp_path / "trace-y.json").write_text(json.dumps(
        dict(baseTimeNanoseconds=BASE, traceEvents=other)))
    events, base = S.load_raw(m.trace)
    assert base == BASE and events == EVENTS
    assert S.load_raw(Trace(other))[0] == other


def test_spans_outside_the_stretch_are_left_out():
    early = [_span(50, "render", 10, 900, None),
             _span(51, "heads", 20, 800, 50)]
    a = S.Attribution(EVENTS, BASE, SPANS + early, Trace(EVENTS))
    assert set(a.spans) == {1, 2, 3, 4, 5, 6, 7}
    assert a.args_sum("splat.binning", "pairs") == 1000
