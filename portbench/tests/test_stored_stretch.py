"""A stretch profiled on an H100 (the train-b1 cell at a tiny size, one
step; ``data/stretch_b1_tiny.json.gz``: the trace's runtime calls and
device operations, the program's spans and the readers' view of the run)
read on the CPU: every per-layer metric reads what the card's run read,
the metrics that were there before the spans included."""

import gzip
import json
import os
import types

import pytest

from portbench import run as R
from portbench.yardstick import spans as S
from portbench.yardstick.trace import Trace

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "stretch_b1_tiny.json.gz")
# the readers of the benchmark as it was before the spans, at the parent
# commit, on this stretch
BEFORE = {"idle_pct.train": 92.50880224103442,
          "mfu.train": 0.07322691010354072,
          "conv_ms.train": 4.525993408203125,
          "fir_roofline_pct.train": 1.5248734979326508,
          "blend_bwd_roofline_pct.train": 0.12495394621868054}


def _stored():
    with gzip.open(DATA, "rt") as f:
        d = json.load(f)
    events = []
    for cat, name, ts, dur, tid, corr in d["rows"]:
        e = dict(ph="X", cat=d["cats"][cat], name=d["names"][name], ts=ts,
                 dur=dur, pid=0, tid=tid)
        if corr is not None:
            e["args"] = dict(correlation=corr)
        events.append(e)
    return d, events


@pytest.fixture
def stretch(tmp_path, monkeypatch):
    d, events = _stored()
    path = tmp_path / "trace-zzr-train-b1.json"
    path.write_text(json.dumps(dict(
        baseTimeNanoseconds=d["baseTimeNanoseconds"], traceEvents=events)))
    monkeypatch.setattr(S, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(S, "program_spans", lambda: d["spans"])
    view = dict(d["view"], img_size=tuple(d["view"]["img_size"]))
    m = types.SimpleNamespace(trace=Trace.load(str(path)), **view)
    return d, m


def test_every_metric_reads_as_on_the_card(stretch):
    d, m = stretch
    names = [x["name"] for x in R.metrics_of(R.cell("zzr-train-b1")["bench"],
                                            "zzr-train-b1", True)]
    assert sorted(names) == sorted(d["metrics"])
    for name in names:
        assert R.reader(name)(m) == pytest.approx(d["metrics"][name],
                                                  rel=1e-12), name


def test_the_earlier_metrics_read_as_before(stretch):
    _, m = stretch
    for name, value in BEFORE.items():
        assert R.reader(name)(m) == pytest.approx(value, rel=1e-12), name


def test_the_card_s_spans_cover_its_stretch(stretch):
    d, m = stretch
    a = S.of(m)
    assert S.coverage(a)["spanned_device_share"] > 0.99
    roots = [a.spans[k]["name"] for k in a.root_keys()]
    assert roots == ["train.step"]
    # the step's one frame, binned once at the weights of that step
    assert a.args_sum("splat.binning", "pairs") == 3629
