"""The template step's spans and counters (``utils/profiling.py``) on the
CPU: under a profiler one ``TemplateStep`` call opens ``template.step``
and, below it, every span of the template's layers with its args; the
counters count the nearest-face searches' calls and (point, face) pairs
of the body and both hands and the root finding's points; and the spans
leave the step's outputs as they are, bit for bit."""

import copy
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from animatablegaussians_torch.utils import profiling as P
from portbench import run as R
from portbench.drivers import common
from portbench.drivers import template as drv

TINY = {"body": {"n_verts": 230, "n_faces": 400, "mano_verts": 40,
                 "mano_faces": 76, "volume_res": 16},
        "camera": {"img_w": 96, "img_h": 128, "train_focal": 115.2},
        "train": {"rays": 32, "n_samples": 8}}


@pytest.fixture(scope="module")
def driver():
    c = R.cell("zzr-template-train")
    for key, extra in TINY.items():
        c["cfg"][key].update(extra)
    c["traffic"]["check_steps"] = 1
    ctx = types.SimpleNamespace(cfg=c["cfg"], traffic=c["traffic"],
                                seed=7, device=torch.device("cpu"), parts={})
    common.precision(ctx.cfg)
    d = drv.Driver(ctx)
    d.setup()
    return d


@pytest.fixture(autouse=True)
def _fresh():
    P.reset()
    P.reset_counters()
    yield
    P.reset()
    P.reset_counters()


def _state(d):
    return (copy.deepcopy(d.net.state_dict()),
            copy.deepcopy(d.step.optimizer.state_dict()),
            copy.deepcopy(d.step.scheduler.state_dict()), d.gen.get_state())


def _restore(d, st):
    d.net.load_state_dict(st[0])
    d.step.optimizer.load_state_dict(st[1])
    d.step.scheduler.load_state_dict(st[2])
    d.gen.set_state(st[3])


def test_step_spans_and_args(driver):
    items = driver.pool[0]
    with profile(activities=[ProfilerActivity.CPU]):
        driver.step(items, driver.gen)
    rec = P.spans()
    by_id = {r["id"]: r for r in rec}
    names = [r["name"] for r in rec]
    root = [r for r in rec if r["parent"] is None]
    assert [r["name"] for r in root] == ["template.step"]
    for name in ("template.near_far", "template.live2cano", "root_finding",
                 "template.field", "template.hands", "template.composite",
                 "losses", "backward", "adam"):
        assert names.count(name) == 1, name
    assert names.count("nearest_face") == 3
    assert all(r["call"] == root[0]["id"] for r in rec)

    def parent(r):
        return by_id[r["parent"]]["name"]
    n = 32 * 8
    f_body = TINY["body"]["n_faces"]
    f_hand = TINY["body"]["mano_faces"]
    searches = [r for r in rec if r["name"] == "nearest_face"]
    assert [(parent(r), r["args"]) for r in searches] == [
        ("template.live2cano", dict(points=n, faces=f_body,
                                    pairs=n * f_body)),
        ("template.hands", dict(points=n, faces=f_hand, pairs=n * f_hand)),
        ("template.hands", dict(points=n, faces=f_hand, pairs=n * f_hand))]
    rf = next(r for r in rec if r["name"] == "root_finding")
    assert parent(rf) == "template.live2cano" and rf["args"] == dict(
        points=n)
    for name in ("template.near_far", "template.live2cano", "template.field",
                 "template.hands", "template.composite", "losses",
                 "backward", "adam"):
        r = next(r for r in rec if r["name"] == name)
        assert parent(r) == "template.step", name


def test_counters_count_the_searches(driver):
    driver.step(driver.pool[1], driver.gen)
    n = 32 * 8
    b = TINY["body"]
    c = P.counters()
    assert c["nearest_face.calls"] == 3
    assert c["nearest_face.pairs"] == n * (b["n_faces"] + 2 * b["mano_faces"])
    assert c["root_finding.points"] == n
    assert P.spans() == []       # no profiler, no record


def test_spans_leave_the_step_bit_for_bit(driver):
    st = _state(driver)
    items = driver.pool[2]
    plain = driver.step(items, driver.gen)
    after = {k: v.clone() for k, v in driver.net.state_dict().items()}
    _restore(driver, st)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = driver.step(items, driver.gen)
    assert P.spans()
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k
    for k, v in driver.net.state_dict().items():
        assert torch.equal(v, after[k]), k
