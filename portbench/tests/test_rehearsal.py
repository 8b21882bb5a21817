"""A rehearsal of the harness on the CPU: every entry of BENCHMARK.json is
found by name, follows the contract's spelling, and each per-layer metric
is reported where its end-to-end metric is; the command refuses to run
without a card."""

import json
import os
import re
import subprocess
import sys

import pytest

from portbench import run as R

ROOT = R.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_entry_is_found_by_name():
    b = _bench()
    assert b["paths"] == ["portbench"]
    for c in b["configs"]:
        assert c["file"].startswith("portbench/configs/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["precision"] == {"dtype": "float32", "allow_tf32": False}
    for w in b["workloads"]:
        cell = R.cell(w["name"], b)
        assert R.driver_class(cell["traffic"]["driver"])
        assert set(cell["limits"]) and w["chips"] == 1
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(R.reader(m["name"]))


def test_names_and_units_are_spelled_as_the_contract_allows():
    b = _bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert 0 < len(w["why"]) <= 200 and "\n" not in w["why"]
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}


def test_the_file_has_exactly_the_keys_and_limits_of_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(b, indent=1).encode()) <= 64 * 1024
    assert 1 <= len(b["command"]) <= 32
    for word in b["command"]:
        assert 0 < len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert ((2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)
    assert 1 <= len(b["configs"]) <= 24
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] not in files and len(c["reduced"]) <= 16
        files.add(c["file"])
        for text in (c["source"], c["why"]):
            assert 0 < len(text) <= 200 and "\n" not in text
            assert "\t" not in text
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    assert 1 <= len(b["workloads"]) <= 24
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and "\t" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert 1 <= len(b["end_to_end"]) <= 16
    assert 1 <= len(b["per_layer"]) <= 128
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 0 < len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    b = _bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in cells
            assert w in moved.get("workloads", cells), (m["name"], w)
    for w in cells:
        got = [m for m in b["end_to_end"] if w in m.get("workloads", cells)]
        assert len(got) >= 2 and any(m["name"] == "setup_s" for m in got)
        assert R.metrics_of(b, w, True)


def test_a_new_cell_needs_only_new_files():
    # a cell, a traffic mix and a metric added as data: the harness finds
    # them without an edit to any file it has
    b = _bench()
    b["workloads"].append(dict(name="zzr-frame-x", config="avatarrex_zzr",
                               traffic="frame_1", chips=1, why="x"))
    lim = os.path.join(R.HERE, "limits", "zzr-frame-x.json")
    with open(lim, "w") as f:
        json.dump({"differ_share": 0.5}, f)
    try:
        cell = R.cell("zzr-frame-x", b)
        assert cell["traffic"]["driver"] == "render"
        assert R.metrics_of(b, "zzr-frame-x", False) == [
            m for m in b["end_to_end"] if "workloads" not in m]
    finally:
        os.remove(lim)
    # a metric of a new cell's kind reads with the file of its stem
    assert callable(R.reader("idle_pct.anything"))


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "zzr-frame", "--seed", "2147483999", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("jaxfoo_not_jax", sys)
    try:
        assert "jaxfoo_not_jax" not in R.forbidden_modules()
        assert "animatablegaussians_torch" not in R.FORBIDDEN
    finally:
        sys.modules.pop("jaxfoo_not_jax", None)


@pytest.mark.parametrize("w", ["zzr-train-b1", "zzr-train-b4"])
def test_config_batch_cells_use_the_train_driver(w):
    assert R.cell(w)["traffic"]["driver"] == "train"
