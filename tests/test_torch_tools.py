"""The port's tool modules against the JAX package on the CPU:
``tools/make_configs.py`` (the 13 subjects' YAML byte for byte, read back
by the port's ``config.load_config``), ``utils/obj_io.py`` (files byte for
byte, round trips) and ``utils/profiling.py`` (stage timers, timed calls,
a ``torch.profiler`` trace summed by ``trace_report``)."""

import collections
import glob
import gzip
import json
import os
import sys

import numpy as np
import pytest
import torch

from animatablegaussians_tpu.tools import make_configs as jmc
from animatablegaussians_tpu.utils import obj_io as jobj
from animatablegaussians_torch.config import load_config
from animatablegaussians_torch.tools import make_configs as tmc
from animatablegaussians_torch.utils import obj_io as tobj
from animatablegaussians_torch.utils import profiling as prof


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_make_configs_byte_for_byte(tmp_path, monkeypatch):
    roots = ["--data_root", "/data/MultiviewRGB", "--pose_root", "/data/Pose"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    monkeypatch.setattr(sys, "argv", ["make_configs", "--out_dir", jdir,
                                      *roots])
    jmc.main()
    tmc.main(["--out_dir", tdir, *roots])
    names = _files(jdir)
    assert len(jmc.SUBJECTS) == len(tmc.SUBJECTS) == 13
    assert names == _files(tdir) and len(names) == 2 * 13
    for n in names:
        with open(os.path.join(jdir, n), "rb") as a, \
                open(os.path.join(tdir, n), "rb") as b:
            assert a.read() == b.read(), n
    for name, s in tmc.SUBJECTS.items():
        d = os.path.join(tdir, name)
        assert load_config(os.path.join(d, "avatar.yaml")).to_dict() == \
            tmc.avatar_config(name, s, "/data/MultiviewRGB", "/data/Pose")
        assert load_config(os.path.join(d, "template.yaml")).to_dict() == \
            tmc.template_config(name, s, "/data/MultiviewRGB")


def test_obj_io_matches_jax(tmp_path):
    """OBJ and PLY files byte for byte, and both readers on them: a
    triangle mesh with normals, and a quad OBJ with slashed indices and
    uvs (fan-triangulated)."""
    rng = np.random.default_rng(0)
    verts = rng.standard_normal((6, 3)).astype(np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3], [3, 4, 5]], np.int64)
    normals = rng.standard_normal((6, 3)).astype(np.float32)
    colors = rng.random((6, 3)).astype(np.float32)
    for mod, tag in ((jobj, "j"), (tobj, "t")):
        mod.save_obj(str(tmp_path / f"{tag}.obj"), verts, faces, normals)
        mod.save_mesh_as_ply(str(tmp_path / f"{tag}.ply"), verts, faces,
                             normals=normals, colors=colors)
    for ext in ("obj", "ply"):
        assert (tmp_path / f"j.{ext}").read_bytes() == \
            (tmp_path / f"t.{ext}").read_bytes(), ext

    m = tobj.load_obj(str(tmp_path / "t.obj"))
    np.testing.assert_allclose(m["vertices"], verts, rtol=1e-6)
    np.testing.assert_allclose(m["normals"], normals, rtol=1e-6)
    np.testing.assert_array_equal(m["faces"], faces)
    assert m["uvs"] is None
    v, f = tobj.load_mesh(str(tmp_path / "t.ply"))
    np.testing.assert_array_equal(v, verts)
    np.testing.assert_array_equal(f, faces)

    quad = tmp_path / "quad.obj"
    quad.write_text("# quad\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                    "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 0 1\n"
                    "f 1/1/1 2/2/1 3/3/1 4/4/1\n")
    got, want = tobj.load_obj(str(quad)), jobj.load_obj(str(quad))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["faces"], [[0, 1, 2], [0, 2, 3]])
    for path in (str(quad), str(tmp_path / "t.ply")):
        for a, b in zip(tobj.load_mesh(path), jobj.load_mesh(path)):
            np.testing.assert_array_equal(a, b)


def test_stage_timer_and_timed_calls():
    t = prof.StageTimer()
    with t.stage("work") as out:
        out["result"] = {"x": [torch.ones(8) * 2]}
    with t.stage("work", result=torch.zeros(2)):
        pass
    assert t.counts["work"] == 2 and t.totals["work"] > 0
    assert "work: total" in t.summary() and "over 2 calls" in t.summary()
    t.reset()
    assert t.summary() == ""
    f = lambda x: torch.sort(x * 2.0).values
    x = torch.arange(2048.0).flip(0)
    assert prof.time_fn(f, x, iters=3, warmup=1) > 0
    assert prof.time_fn_synced(f, x, iters=2, warmup=1) > 0
    assert prof.host_sync((f(x), None)) == float(2 * x.sum())
    prof.sync({"a": (x, 3)})                 # CPU tensors: nothing to wait


def test_trace_report_on_a_cpu_profile(tmp_path):
    """``trace`` writes a Chrome trace of a CPU region, in which
    ``trace_report`` finds no device events; on a trace that holds device
    events it sums them by name, longest first, and leaves the host's
    events out. It refuses the JAX package's XLA-fusion arguments."""
    d = str(tmp_path / "trace")
    assert prof.trace_report(d) == "no trace files found"
    f = lambda x: torch.sort(x * 2.0).values
    x = torch.arange(4096.0).flip(0)
    with prof.trace(d) as log_dir:
        for _ in range(3):
            prof.host_sync(f(x))
    assert log_dir == d
    (path,) = glob.glob(os.path.join(d, "*.pt.trace.json"))
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    ops = collections.Counter(e["name"] for e in events
                              if e.get("cat") == "cpu_op")
    assert ops["aten::mul"] == 3 and ops["aten::sort"] >= 3
    if not torch.cuda.is_available():
        assert prof.trace_report(d).startswith("no events of")

    def ev(cat, name, dur):
        return dict(ph="X", cat=cat, name=name, dur=dur, ts=0, pid=0, tid=0)
    synthetic = [ev("kernel", "conv_fprop", 1500), ev("kernel", "relu", 250),
                 ev("kernel", "conv_fprop", 700), ev("gpu_memcpy", "HtoD",
                                                     400),
                 ev("gpu_memset", "Memset", 50), ev("cpu_op", "aten::conv2d",
                                                    9000),
                 ev("cuda_runtime", "cudaLaunchKernel", 8000),
                 dict(ev("kernel", "counter", 5000), ph="C")]
    newer = os.path.join(d, "later.pt.trace.json.gz")
    with gzip.open(newer, "wt") as fp:
        json.dump(dict(traceEvents=synthetic), fp)
    os.utime(newer, (os.path.getmtime(path) + 10,) * 2)
    rep = prof.trace_report(d).splitlines()
    rows = [(float(ln.split()[0]), int(ln.split()[2]), ln.split()[-1])
            for ln in rep]
    assert rows == [(2.2, 2, "conv_fprop"), (0.4, 1, "HtoD"),
                    (0.25, 1, "relu"), (0.05, 1, "Memset")]
    assert len(prof.trace_report(d, top=2).splitlines()) == 2
    with pytest.raises(NotImplementedError, match="XLA"):
        prof.trace_report(d, f, (x,))
