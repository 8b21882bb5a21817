"""Each metric reader against a synthetic profiler table."""

import types

import pytest

from portbench import run as R
from portbench.yardstick import work
from portbench.yardstick.trace import Trace


def _ev(name, cat, ts, dur):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=0, tid=0)


def _trace_events():
    # a 1000 us stretch between its marker kernels: three kernels and a
    # copy, 500 us busy in all; host ops other than CUDA calls are ignored
    return [_ev("at::cuda::spin_kernel(long)", "kernel", 1000.0, 1.0),
          _ev("at::cuda::spin_kernel(long)", "kernel", 1999.0, 1.0),
          _ev("aten::conv2d", "cpu_op", 1000.0, 300.0),
          _ev("cudaLaunchKernel", "cuda_runtime", 1400.0, 200.0),
          _ev("sm90_xmma_fprop_implicit_gemm_f32f32", "kernel", 1000.0,
              200.0),
          _ev("fir_kernel(float const*)", "kernel", 1150.0, 100.0),
          _ev("blend_backward_kernel", "kernel", 1700.0, 200.0),
          _ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1950.0,
              100.0),
          _ev("before", "kernel", 0.0, 10.0)]


def _trace():
    return Trace(_trace_events())


def _m(**kw):
    cfg = R.cell("zzr-train-b1")["cfg"]
    base = dict(window=dict(seconds=2.0, frames=8, calls=8,
                            latency_ms=[float(i) for i in range(1, 101)]),
                setup_s=12.5, trace=_trace(), traced_frames=2, cfg=cfg,
                traffic={}, train=True, batch=1, n_points=531_520,
                img_size=(1500, 2048), pairs=[1_000_000, 1_200_000])
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_trace_busy_idle_and_breakdown():
    t = _trace()
    assert t.window_s == pytest.approx(1e-3)
    # kernels 1000-1250 (overlapping), 1700-1900, copy 1950-2000 (clipped)
    assert t.busy_s == pytest.approx(500e-6)
    assert [g for g in t.gaps()] == [(1250.0, 1700.0), (1900.0, 1950.0)]
    idle = dict(t.idle_by_host())
    assert idle["cudaLaunchKernel"] == pytest.approx(450e-6)
    assert idle["host, outside any CUDA call"] == pytest.approx(50e-6)
    assert t.top_ops(1)[0][0].startswith("sm90_xmma")


def test_end_to_end_readers():
    m = _m()
    assert R.reader("train_frame_ms")(m) == pytest.approx(250.0)
    assert R.reader("animate_fps")(m) == pytest.approx(4.0)
    assert R.reader("frame_p95_ms")(m) == 95.0
    assert R.reader("setup_s")(m) == 12.5


def test_per_layer_readers():
    m = _m()
    assert R.reader("idle_pct.train")(m) == pytest.approx(50.0)
    assert R.reader("conv_ms.train")(m) == pytest.approx(0.1)
    assert R.reader("launches_per_frame.frame")(m) == pytest.approx(1.5)
    fir = work.fir_bound_s(m.cfg, True) * 2 / 100e-6 * 100
    assert R.reader("fir_roofline_pct.train")(m) == pytest.approx(fir)
    bwd = sum(work.bound_s(work.blend_bytes(531_520, p, 1500, 2048, True))
              for p in m.pairs) / 200e-6 * 100
    assert R.reader("blend_bwd_roofline_pct.train")(m) == pytest.approx(bwd)
    mfu = work.frame_flops(m.cfg, True) * 2 / 1e-3 / work.FP32_FLOPS * 100
    assert R.reader("mfu.train")(m) == pytest.approx(mfu)
    # no forward blend in this stretch: nothing to read
    assert R.reader("blend_fwd_roofline_pct.frame")(m) is None


def test_readers_without_a_trace_read_nothing():
    m = _m(trace=None, pairs=None)
    for name in ("idle_pct.x", "mfu.x", "conv_ms.x", "fir_roofline_pct.x",
                 "blend_bwd_roofline_pct.x", "blend_fwd_roofline_pct.x",
                 "launches_per_frame.x"):
        assert R.reader(name)(m) is None


def test_device_trace_is_bounded_by_its_marker_kernels():
    # a trace of the device alone: the stretch runs from the first marker
    # kernel's start to the last one's end; runtime calls name the gaps
    ev = [_ev("at::cuda::spin_kernel(long)", "kernel", 100.0, 1.0),
          _ev("cudaLaunchKernel", "cuda_runtime", 120.0, 50.0),
          _ev("fir_kernel", "kernel", 180.0, 100.0),
          _ev("at::cuda::spin_kernel(long)", "kernel", 399.0, 1.0),
          _ev("fir_kernel", "kernel", 500.0, 100.0)]
    t = Trace(ev)
    assert t.window_s == pytest.approx(300e-6)
    assert t.busy_s == pytest.approx(102e-6)
    assert t.launches() == 1   # the marker kernels are not the program's
    idle = dict(t.idle_by_host())
    assert idle["cudaLaunchKernel"] == pytest.approx(79e-6)
    assert idle["host, outside any CUDA call"] == pytest.approx(119e-6)


def test_a_trace_that_lost_a_marker_is_bounded_by_its_device_work():
    t = Trace([_ev("fir_kernel", "kernel", 0.0, 10.0),
               _ev("cudaLaunchKernel", "cuda_runtime", 5.0, 10.0),
               _ev("at::cuda::spin_kernel(long)", "kernel", 20.0, 1.0)])
    assert not t.marked
    assert t.window_s == pytest.approx(21e-6)
    assert t.busy_s == pytest.approx(11e-6)
    assert Trace(_trace_events()).marked
    with pytest.raises(ValueError):
        Trace([_ev("cudaLaunchKernel", "cuda_runtime", 5.0, 10.0)])
