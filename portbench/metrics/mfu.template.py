"""Template cells: the MLPs' FLOPs of the profiled steps
(``yardstick.template_work.step_flops``: the SDF, texture and hand MLPs
forward, the eikonal input gradient, and the backward of both graphs)
over the stretch's seconds, as a share of the H100's 67 TFLOP/s FP32
peak."""

from portbench.yardstick import template_work, work


def read(m):
    if m.trace is None or not m.traced_frames or m.trace.window_s <= 0:
        return None
    flops = template_work.step_flops(m.cfg) * m.traced_frames
    return 100.0 * flops / m.trace.window_s / work.FP32_FLOPS
