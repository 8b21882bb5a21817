"""Model FLOPs of the profiled frames (``yardstick.work.frame_flops``:
the heads' and the view encoder's convolutions and linear layers, and in
training their backward and LPIPS) over the stretch's seconds, as a share
of the H100's 67 TFLOP/s FP32 peak."""

from portbench.yardstick import work


def read(m):
    if m.trace is None or not m.traced_frames:
        return None
    flops = work.frame_flops(m.cfg, m.train, m.batch) * m.traced_frames
    return 100.0 * flops / m.trace.window_s / work.FP32_FLOPS
