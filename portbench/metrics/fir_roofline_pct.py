"""The FIR kernel's share of its roofline: the least time the FIR calls
of the profiled frames need (``yardstick.work.fir_bound_s``: each input
byte read once, each output byte written once, at 3.35 TB/s, or the
operations at 67 TFLOP/s) over the device time of ``fir_kernel``."""

from portbench.yardstick import work


def read(m):
    if m.trace is None or not m.traced_frames:
        return None
    s = m.trace.device_s(lambda n: "fir_kernel" in n)
    if s <= 0:
        return None
    return 100.0 * work.fir_bound_s(m.cfg, m.train) * m.traced_frames / s
