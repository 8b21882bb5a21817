"""Host milliseconds a frame that the program spends waiting for the
device: inside its ``wait.*`` spans (binning's read of the pair count,
the image's copy to the host), within the stretch."""

from portbench.yardstick import spans


def read(m):
    a = spans.of(m)
    if a is None or not m.traced_frames:
        return None
    return 1e3 * a.host_s(lambda n: n.startswith("wait.")) / m.traced_frames
