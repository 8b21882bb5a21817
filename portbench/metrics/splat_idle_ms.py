"""Device-idle milliseconds a frame whose gap's middle falls inside a
``splat.*`` span or one below it (binning's wait for the pair count
among them), the innermost span then open."""

from portbench.yardstick import spans


def read(m):
    a = spans.of(m)
    if a is None or not m.traced_frames:
        return None
    return 1e3 * a.idle_s(lambda n: n.startswith("splat.")) \
        / m.traced_frames
