"""Device-idle milliseconds a frame whose gap's middle falls inside
``heads`` or a span below it, the innermost span then open: the host's
dispatch of the heads' launches where the card outruns it."""

from portbench.yardstick import spans


def read(m):
    a = spans.of(m)
    if a is None or not m.traced_frames:
        return None
    return 1e3 * a.idle_s(lambda n: n == "heads") / m.traced_frames
