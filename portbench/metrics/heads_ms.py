"""Device milliseconds a frame that the program's spans put down to the
CNN heads: the operations launched inside ``heads`` (the three heads and
the view encoder, ``models/avatar.py``) or a span below it."""

from portbench.yardstick import spans


def read(m):
    a = spans.of(m)
    if a is None or not m.traced_frames:
        return None
    return 1e3 * a.device_s(lambda n: n == "heads") / m.traced_frames
