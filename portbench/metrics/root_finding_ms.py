"""Device milliseconds a step that the program's spans put down to the
Newton root finding of the inverse skinning: the operations launched
inside ``root_finding``."""

from portbench.yardstick import spans


def read(m):
    a = spans.of(m)
    if a is None or not m.traced_frames:
        return None
    s = a.device_s(lambda n: n == "root_finding")
    return 1e3 * s / m.traced_frames if s > 0 else None
