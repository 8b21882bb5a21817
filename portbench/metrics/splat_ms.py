"""Device milliseconds a frame that the program's spans put down to the
splat: the operations launched inside ``splat.preprocess``,
``splat.binning``, ``splat.blend`` and ``splat.blend_bwd`` (the backward
blend, launched from the autograd engine's thread)."""

from portbench.yardstick import spans


def read(m):
    a = spans.of(m)
    if a is None or not m.traced_frames:
        return None
    return 1e3 * a.device_s(lambda n: n.startswith("splat.")) \
        / m.traced_frames
