"""The (Gaussian, tile) pairs the program binned a frame in the stretch:
the ``pairs`` its ``splat.binning`` spans carry, over the stretch's
frames."""

from portbench.yardstick import spans


def read(m):
    a = spans.of(m)
    if a is None or not m.traced_frames:
        return None
    return a.args_sum("splat.binning", "pairs") / m.traced_frames
