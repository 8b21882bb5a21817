"""Train cells: device milliseconds a frame that the program's spans put
down to the loss terms, ``losses`` (the pixel terms and LPIPS' forward)."""

from portbench.yardstick import spans


def read(m):
    a = spans.of(m)
    if a is None or not m.traced_frames:
        return None
    return 1e3 * a.device_s(lambda n: n == "losses") / m.traced_frames
