"""Train cells: device milliseconds a frame that the program's spans put
down to ``backward`` (the heads', LPIPS' and the splat's gradients; a
launch from the autograd engine's thread with no span of its own goes to
the main thread's ``backward``), leaving out ``splat.blend_bwd``."""

from portbench.yardstick import spans


def read(m):
    a = spans.of(m)
    if a is None or not m.traced_frames:
        return None
    return 1e3 * a.device_s(lambda n: n == "backward",
                            lambda n: n == "splat.blend_bwd") \
        / m.traced_frames
