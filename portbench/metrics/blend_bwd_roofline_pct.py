"""The backward blend's share of its bytes bound: the rows, pairs, tile
ranges, outputs and cotangents it must read and the gradient it must
write, at 3.35 TB/s, with each profiled frame's pair count from the
benchmark's own binning, over the device time of
``blend_backward_kernel``."""

from portbench.yardstick import work


def read(m):
    if m.trace is None or not m.pairs:
        return None
    s = m.trace.device_s(lambda n: "blend_backward_kernel" in n)
    if s <= 0:
        return None
    w, h = m.img_size
    need = sum(work.bound_s(work.blend_bytes(m.n_points, p, w, h, True))
               for p in m.pairs)
    return 100.0 * need / s
