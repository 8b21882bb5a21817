"""The forward blend's share of its bytes bound: the rows, pairs and tile
ranges it must read and the colour, depth and transmittance it must
write, at 3.35 TB/s, with each profiled frame's pair count from the
benchmark's own binning, over the device time of ``blend_forward_kernel``
and ``tile_order_kernel``."""

from portbench.yardstick import work


def read(m):
    if m.trace is None or not m.pairs:
        return None
    s = m.trace.device_s(lambda n: "blend_forward_kernel" in n
                         or "tile_order_kernel" in n)
    if s <= 0:
        return None
    w, h = m.img_size
    need = sum(work.bound_s(work.blend_bytes(m.n_points, p, w, h))
               for p in m.pairs)
    return 100.0 * need / s
