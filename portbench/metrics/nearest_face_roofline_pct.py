"""The nearest-face searches' share of their roofline: the least time of
a step's searches (``yardstick.template_work.nearest_face_bound_s``, from
the cell's shapes alone: points x faces for the body and both hands at a
fixed FP32 operation count a pair, or their bytes read and written once,
whichever takes longer), times the profiled steps, over the device time
that the program's ``nearest_face`` spans hold. It reads the same work
whatever implements the search."""

from portbench.yardstick import spans, template_work


def read(m):
    a = spans.of(m)
    if a is None or not m.traced_frames:
        return None
    s = a.device_s(lambda n: n == "nearest_face")
    if s <= 0:
        return None
    need = template_work.nearest_face_bound_s(m.cfg) * m.traced_frames
    return 100.0 * need / s
