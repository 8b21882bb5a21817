"""The device's idle share of the profiled stretch: 1 - the union of
its kernel, copy and memset intervals over the stretch's length."""


def read(m):
    if m.trace is None or m.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - m.trace.busy_s / m.trace.window_s)
