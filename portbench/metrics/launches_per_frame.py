"""Device kernel launches a frame in the profiled stretch (copies and
memsets are not counted)."""


def read(m):
    if m.trace is None or not m.traced_frames:
        return None
    return m.trace.launches() / m.traced_frames
