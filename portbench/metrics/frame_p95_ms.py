"""One-frame calls: the 95th percentile (nearest rank) of every frame's
milliseconds from the call to its uint8 RGB image on the host."""

import math


def read(m):
    lat = sorted(m.window["latency_ms"])
    if not lat:
        return None
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
