"""Device milliseconds a step that the program's spans put down to its
nearest-face searches: the operations launched inside ``nearest_face``
spans (the body's search under ``template.live2cano``, each hand's under
``template.hands``)."""

from portbench.yardstick import spans


def read(m):
    a = spans.of(m)
    if a is None or not m.traced_frames:
        return None
    s = a.device_s(lambda n: n == "nearest_face")
    return 1e3 * s / m.traced_frames if s > 0 else None
