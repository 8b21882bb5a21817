"""Device milliseconds a step of the template's fields: the operations
launched inside ``template.field`` (the SDF MLP, the eikonal input
gradient, the texture MLP, the density) and ``template.hands`` (the hand
MLPs and the blend), their ``nearest_face`` searches left out."""

from portbench.yardstick import spans


def read(m):
    a = spans.of(m)
    if a is None or not m.traced_frames:
        return None
    s = a.device_s(lambda n: n in ("template.field", "template.hands"),
                   lambda n: n == "nearest_face")
    return 1e3 * s / m.traced_frames if s > 0 else None
