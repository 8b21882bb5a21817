"""The work a template step needs, counted from the cell's shapes alone:
the MLPs' FLOPs and the nearest-face searches' (point, face) pairs, with
their least time on one H100 (``work.bound_s``).

MLP FLOPs follow ``reference/template.py``'s networks: a linear layer
costs 2 in out FLOPs a point forward; its input gradient as much; a
backward pass (input and weight gradients) twice its forward. A step
runs, on every one of its rays x samples points: the SDF MLP forward,
its input gradient for the eikonal normal (``autograd.grad`` with a
graph), the texture MLP and both hands' MLPs forward; then the backward
of all four forwards and of the input gradient's graph (a double
backward, as costly as the SDF's own backward). Weight norm, the
activations, the embedding and the compositing are left out, so the
count bounds the work from below.

A nearest-face search costs ``OPS_PER_PAIR`` FP32 operations a (point,
face) pair: what the closest point's squared distance needs in the
interior case, the faces' own products made once (the point's offset
from the first vertex, 3; its dot products with the two edges, 10; the
other four of Ericson's six from them, 4; the three sub-determinants of
the region test, 9; the two barycentric weights, 4; the squared distance
from the offset's norm, the two dot products and the weights, 17; the
compare with the best so far, 1; 48 in all; the other regions' tests
and selects not counted). Its bytes are the points read, the triangles
read and the three outputs written once. The body's search runs against
SMPL-X's faces and each hand's against the closed MANO mesh's.
"""

from __future__ import annotations

from portbench import template_inputs as ti
from portbench.yardstick import work

OPS_PER_PAIR = 48
BYTES_PER_POINT_IN = 12          # float32 xyz
BYTES_PER_POINT_OUT = 4 + 8 + 12  # distance, int64 face, barycentric
BYTES_PER_FACE = 3 * 8 + 9 * 4    # int64 indices, three float32 corners


def points(cfg: dict) -> int:
    """The live points of a step: rays x samples."""
    t = cfg["train"]
    return int(t["rays"]) * int(t["n_samples"])


def mlp_flops(dims) -> float:
    """Forward FLOPs a point of one MLP of (in, out) layers."""
    return sum(2.0 * i * o for i, o in dims)


def step_flops(cfg: dict) -> float:
    """Model FLOPs of one template step."""
    layers = ti.network_layers(cfg)
    sdf = mlp_flops(layers["geo_mlp"])
    tex = mlp_flops(layers["tex_mlp"])
    hands = (mlp_flops(layers["left_hand.tex_mlp"])
             + mlp_flops(layers["right_hand.tex_mlp"])) \
        if cfg["model"]["with_hand"] else 0.0
    forward = sdf + sdf + tex + hands       # with the eikonal input grad
    return points(cfg) * 3.0 * forward


def searches(cfg: dict) -> list:
    """(points, faces) of each nearest-face search of a step: the body's,
    then each hand's."""
    b, n = cfg["body"], points(cfg)
    out = [(n, int(b["n_faces"]))]
    if cfg["model"]["with_hand"]:
        out += [(n, int(b["mano_faces"]))] * 2
    return out


def pairs(cfg: dict) -> int:
    return sum(p * f for p, f in searches(cfg))


def nearest_face_bound_s(cfg: dict) -> float:
    """The least seconds one H100 needs for a step's searches, each the
    larger of its operations' and its bytes' time."""
    return sum(work.bound_s((BYTES_PER_POINT_IN + BYTES_PER_POINT_OUT) * p
                            + BYTES_PER_FACE * f, OPS_PER_PAIR * p * f)
               for p, f in searches(cfg))
