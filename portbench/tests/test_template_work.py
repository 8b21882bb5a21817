"""The template step's work count (``yardstick/template_work.py``) against
a count by hand at a small size: the MLPs' FLOPs, the nearest-face
searches' pairs and their least time."""

import copy
import json
import os

from portbench.yardstick import template_work as tw
from portbench.yardstick import work

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cfg(rays: int, samples: int, hands: bool = True) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs",
                           "avatarrex_zzr_template.json")) as f:
        cfg = copy.deepcopy(json.load(f))
    cfg["train"].update(rays=rays, n_samples=samples)
    cfg["model"]["with_hand"] = hands
    return cfg


def test_mlp_flops_by_hand():
    # SDF 39-512-256-256-256-(256+39)-256-257, texture 256-256-256-256-3,
    # each hand (27 + 1 + 60)-64-64-64-64-64-3: 2 in out FLOPs a layer
    sdf = 2 * (39 * 512 + 512 * 256 + 3 * 256 * 256 + 295 * 256
               + 256 * 257)
    tex = 2 * (3 * 256 * 256 + 256 * 3)
    hand = 2 * (88 * 64 + 4 * 64 * 64 + 64 * 3)
    assert (sdf, tex, hand) == (977_920, 394_752, 44_416)
    # forward, eikonal input gradient and a backward twice the forwards
    per_point = 3 * (2 * sdf + tex + 2 * hand)
    assert tw.step_flops(_cfg(2, 3)) == 6 * per_point == 43_909_632
    assert tw.step_flops(_cfg(2, 3, hands=False)) == 6 * 3 * (2 * sdf + tex)


def test_pairs_and_bound_by_hand():
    cfg = _cfg(2, 3)
    assert tw.searches(cfg) == [(6, 20_908), (6, 1_552), (6, 1_552)]
    assert tw.pairs(cfg) == 6 * (20_908 + 2 * 1_552)
    assert tw.searches(_cfg(2, 3, hands=False)) == [(6, 20_908)]
    full = _cfg(1024, 64)
    n = 1024 * 64
    ops = 48 * n * (20_908 + 2 * 1_552)
    # the searches are bound by their operations, not their bytes
    assert abs(tw.nearest_face_bound_s(full) - ops / work.FP32_FLOPS) \
        < 1e-12
    assert 1.1e-3 < tw.nearest_face_bound_s(full) < 1.2e-3
