"""Each cell driven end to end on the CPU at a tiny size, with the look
for a card skipped: a sound run comes out correct, and the run comes out
not correct with each fault the cell can have planted in its timed path
(a step that leaves its state unchanged, half of a batch left out, an
answer altered where it is produced, the position head's output dropped,
the background ignored)."""

import pytest

from portbench import run as R

# at a 64^2 map the heads' outputs are about 15x smaller than at 1024^2
# (fewer ToRGBs summed), so the unit scale stands in for the full size's
TINY = {"model": {"map_h": 64, "channel_max": 32},
        "init": {"head_rgb_scale": 1.0},
        "camera": {"img_w": 96, "img_h": 128, "train_focal": 115.2},
        "train": {"patch_size": 64}, "test": {"img_size": 96, "focal": 100.0},
        "traffic": {"check_frames": 4}}
SEED = 2_147_483_901


def _run(cell, fault=None):
    return R.run(cell, SEED, 0.5, False, device="cpu", overrides=TINY,
                 fault=fault)


@pytest.mark.parametrize("cell", ["zzr-train-b1", "zzr-train-b4",
                                  "lbn1-animate-f8", "zzr-frame"])
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    for k, v in res["checks"].items():
        assert v["value"] <= v["limit"], k


@pytest.mark.parametrize("cell, fault", [
    ("zzr-train-b1", "no_update"), ("zzr-train-b4", "no_update"),
    ("zzr-train-b4", "half_batch"), ("zzr-train-b1", "lpips_off"),
    ("zzr-train-b1", "position_off"),
    ("lbn1-animate-f8", "altered"), ("lbn1-animate-f8", "wrong_pose"),
    ("zzr-frame", "altered"), ("zzr-frame", "wrong_pose"),
    ("lbn1-animate-f8", "position_off"), ("zzr-frame", "position_off"),
    ("lbn1-animate-f8", "wrong_bg"), ("zzr-frame", "wrong_bg")])
def test_planted_fault_is_not_correct(cell, fault):
    res = _run(cell, fault)
    assert not res["correct"], res["checks"]
