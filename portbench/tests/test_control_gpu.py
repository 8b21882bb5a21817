"""On the card: the control, the plain reference in TF32 put in the
program's place, fails at least one of each cell's limits, while the
program passes them on the same seed. Run on a machine with a CUDA
device: ``python -m pytest portbench/tests/test_control_gpu.py -q``."""

import pytest
import torch

from portbench import run as R

CELLS = ["zzr-train-b1", "lbn1-animate-f8", "zzr-frame", "zzr-train-b4"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit_the_program_meets(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = R.run(cell, 2_147_485_001, 2.0, False, control=True)
    limits = R.cell(cell)["limits"]
    assert res["correct"]
    assert any(res["control"][k] > limits[k] for k in limits), res["control"]
