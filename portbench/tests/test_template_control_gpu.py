"""On the card: the template cell's control, the plain reference with TF32
matrix products put in the program's place, fails at least one of the
cell's limits while the program meets them on the same seed. Run on a
machine with a CUDA device: ``python -m pytest
portbench/tests/test_template_control_gpu.py -q``."""

import pytest
import torch

from portbench import run as R

CELL = "zzr-template-train"


@pytest.mark.gpu
def test_control_fails_a_limit_the_program_meets():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = R.run(CELL, 2_147_485_019, 2.0, False, control=True)
    limits = R.cell(CELL)["limits"]
    assert res["correct"]
    assert any(res["control"][k] > limits[k] for k in limits), res["control"]
