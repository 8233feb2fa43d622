"""On the card, at the cells' own sizes: the float8 control put in the
program's place comes out not correct. Skips without a card."""

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["pretrain_4f_b64"])
def test_control_fails_at_the_cells_size(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from perfbench import calibrate, compare, harness

    c = harness.Cell(ROOT, cell)
    got = calibrate.readings(c, 2 ** 31 + 3, "cuda", "control")
    numbers = {k: got[k] for k in c.spec["limits"]}
    assert not compare.judge(numbers, c.spec["limits"])
