"""Each cell's control on the card (the `cuda` marker), at the TEST widths:
a whole run of the entry with its `CONTROL` — the plain reference in the
nearest precision below the configuration's — in the program's place
comes out not correct at the cell's own limits, while the program's run
comes out correct. `benchmark/calibrate.py` reads the same at each cell's
own size."""

import pytest
import torch

from benchmark.tests.test_bench_reference import CELLS, run_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_control_is_not_correct(card, name, tmp_path):
    program = run_cell(name, tmp_path, device=card)
    assert program.correct, program.checks
    with CELLS[name][0].CONTROL():
        control = run_cell(name, tmp_path, device=card)
    assert not control.correct, control.checks
