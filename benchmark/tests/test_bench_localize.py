"""The `localize.langsam` cell run whole (`benchmark/entries/
langsam_localize.run`) at the tiny widths of `tiny_localize.py`: on the
CPU the plain reference agrees with the port, and with the timed path
broken underneath by each of the entry's planted faults (`FAULTS`: SAM's
global blocks windowed, one level of the deformable attention sampled,
the image-text fusion skipped, the lowest-scoring box kept, SAM's mask
cropped one cell short, half the views back-projected) `correct` comes
out false at the cell's own limits; on the card (the `cuda` marker) the
entry's `CONTROL`, the reference with TF32 on, comes out not correct."""

import time

import pytest
import torch

from benchmark.entries import langsam_localize as entry
from benchmark.tests import tiny, tiny_localize

NAME = "localize.langsam"


def run_cell(tmp_path, device="cpu", seconds=0.5):
    cfg = tiny_localize.localize_config()
    ctx = tiny.context(NAME, cfg, tiny_localize.localize_workload(),
                       seconds=seconds, tmp=tmp_path, device=device)
    ctx.started = time.time()
    with tiny_localize.published_widths(cfg):
        return entry.run(ctx)


def test_the_port_agrees_with_the_reference(tmp_path):
    res = run_cell(tmp_path)
    assert res.correct, res.checks
    assert res.attempted >= 1 and res.failed == 0
    assert res.metrics["setup_s"][0] > 0


@pytest.mark.parametrize("fault", sorted(entry.FAULTS))
def test_a_planted_fault_is_not_correct(fault, tmp_path):
    with entry.FAULTS[fault]():
        res = run_cell(tmp_path)
    assert not res.correct, res.checks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


@pytest.mark.cuda
def test_the_control_is_not_correct(card, tmp_path):
    program = run_cell(tmp_path, device=card)
    assert program.correct, program.checks
    with entry.CONTROL():
        control = run_cell(tmp_path, device=card)
    assert not control.correct, control.checks
