"""Each cell's whole run at the port's tiny TEST widths on the CPU: the
plain reference agrees with the port, and with the timed path broken
underneath by each of the entry's planted faults (`FAULTS`: a step that
leaves its state unchanged, half of a batch left out with the mean taken
over the rest, an answer altered where it is produced) `correct` comes
out false at the cell's own limits. (The cells run on one chip: no
exchange between chips to leave out.)"""

import time

import pytest

from benchmark.entries import sdxl_inpaint, sds_edit, tetgs_refine
from benchmark.tests import tiny

CELLS = {
    "geo_edit.sds": (sds_edit, tiny.sds_config,
                     lambda: tiny.load("workloads", "geo_edit.sds")),
    "tex_edit.inpaint": (sdxl_inpaint, tiny.inpaint_config,
                         tiny.inpaint_workload),
    "tex_edit.refine": (tetgs_refine, tiny.refine_config,
                        tiny.refine_workload),
}


def run_cell(name, tmp_path, device="cpu", seconds=0.5):
    entry, config, workload = CELLS[name]
    ctx = tiny.context(name, config(), workload(), seconds=seconds,
                       tmp=tmp_path, device=device)
    ctx.started = time.time()
    return entry.run(ctx)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_port_agrees_with_the_reference(name, tmp_path):
    res = run_cell(name, tmp_path)
    assert res.correct, res.checks
    assert res.attempted >= 1 and res.failed == 0
    assert res.metrics["setup_s"][0] > 0


@pytest.mark.parametrize("name, fault", [
    (name, fault) for name in sorted(CELLS)
    for fault in sorted(CELLS[name][0].FAULTS)])
def test_a_planted_fault_is_not_correct(name, fault, tmp_path):
    with CELLS[name][0].FAULTS[fault]():
        res = run_cell(name, tmp_path)
    assert not res.correct, res.checks
    if fault == "state_unchanged":
        changed = "change1_gap" if name == "geo_edit.sds" else "change_gap"
        assert dict((k, v) for k, v, _ in res.checks)[changed] == \
            pytest.approx(1.0)


def test_the_refine_control_is_not_correct(tmp_path):
    """The refine step's control, the compositing's rows in bfloat16,
    needs no card (the others' TF32 does: `test_bench_controls.py`)."""
    with tetgs_refine.CONTROL():
        res = run_cell("tex_edit.refine", tmp_path)
    assert not res.correct, res.checks
