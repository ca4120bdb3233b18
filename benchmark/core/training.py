"""The readings of a training cell's first steps, taken the same way from
the program and from the plain reference: each step's loss, each leaf's
first gradient as the optimizer got it (from Adam's first moment after one
step: (1 − β1)·g), each leaf's change after the first and after the last
check step, and each leaf's number of entries."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Sequence

from benchmark.core import compare

CHECK_STEPS = 3


def readings(step: Callable[[int], float], leaves: Sequence, optimizer,
             beta1: float, first=None) -> Dict:
    """CHECK_STEPS calls of `step(k)`, which returns the step's loss;
    `first`, a context manager, wraps the first."""
    start = [x.detach().clone() for x in leaves]
    losses, grads, change1 = [], None, None
    for k in range(CHECK_STEPS):
        with (first if k == 0 and first is not None
              else contextlib.nullcontext()):
            losses.append(float(step(k)))
        if k == 0:
            grads = [float(optimizer.state[x]["exp_avg"].norm()) / (1 - beta1)
                     for x in leaves]
            change1 = [float((x.detach() - a).norm())
                       for x, a in zip(leaves, start)]
    change = [float((x.detach() - a).norm()) for x, a in zip(leaves, start)]
    return {"loss": losses, "grad": grads, "change1": change1,
            "change": change, "numel": [x.numel() for x in leaves]}


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers a cell may compare, program against reference: the
    worst step's loss; the first gradient and the change after the check
    steps by the worst leaf (`grad_gap`, `change_gap`); and two steadier
    forms for a cell whose worst leaf swings by its nature — the first
    gradient by the worst leaf of more than one entry
    (`grad_nonscalar_gap`: a one-entry bias's gradient is one sum over
    every point, which cancels nearly to nothing and swings with the
    order of summation) and the change after the first step by the worst
    leaf (`change1_gap`). A cell's file names the ones it compares, with
    their limits."""
    keep = compare.moved_leaves(ref["grad"])
    return {"loss_gap": compare.loss_gap(prog["loss"], ref["loss"]),
            "grad_gap": compare.norm_gap(prog["grad"], ref["grad"]),
            "grad_nonscalar_gap": compare.norm_gap(
                prog["grad"], ref["grad"], [n > 1 for n in ref["numel"]]),
            "change_gap": compare.norm_gap(prog["change"], ref["change"], keep),
            "change1_gap": compare.norm_gap(prog["change1"], ref["change1"],
                                            keep)}
