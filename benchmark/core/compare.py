"""The comparisons that decide `correct`.

Training (the readings of a step's first three calls):
  * `loss_gap` — the largest relative gap of a step's loss;
  * `norm_gap` — by the worst leaf, the gap between
    the program's norm and the reference's (not the norm of their
    difference), over the reference's norm of that leaf or of the median
    leaf, whichever is larger, since some gradients are all but zero.
A leaf whose first gradient in the reference is under NOUGHT_SHARE of the
median leaf's moves under Adam by round-off alone: the change of the
parameters leaves it out.

Images: `image_gap` — the largest absolute gap over the reference's
largest entry."""

from __future__ import annotations

import statistics
from typing import List, Sequence

NOUGHT_SHARE = 1e-3


def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(program, reference))


def norm_gap(program: Sequence[float], reference: Sequence[float],
             keep: Sequence[bool] = ()) -> float:
    """The worst of the kept leaves' gaps of norms, each over the larger
    of the leaf's own norm and the median kept leaf's."""
    keep = list(keep) or [True] * len(reference)
    kept = [r for r, k in zip(reference, keep) if k]
    floor = statistics.median(kept)
    return max([abs(p - r) / max(r, floor, 1e-30)
                   for p, r, k in zip(program, reference, keep) if k])


def moved_leaves(first_grads: Sequence[float]) -> List[bool]:
    """The leaves whose first gradient in the reference is not nought to
    rounding."""
    med = statistics.median(first_grads)
    return [g >= NOUGHT_SHARE * med for g in first_grads]


def image_gap(program, reference) -> float:
    ref = reference.double()
    return float((program.double() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30))
