# Frozen copy of youreditableavatar_tpu_torch/ops/segments.py (the plain PyTorch path only).
"""Segment/range helpers for static-budget expansion.

Counterpart of `youreditableavatar_tpu/ops/segments.py`: N producers each
emit `counts[i]` items laid out at offsets `cumsum - counts` in a flat
budgeted array; map each flat slot back to its producer.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor


def range_owner(counts: Tensor, budget: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Owner index per flat slot for ranges laid out by cumsum(counts).

    Returns (owner, local, valid), each (budget,): the producer of each slot
    (slots past the total belong to the last producer with items, as in the
    JAX version), the slot's index inside that producer's range, and
    slot < total.
    """
    n = counts.shape[0]
    dev = counts.device
    cum = torch.cumsum(counts.to(torch.int64), 0)
    offsets = cum - counts
    total = cum[-1] if n else torch.zeros((), dtype=torch.int64, device=dev)
    slots = torch.arange(budget, dtype=torch.int64, device=dev)
    valid = slots < total
    nz = torch.nonzero(counts > 0).flatten()
    last = nz[-1] if nz.numel() else torch.zeros((), dtype=torch.int64, device=dev)
    owner = torch.searchsorted(cum, slots, right=True)
    owner = torch.where(valid, owner, last)
    local = slots - offsets[owner] if n else slots
    return owner.to(torch.int32), local.to(torch.int32), valid
