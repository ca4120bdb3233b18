"""Plain row gather and scatter-add (the port's `ops/padded_gather.py`
with its padding-spreading backward replaced by autograd's own).

`gather_rows(x, idx)` is `x[idx]`: the padding slots' gradient lands on the
row they read, which the port adds there too (`pad_row`) or drops where it
is zero by construction. `scatter_add_rows` drops the rows marked `pad`."""

from __future__ import annotations

from typing import Optional

from torch import Tensor


def gather_rows(x: Tensor, idx: Tensor, pad: Optional[Tensor] = None,
                pad_row=0) -> Tensor:
    del pad, pad_row
    return x[idx.long()]


def scatter_add_rows(num_rows: int, idx: Tensor, src: Tensor,
                     pad: Optional[Tensor]) -> Tensor:
    out = src.new_zeros((num_rows,) + src.shape[1:])
    if pad is None:
        return out.index_add(0, idx, src)
    keep = ~pad
    return out.index_add(0, idx[keep], src[keep])
