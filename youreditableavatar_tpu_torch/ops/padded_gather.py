"""Row gathers and scatters that keep padding off one row.

Budgeted layouts pad with one row: background pixels read face 0's
corners, padded faces and vertex slots read row 0, the pair layout's
padding slots read the zero row. A gather's backward is `index_add_`
(atomics on the card), and every padding slot adds onto that one address
in turn: on the card the adds to one row serialise, 3–4 ms a spatial edit
step and 0.2 ms a sharded view. Here the padding slots go to spread dump
rows, slot i to row N + i % D of an (N + D)-row buffer, and the dump rows
are dropped — after their sum, the padding slots' summed gradient, has
landed on the pad row in one add, where a caller keeps it.

The forward of `gather_rows` is `index_select`, bit for bit; the pad row
receives the same total in another summation order (float atomics fix no
order either). No host synchronisation.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import Tensor

# Dump rows of a spread: about DUMP_FLOATS floats, 256 to 4,096 rows (the
# one that measured fastest on the card for 16-float pair rows is ~1,024,
# for 2-float pixel rows ~4,096).
DUMP_FLOATS = 16384
DUMP_ROWS = 4096


def dump_rows(slots: int, row_floats: int) -> int:
    """Dump rows for spreading `slots` padding slots of `row_floats`."""
    return max(1, min(slots, DUMP_ROWS, max(256, DUMP_FLOATS // max(row_floats, 1))))


def spread_padding(idx: Tensor, pad: Tensor, num_rows: int,
                   dump: int) -> Tensor:
    """`idx` with padding slot i sent to row num_rows + i % dump."""
    slot = torch.arange(idx.shape[0], device=idx.device)
    return torch.where(pad, num_rows + slot % dump, idx)


class _PaddedGather(torch.autograd.Function):
    """`x.index_select(0, idx)`; the backward spreads the padding slots."""

    @staticmethod
    def forward(ctx, x, idx, pad, pad_row):
        ctx.save_for_backward(idx, pad)
        ctx.pad_row = pad_row
        ctx.num_rows = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        idx, pad = ctx.saved_tensors
        n = ctx.num_rows
        d = dump_rows(idx.shape[0], g.shape[1:].numel())
        buf = g.new_zeros((n + d,) + g.shape[1:]).index_add_(
            0, spread_padding(idx, pad, n, d), g)
        grad = buf[:n]
        if ctx.pad_row is not None:
            grad.index_add_(0, ctx.pad_row.reshape(1), buf[n:].sum(0, keepdim=True))
        return grad, None, None, None


def gather_rows(x: Tensor, idx: Tensor, pad: Optional[Tensor] = None,
                pad_row: Union[int, Tensor, None] = 0) -> Tensor:
    """`x[idx]` for an integer `idx` of any shape (`index_select`'s bits)
    with a backward that spreads the padding slots.

    `pad` marks the padding slots (default `idx == pad_row`). Every one of
    them must read `pad_row` (an int, or a 0-d tensor on `idx`'s device),
    which receives their summed gradient in one add. With `pad_row=None`
    their gradient is dropped: only where no caller keeps the pad row's
    gradient, or where the padding slots' gradient is zero by construction.
    """
    flat = idx.reshape(-1)
    if pad is None and pad_row is None:
        raise ValueError("gather_rows needs `pad` or `pad_row`")
    if pad is None:
        pad = flat == pad_row
    if isinstance(pad_row, int):  # a fill on the device, not a copy
        pad_row = torch.full((), pad_row, dtype=torch.int64, device=flat.device)
    out = _PaddedGather.apply(x, flat, pad.reshape(-1), pad_row)
    return out if idx.dim() == 1 else out.reshape(idx.shape + x.shape[1:])


def scatter_add_rows(num_rows: int, idx: Tensor, src: Tensor,
                     pad: Optional[Tensor]) -> Tensor:
    """(num_rows, ...) zeros with `src`'s rows added at `idx`
    (`index_add`, differentiable), the rows marked `pad` sent to spread
    dump rows and dropped."""
    if pad is None:
        return src.new_zeros((num_rows,) + src.shape[1:]).index_add(0, idx, src)
    d = dump_rows(idx.shape[0], src.shape[1:].numel())
    buf = src.new_zeros((num_rows + d,) + src.shape[1:]).index_add(
        0, spread_padding(idx, pad, num_rows, d), src)
    return buf[:num_rows]
