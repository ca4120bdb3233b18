"""Hash-grid table gradient: scatter-add of per-corner rows (K4).

Counterpart of `youreditableavatar_tpu/ops/hashgrid_pallas.py`, whose Pallas
kernel (`_scatter_kernel`) becomes `csrc/hash_scatter.cu`: the (v0, v1)
rows add into the zeroed (L, T, 2) f32 table, padding rows (index
`table_size`) dropped: one thread a row, one float2 atomicAdd on global
memory; a warp whose rows repeat (neighbouring points on one corner) first
sums its rows per address.

CPU tensors go to `hash_scatter_add_plain` (`index_add_` into the
flattened table, padding rows dropped). Float atomics add in a run-to-run
order, so the kernel matches the plain version to rounding, not bit for
bit.
"""

from __future__ import annotations

import torch
from torch import Tensor

from youreditableavatar_tpu_torch import _kernels

F = 2  # features per level: the only width the kernel serves


def _check_table(idx: Tensor, v0: Tensor, v1: Tensor, table_size: int) -> None:
    if idx.dim() != 2 or v0.shape != idx.shape or v1.shape != idx.shape:
        raise ValueError(
            f"idx, v0 and v1 must share one (L, R) shape, got "
            f"{tuple(idx.shape)}, {tuple(v0.shape)}, {tuple(v1.shape)}")
    # Kept from the TPU contract (its packed layout); the CUDA kernel does
    # not need it.
    if table_size % 64 != 0:
        raise ValueError(f"table_size must be a multiple of 64, got {table_size}")


def hash_scatter_add_plain(idx: Tensor, v0: Tensor, v1: Tensor,
                           table_size: int) -> Tensor:
    """Plain PyTorch version: `index_add_` into the flattened (L·T, 2)
    table; rows with idx == table_size are dropped."""
    _check_table(idx, v0, v1, table_size)
    levels = idx.shape[0]
    keep = (idx >= 0) & (idx < table_size)
    level = torch.arange(levels, device=idx.device)[:, None].expand_as(idx)
    flat = (level * table_size + idx.to(torch.int64))[keep]
    vals = torch.stack([v0[keep], v1[keep]], dim=-1).to(torch.float32)
    out = torch.zeros((levels * table_size, F), dtype=torch.float32,
                      device=idx.device)
    out.index_add_(0, flat, vals)
    return out.reshape(levels, table_size, F)


def hash_scatter_add(idx: Tensor, v0: Tensor, v1: Tensor,
                     table_size: int) -> Tensor:
    """Accumulate rows into per-level tables: out[l, idx[l,r], :] += v[l,r].

    Args:
      idx: (L, R) int32 table-row ids in [0, table_size]; rows equal to
        `table_size` are dumped (padding sentinel).
      v0, v1: (L, R) f32 feature-0 / feature-1 update values.
      table_size: rows per level table (multiple of 64).
    Returns: (L, table_size, 2) f32.
    """
    if not idx.is_cuda:
        return hash_scatter_add_plain(idx, v0, v1, table_size)
    _check_table(idx, v0, v1, table_size)
    _kernels.check_cuda("idx", idx, torch.int32, 2)
    _kernels.check_cuda("v0", v0, torch.float32, 2)
    _kernels.check_cuda("v1", v1, torch.float32, 2)
    if not (v0.device == idx.device == v1.device):
        raise ValueError("idx, v0 and v1 must lie on one device")
    out = torch.zeros((idx.shape[0], table_size, F), dtype=torch.float32,
                      device=idx.device)
    _scatter_into(idx, v0, v1, table_size, out)
    return out


def _scatter_into(idx: Tensor, v0: Tensor, v1: Tensor, table_size: int,
                  out: Tensor) -> None:
    """Launch K4: add into the zeroed (L, table_size, 2) CUDA table `out`."""
    levels, rows = idx.shape
    _kernels.launch("hash_scatter", "yea_hash_scatter", idx.device,
                    idx.data_ptr(), v0.data_ptr(), v1.data_ptr(), levels,
                    rows, table_size, out.data_ptr())
