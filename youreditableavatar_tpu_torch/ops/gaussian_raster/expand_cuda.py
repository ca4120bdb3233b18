"""Pair expansion: depth-ordered (tile, gaussian) pairs + exact cull (K2).

Counterpart of `youreditableavatar_tpu/ops/gaussian_raster/expand_pallas.py`
(`expand_pairs_pallas` → `_expand_kernel`). On the card, `csrc/expand.cu`
runs one CTA per 1024 pair slots, one thread a slot. Zero-pair rows sort
last, so the owners of a block's slots form one window of at most 1024
rows: two warps find its ends in the int32 inclusive cumsum of
`tiles_touched` (32 probes a round), the block stages the window's cumsum
and the owners' fields in shared memory, and each slot finds its owner
there. The tile and the exact ellipse–rect + α ≥ 1/255 cull follow the f32
expression tree of `binning.tile_and_keep` op for op (no FMA contraction),
so the kernel agrees with the plain version bit for bit. Blocks past the
pre-cull total only write the sentinel. The TPU design's one-hot MXU
selects and bf16 splits exist only to get exact f32 through bf16 matmuls
and have no counterpart here.

CPU tensors go to the plain version (`binning.expand_packed`).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from youreditableavatar_tpu_torch import _kernels
from youreditableavatar_tpu_torch.ops.gaussian_raster.binning import (
    PACK_COLS,
    expand_packed,
)

BLK = 1024  # the pair budget must be a multiple of it (as the TPU kernel)


def expand_pairs_plain(packed: Tensor, pair_budget: int, ntx: int, nty: int,
                       tile_size: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version; Gaussian id 0 on culled slots, as the kernel."""
    tile, gauss, total = expand_packed(packed, ntx, nty, pair_budget, tile_size)
    gauss = torch.where(tile < ntx * nty, gauss, torch.zeros_like(gauss))
    return tile, gauss, total


def expand_pairs_kernel(packed: Tensor, pair_budget: int, ntx: int, nty: int,
                        tile_size: int) -> Tuple[Tensor, Tensor, Tensor]:
    """(tile (P,), gauss (P,), total ()) int32 from the packed table.

    `packed` is `binning.pack_depth_ordered`'s (N, 16) f32 table: depth
    order, rows with tiles_touched == 0 last.
    """
    if pair_budget % BLK != 0:
        raise ValueError(f"pair budget must be a multiple of {BLK}")
    if not packed.is_cuda:
        return expand_pairs_plain(packed, pair_budget, ntx, nty, tile_size)
    _kernels.check_cuda("packed", packed, torch.float32, 2)
    if packed.shape[1] != PACK_COLS:
        raise ValueError(f"packed must have {PACK_COLS} columns")
    if packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned (rows load as float4)")
    n = packed.shape[0]
    cum = torch.cumsum(packed[:, 0].to(torch.int32), 0, dtype=torch.int32)
    total = cum[-1] if n else torch.zeros((), dtype=torch.int32,
                                          device=packed.device)
    tile = torch.empty(pair_budget, dtype=torch.int32, device=packed.device)
    gauss = torch.empty_like(tile)
    _kernels.launch("expand_pairs", "yea_expand_pairs", packed.device,
                    packed.data_ptr(), cum.data_ptr(), n, tile.data_ptr(),
                    gauss.data_ptr(), pair_budget, ntx, nty, tile_size)
    return tile, gauss, total
