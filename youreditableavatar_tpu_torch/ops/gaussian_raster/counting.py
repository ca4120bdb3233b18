"""Counting-sort pair layout: padded destination slots without a sort.

Counterpart of `youreditableavatar_tpu/ops/gaussian_raster/counting.py`,
whose two Pallas kernels (`_hist_kernel`, `_dst_kernel`) become the CUDA
kernels of `csrc/counting.cu`:

  tile_histogram  (K3a): per-bin counts of the (P,) tile ids, last bin =
                  sentinel. One CTA per 1024 pairs, shared-memory
                  histogram, one global atomicAdd per non-zero bin.
  counting_layout (K3b): dst[p] = aligned_start[tile[p]] + the stable rank
                  of pair p among the pairs of its tile, in pair order. A
                  per-block per-bin count matrix, a scan of each bin's
                  column over blocks, then in-block ranks from
                  `__match_any_sync` + the warps' counts taken in order.

Pairs arrive in global depth order, so stable ranks keep each tile's slot
range depth-ordered — the invariant compositing needs. The sentinel bin's
start is `padded_size`, so culled pairs land past the padded array.

The bin count is a runtime argument: unlike the TPU kernels these serve
any tile grid whose bins fit one block's shared memory.

CPU tensors go to the plain versions (`torch.bincount`, a stable sort).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from youreditableavatar_tpu_torch import _kernels

BLOCK = 1024  # pairs per CTA; the pair budget must be a multiple of it
# Bins held in one block's shared memory (227 KB of int32).
MAX_BINS = 232448 // 4


def _check_pairs(tile: Tensor) -> None:
    if tile.dim() != 1 or tile.shape[0] % BLOCK != 0:
        raise ValueError(
            f"pair budget must be a multiple of {BLOCK}, got {tuple(tile.shape)}"
        )


def tile_histogram_plain(tile: Tensor, num_tiles: int) -> Tensor:
    counts = torch.bincount(tile.to(torch.int64), minlength=num_tiles + 1)
    return counts[: num_tiles + 1].to(torch.int32)


def tile_histogram(tile: Tensor, num_tiles: int) -> Tensor:
    """(T+1,) int32 pair counts per tile (last slot = sentinel bin)."""
    _check_pairs(tile)
    if not tile.is_cuda:
        return tile_histogram_plain(tile, num_tiles)
    nbins = num_tiles + 1
    if nbins > MAX_BINS:
        raise ValueError(f"tile_histogram serves ≤ {MAX_BINS - 1} tiles")
    _kernels.check_cuda("tile", tile, torch.int32, 1)
    counts = torch.zeros(nbins, dtype=torch.int32, device=tile.device)
    _kernels.launch("tile_histogram", "yea_tile_histogram", tile.device,
                    tile.data_ptr(), counts.data_ptr(), tile.shape[0], nbins)
    return counts


def rank_destinations_plain(tile: Tensor, astart_ext: Tensor) -> Tensor:
    """Plain PyTorch version of `rank_destinations` (a stable sort)."""
    p = tile.shape[0]
    order = torch.sort(tile, stable=True).indices
    tile_s = tile[order].to(torch.int64)
    counts = torch.bincount(tile_s, minlength=astart_ext.shape[0])
    first = torch.cumsum(counts, 0) - counts  # first sorted position per bin
    rank = torch.arange(p, device=tile.device) - first[tile_s]
    dst = torch.empty(p, dtype=torch.int32, device=tile.device)
    dst[order] = (astart_ext.to(torch.int64)[tile_s] + rank).to(torch.int32)
    return dst


def rank_destinations(tile: Tensor, astart_ext: Tensor) -> Tensor:
    """(P,) int32 dst[p] = astart_ext[tile[p]] + the stable rank of pair p
    among the pairs of its bin, in pair order (kernel K3b)."""
    _check_pairs(tile)
    if not tile.is_cuda:
        return rank_destinations_plain(tile, astart_ext)
    nbins = astart_ext.shape[0]
    if nbins > MAX_BINS:
        raise ValueError(f"rank_destinations serves ≤ {MAX_BINS - 1} tiles")
    _kernels.check_cuda("tile", tile, torch.int32, 1)
    _kernels.check_cuda("astart_ext", astart_ext, torch.int32, 1)
    p = tile.shape[0]
    scratch = torch.empty((p // BLOCK) * nbins, dtype=torch.int32,
                          device=tile.device)
    dst = torch.empty(p, dtype=torch.int32, device=tile.device)
    _kernels.launch("counting_layout", "yea_counting_layout", tile.device,
                    tile.data_ptr(), astart_ext.data_ptr(), scratch.data_ptr(),
                    dst.data_ptr(), p, nbins)
    return dst


def aligned_starts_ext(counts_ext: Tensor, num_tiles: int, chunk: int,
                       padded_size: int) -> Tensor:
    """(T+1,) int32 chunk-aligned start of each tile's slot range from the
    (T+1,) histogram; the sentinel bin's start is `padded_size`."""
    counts = counts_ext[:num_tiles]
    aligned = ((counts + chunk - 1) // chunk) * chunk
    return torch.cat([
        torch.zeros(1, dtype=torch.int32, device=counts_ext.device),
        torch.cumsum(aligned, 0)[:-1].to(torch.int32),
        torch.full((1,), padded_size, dtype=torch.int32,
                   device=counts_ext.device),
    ])


def counting_layout(
    tile: Tensor, num_tiles: int, chunk: int, padded_size: int,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Padded chunk-aligned destinations straight from unsorted tile ids.

    Returns (dst, aligned_start, tile_count): dst (P,) int32 slot per pair
    (culled pairs land ≥ padded_size); aligned_start (T,) int32
    chunk-aligned start of each tile's range; tile_count (T,) int32.
    """
    counts_ext = tile_histogram(tile, num_tiles)
    astart_ext = aligned_starts_ext(counts_ext, num_tiles, chunk, padded_size)
    return (rank_destinations(tile, astart_ext), astart_ext[:num_tiles],
            counts_ext[:num_tiles])
