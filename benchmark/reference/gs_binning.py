# Frozen copy of youreditableavatar_tpu_torch/ops/gaussian_raster/binning.py (the plain PyTorch path only).
"""Tile binning: fixed-budget (gaussian, tile) pair expansion + stable sort.

Counterpart of `youreditableavatar_tpu/ops/gaussian_raster/binning.py`.
The pair budget P is static; culled and over-budget slots get the sentinel
tile T, and `num_pairs` reports the true pre-cull total so callers can
detect overflow.

`expand_packed` is the plain PyTorch version of the pair-expansion kernel
(`expand_cuda.py`), and `bin_gaussians` + `pad_tile_ranges` the sort-based
layout that the counting kernels (`counting.py`) reproduce bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from benchmark.reference.gs_types import (
    GaussiansProjected,
)
from benchmark.reference.segments import range_owner

# Pair-expansion table columns (shared with the expansion kernel):
# 0 = tiles_touched, 1-2 = rect_min x/y, 3 = rect width, 4 = original
# gaussian index, 5-6 = mean2d, 7-9 = conic, 10 = 2·ln(255·op), 11-15 = 0.
PACK_COLS = 16
_INT32_MAX = 0x7FFFFFFF


def pack_depth_ordered(proj: GaussiansProjected) -> Tensor:
    """(N, 16) f32 pair-expansion table, depth-ordered, zero-pair rows last.

    Depth order is a stable single-key sort on an order-preserving int32
    view of the f32 depth (negative floats: flip all bits but the sign);
    Gaussians that touch no tile get the supremum key and sort to the tail.
    """
    n = proj.depth.shape[0]
    dev = proj.depth.device
    bits = proj.depth.detach().contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ _INT32_MAX, bits)
    key = torch.where(proj.tiles_touched > 0, key,
                      torch.full_like(key, _INT32_MAX))
    order = torch.sort(key, stable=True).indices
    two_l = 2.0 * torch.log(torch.clamp(255.0 * proj.opacity, min=1e-6))
    cols = [
        proj.tiles_touched.to(torch.float32),
        proj.rect_min[:, 0].to(torch.float32),
        proj.rect_min[:, 1].to(torch.float32),
        torch.clamp(proj.rect_max[:, 0] - proj.rect_min[:, 0], min=1).to(torch.float32),
        torch.arange(n, dtype=torch.float32, device=dev),
        proj.mean2d[:, 0],
        proj.mean2d[:, 1],
        proj.conic[:, 0],
        proj.conic[:, 1],
        proj.conic[:, 2],
        two_l,
    ]
    packed = torch.stack(cols, dim=1)[order]
    return torch.nn.functional.pad(packed, (0, PACK_COLS - packed.shape[1]))


def tile_and_keep(rows: Tensor, local_f: Tensor, num_tiles_x: int,
                  tile_size: int) -> Tuple[Tensor, Tensor]:
    """Tile id (as f32) of each pair slot and its exact ellipse–rect cull.

    `rows` are the owners' packed rows, `local_f` the slot's offset inside
    the owner's tile rectangle. A pair is kept iff some pixel centre of its
    tile has M(d) = cᵃdx² + 2cᵇdxdy + cᶜdy² ≤ 2·ln(255·op): the mean lies in
    the tile's pixel box, or one of the 4 edges (each a 1-D quadratic,
    minimised in closed form and clamped to the edge) gets there. Same f32
    expression tree as the JAX `expand_pairs`, op for op.
    """
    rect_w = rows[:, 3]
    row = torch.floor(local_f / rect_w)
    tx = rows[:, 1] + local_f - row * rect_w
    ty = rows[:, 2] + row
    tile = ty * num_tiles_x + tx

    mx, my = rows[:, 5], rows[:, 6]
    ca, cb, cc = rows[:, 7], rows[:, 8], rows[:, 9]
    two_l = rows[:, 10]
    ts_f = float(tile_size)
    x0 = tx * ts_f - mx
    x1 = x0 + (ts_f - 1.0)
    y0 = ty * ts_f - my
    y1 = y0 + (ts_f - 1.0)

    def edge_m(d_fix, lo, hi, a_fix, a_free, b):
        d_free = torch.minimum(
            torch.maximum(-b * d_fix / torch.clamp(a_free, min=1e-12), lo), hi
        )
        return a_fix * d_fix * d_fix + 2.0 * b * d_fix * d_free \
            + a_free * d_free * d_free

    m_edges = torch.minimum(
        torch.minimum(edge_m(x0, y0, y1, ca, cc, cb),
                      edge_m(x1, y0, y1, ca, cc, cb)),
        torch.minimum(edge_m(y0, x0, x1, cc, ca, cb),
                      edge_m(y1, x0, x1, cc, ca, cb)),
    )
    inside = (x0 <= 0.0) & (x1 >= 0.0) & (y0 <= 0.0) & (y1 >= 0.0)
    return tile, inside | (m_edges <= two_l)


def expand_packed(packed: Tensor, num_tiles_x: int, num_tiles_y: int,
                  pair_budget: int, tile_size: int = 32):
    """(tile, gauss, total) from the depth-ordered packed table.

    tile: (P,) int32 tile per pair slot, sentinel T where culled or past the
    total; gauss: (P,) int32 original Gaussian index of the slot's owner;
    total: () int32 pre-cull pair count.
    """
    sentinel = num_tiles_x * num_tiles_y
    counts = packed[:, 0].to(torch.int32)
    total = torch.sum(counts, dtype=torch.int32)
    owner, local, valid = range_owner(counts, pair_budget)
    rows = packed[owner.to(torch.int64)] if packed.shape[0] else torch.zeros(
        (pair_budget, PACK_COLS), dtype=packed.dtype, device=packed.device)
    gauss = rows[:, 4].to(torch.int32)
    tile_f, keep = tile_and_keep(rows, local.to(torch.float32), num_tiles_x,
                                 tile_size)
    tile = torch.where(valid & keep, tile_f.to(torch.int32),
                       torch.full_like(gauss, sentinel))
    return tile, gauss, total






