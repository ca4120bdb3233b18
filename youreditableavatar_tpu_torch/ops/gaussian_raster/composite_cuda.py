"""Tile compositing, forward + analytic backward (K1f / K1b / K6).

Counterpart of `composite_tiles_pallas_fused` and `composite_tiles_pallas`
in `youreditableavatar_tpu/ops/gaussian_raster/composite_pallas.py`.

`composite_tiles_fused`: the (P_pad,) padded pair layout indexes
per-Gaussian field rows `fields_ext (N+1, 16)` (row 0 all zeros, column 9
the row id), and the gradient comes back per Gaussian, as the `fields_ext`
cotangent. `composite_tiles`: the caller has gathered the (P_pad, 16) pair
rows itself (padding rows zero), and the gradient comes back per pair, one
row per slot; the caller's gather sums it onto the Gaussians.

On the card (`csrc/composite.cu`):
  forward  — one CTA per 32×32 tile, 256 threads × 4 pixels; the tile's
             depth-ordered pair range is staged 128 pairs at a time into
             shared memory, each staged row read as
             `fields_ext[pg_padded[slot]]` (fused) or `pair_rows[slot]`
             inside the kernel; the tile stops once every pixel is done
             (`__syncthreads_or`).
  backward — a second forward-order sweep: with the saved colour C and
             final T, the suffix the CUDA reference accumulates back to
             front is S = C − prefix. Per pair, 9 pixel sums (warp shuffles,
             then shared memory across warps). K1b adds them into the
             zero-initialised (N+1, 16) table by one atomicAdd per field, in
             no fixed order: its gradients hold to a tolerance, not bits. K6
             writes them as the pair's own (16,) row: no atomics, and the
             same bits on every launch.
  All call one `__device__` function for the α / contrib / trigger
  decisions, so they agree bit for bit on which pairs count.

The plain PyTorch versions are a scan over the padded layout — one pair
slot of every tile per step, checkpointed every `chunk` steps so that its
autograd gradient keeps only the per-chunk carries. CPU tensors go to them.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor
from torch.utils.checkpoint import checkpoint

from youreditableavatar_tpu_torch import _kernels
from youreditableavatar_tpu_torch.ops.gaussian_raster.composite_xla import (
    ALPHA_CLAMP,
    ALPHA_MIN,
    NUM_FIELDS,
    T_EPS,
    tile_pixel_coords,
)

CHUNK = 128  # alignment quantum of each tile's pair range
TILE_SIZE = 32  # the kernels' tile: 1024 pixels = 256 threads × 4


def _check_tile_size(tile_size: int) -> None:
    if tile_size != TILE_SIZE:
        raise ValueError(f"compositing requires tile_size == {TILE_SIZE}")


def _plain_steps(s0, s1, fields_ext, pg_padded, starts, counts, px, py,
                 trans, done, rgb, cnt, evals=None):
    """Pair slots s0 ≤ s < s1 of every tile, in the kernels' op order;
    `evals`, when given, counts the evaluations that met a live pixel."""
    p_max = pg_padded.shape[0] - 1
    for s in range(s0, s1):
        rows = fields_ext[pg_padded[torch.clamp(starts + s, max=p_max)].long()]
        live = (~done) & (s < counts)[:, None]
        dx = px - rows[:, 0:1]
        dy = py - rows[:, 1:2]
        ca, cb, cc = rows[:, 2:3], rows[:, 3:4], rows[:, 4:5]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        raw = rows[:, 5:6] * torch.exp(power)
        alpha = torch.where(raw < ALPHA_CLAMP, raw,
                            torch.full_like(raw, ALPHA_CLAMP))
        ok = live & (power <= 0.0) & (alpha >= ALPHA_MIN)
        test_t = trans * (1.0 - alpha)
        trigger = ok & (test_t < T_EPS)
        contrib = ok & ~trigger
        w = torch.where(contrib, alpha * trans, torch.zeros_like(alpha))
        rgb = rgb + w[:, None, :] * rows[:, 6:9, None]
        trans = torch.where(contrib, test_t, trans)
        cnt = cnt + contrib.to(torch.int32)
        done = done | trigger
        if evals is not None:
            evals = evals + live.sum()
    return trans, done, rgb, cnt, evals


def composite_tiles_plain(
    fields_ext: Tensor, pg_padded: Tensor, starts: Tensor, counts: Tensor,
    num_tiles_x: int, num_tiles_y: int, tile_size: int = 32,
    chunk: int = 32, return_evals: bool = False,
):
    """Plain PyTorch compositing; autograd gives its gradient.

    Returns (rgb (T, 3, PIX), final_t (T, PIX), n_contrib (T, PIX) int32),
    plus, with `return_evals`, the number of (pair, pixel) evaluations that
    met a live pixel — the work the data needs (measurement only).
    """
    _check_tile_size(tile_size)
    num_t = starts.shape[0]
    pix = tile_size * tile_size
    dev = fields_ext.device
    px, py = tile_pixel_coords(num_tiles_x, num_tiles_y, tile_size, device=dev)
    state = (
        torch.ones((num_t, pix), dtype=torch.float32, device=dev),
        torch.zeros((num_t, pix), dtype=torch.bool, device=dev),
        torch.zeros((num_t, 3, pix), dtype=torch.float32, device=dev),
        torch.zeros((num_t, pix), dtype=torch.int32, device=dev),
    )
    if return_evals:
        state += (torch.zeros((), dtype=torch.int64, device=dev),)
    max_count = int(counts.max()) if num_t else 0
    remat = torch.is_grad_enabled() and fields_ext.requires_grad
    for s0 in range(0, max_count, chunk):
        s1 = min(s0 + chunk, max_count)
        args = (s0, s1, fields_ext, pg_padded, starts, counts, px, py, *state)
        if remat:
            out = checkpoint(_plain_steps, *args, use_reentrant=False)
        else:
            out = _plain_steps(*args)
        state = out if return_evals else out[:4]
    trans, _, rgb, cnt = state[:4]
    return (rgb, trans, cnt, int(state[4])) if return_evals else (rgb, trans, cnt)


def _forward(fields_ext, pg_padded, starts, counts, ntx):
    num_t = starts.shape[0]
    dev = fields_ext.device
    rgb = torch.empty((num_t, 3, TILE_SIZE * TILE_SIZE), dtype=torch.float32,
                      device=dev)
    final_t = torch.empty((num_t, TILE_SIZE * TILE_SIZE), dtype=torch.float32,
                          device=dev)
    cnt = torch.empty((num_t, TILE_SIZE * TILE_SIZE), dtype=torch.int32,
                      device=dev)
    _kernels.launch(
        "composite_forward", "yea_composite_forward", dev, fields_ext.data_ptr(),
        pg_padded.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        rgb.data_ptr(), final_t.data_ptr(), cnt.data_ptr(), num_t, ntx,
        fields_ext.shape[0])
    return rgb, final_t, cnt


def _backward_raw(fields_ext, pg_padded, starts, counts, rgb, final_t, drgb,
                  dt, ntx):
    """(N+1, 16) raw per-Gaussian sums: Σdpdx, Σdpdy, d conic a/b/c,
    d opacity, d colour (columns 0..8)."""
    dfields = torch.zeros_like(fields_ext)
    _kernels.launch(
        "composite_backward", "yea_composite_backward", fields_ext.device,
        fields_ext.data_ptr(), pg_padded.data_ptr(), starts.data_ptr(),
        counts.data_ptr(),
        rgb.data_ptr(), final_t.data_ptr(), drgb.data_ptr(), dt.data_ptr(),
        dfields.data_ptr(), starts.shape[0], ntx, fields_ext.shape[0])
    return dfields


class _CompositeFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fields_ext, pg_padded, starts, counts, ntx):
        rgb, final_t, cnt = _forward(fields_ext, pg_padded, starts, counts, ntx)
        ctx.save_for_backward(fields_ext, pg_padded, starts, counts, rgb,
                              final_t)
        ctx.ntx = ntx
        ctx.mark_non_differentiable(cnt)
        return rgb, final_t, cnt

    @staticmethod
    def backward(ctx, drgb, dt, _dcnt):
        fields_ext, pg_padded, starts, counts, rgb, final_t = ctx.saved_tensors
        raw = _backward_raw(fields_ext, pg_padded, starts, counts, rgb,
                            final_t, drgb.contiguous(), dt.contiguous(),
                            ctx.ntx)
        # The kernel sums the raw mean moments (Σdpdx, Σdpdy); the conic is
        # constant over a Gaussian's pairs, so dmean = conic · moments here.
        ca, cb, cc = fields_ext[:, 2], fields_ext[:, 3], fields_ext[:, 4]
        m0, m1 = raw[:, 0], raw[:, 1]
        dfields = torch.cat(
            [(ca * m0 + cb * m1)[:, None], (cb * m0 + cc * m1)[:, None],
             raw[:, 2:]], dim=1)
        return dfields, None, None, None, None


def composite_tiles_fused(
    fields_ext: Tensor, pg_padded: Tensor, starts: Tensor, counts: Tensor,
    num_tiles_x: int, num_tiles_y: int, tile_size: int = 32, chunk: int = 32,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Composite every tile; differentiable in `fields_ext`.

    Args:
      fields_ext: (N+1, 16) f32 per-Gaussian rows (mean x/y, conic a/b/c,
        opacity, r/g/b, row id); row 0 zeros.
      pg_padded: (P_pad,) int32 row id per padded pair slot, 0 on padding.
      starts / counts: (T,) int32 chunk-aligned start and true pair count
        of each tile's range.
    Returns:
      rgb (T, 3, 1024), final_t (T, 1024), n_contrib (T, 1024) int32.
    `chunk` is the plain version's checkpoint interval (pair slots).
    """
    _check_tile_size(tile_size)
    if not fields_ext.is_cuda:
        return composite_tiles_plain(fields_ext, pg_padded, starts, counts,
                                     num_tiles_x, num_tiles_y, tile_size,
                                     chunk)
    _kernels.check_cuda("fields_ext", fields_ext, torch.float32, 2)
    if fields_ext.shape[1] != NUM_FIELDS:
        raise ValueError(f"fields_ext must have {NUM_FIELDS} columns")
    for name, t in (("pg_padded", pg_padded), ("starts", starts),
                    ("counts", counts)):
        _kernels.check_cuda(name, t, torch.int32, 1)
    if starts.shape[0] != num_tiles_x * num_tiles_y:
        raise ValueError("starts must hold one entry per tile")
    return _CompositeFused.apply(fields_ext, pg_padded, starts, counts,
                                 num_tiles_x)


def composite_tiles_pairs_plain(
    pair_rows: Tensor, starts: Tensor, counts: Tensor, num_tiles_x: int,
    num_tiles_y: int, tile_size: int = 32, chunk: int = 32,
    return_evals: bool = False,
):
    """Plain PyTorch version of `composite_tiles`: the same scan over the
    gathered rows themselves; autograd gives the per-pair gradient."""
    slots = torch.arange(pair_rows.shape[0], dtype=torch.int32,
                         device=pair_rows.device)
    return composite_tiles_plain(pair_rows, slots, starts, counts, num_tiles_x,
                                 num_tiles_y, tile_size, chunk, return_evals)


def _forward_rows(pair_rows, starts, counts, ntx):
    num_t = starts.shape[0]
    dev = pair_rows.device
    pix = TILE_SIZE * TILE_SIZE
    rgb = torch.empty((num_t, 3, pix), dtype=torch.float32, device=dev)
    final_t = torch.empty((num_t, pix), dtype=torch.float32, device=dev)
    cnt = torch.empty((num_t, pix), dtype=torch.int32, device=dev)
    _kernels.launch(
        "composite_forward", "yea_composite_forward_rows", dev,
        pair_rows.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        rgb.data_ptr(), final_t.data_ptr(), cnt.data_ptr(), num_t, ntx,
        pair_rows.shape[0])
    return rgb, final_t, cnt


def backward_pairs(pair_rows, starts, counts, rgb, final_t, drgb, dt, ntx):
    """K6: the (P_pad, 16) per-pair gradient rows — columns 0-1 d mean, 2-4
    d conic, 5 d opacity, 6-8 d colour, 9-15 zero; padding slots zero."""
    drows = torch.zeros_like(pair_rows)
    _kernels.launch(
        "composite_backward_pairs", "yea_composite_backward_pairs",
        pair_rows.device, pair_rows.data_ptr(), starts.data_ptr(),
        counts.data_ptr(), rgb.data_ptr(), final_t.data_ptr(),
        drgb.data_ptr(), dt.data_ptr(), drows.data_ptr(), starts.shape[0],
        ntx, pair_rows.shape[0])
    return drows


class _CompositePairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pair_rows, starts, counts, ntx):
        rgb, final_t, cnt = _forward_rows(pair_rows, starts, counts, ntx)
        ctx.save_for_backward(pair_rows, starts, counts, rgb, final_t)
        ctx.ntx = ntx
        ctx.mark_non_differentiable(cnt)
        return rgb, final_t, cnt

    @staticmethod
    def backward(ctx, drgb, dt, _dcnt):
        pair_rows, starts, counts, rgb, final_t = ctx.saved_tensors
        drows = backward_pairs(pair_rows, starts, counts, rgb, final_t,
                               drgb.contiguous(), dt.contiguous(), ctx.ntx)
        return drows, None, None, None


def composite_tiles(
    pair_rows: Tensor, starts: Tensor, counts: Tensor, num_tiles_x: int,
    num_tiles_y: int, tile_size: int = 32, chunk: int = 32,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Composite every tile over gathered pair rows; differentiable in
    `pair_rows`.

    Args:
      pair_rows: (P_pad, 16) f32 rows (mean x/y, conic a/b/c, opacity,
        r/g/b, …) in depth order, each tile's range chunk-aligned; padding
        rows must be zero (inert: alpha 0).
      starts / counts: (T,) int32 chunk-aligned start and true pair count.
    Returns:
      rgb (T, 3, 1024), final_t (T, 1024), n_contrib (T, 1024) int32.
    The gradient is one (16,) row per slot, zero on padding slots and in
    columns 9-15. `chunk` is the plain version's checkpoint interval.
    """
    _check_tile_size(tile_size)
    if not pair_rows.is_cuda:
        return composite_tiles_pairs_plain(pair_rows, starts, counts,
                                           num_tiles_x, num_tiles_y,
                                           tile_size, chunk)
    _kernels.check_cuda("pair_rows", pair_rows, torch.float32, 2)
    if pair_rows.shape[1] != NUM_FIELDS:
        raise ValueError(f"pair_rows must have {NUM_FIELDS} columns")
    for name, t in (("starts", starts), ("counts", counts)):
        _kernels.check_cuda(name, t, torch.int32, 1)
    if starts.shape[0] != num_tiles_x * num_tiles_y:
        raise ValueError("starts must hold one entry per tile")
    return _CompositePairs.apply(pair_rows, starts, counts, num_tiles_x)
