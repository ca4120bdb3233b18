"""Tile compositing, forward + analytic backward (K1f / K1b / K6).

Counterpart of `composite_tiles_pallas_fused` and `composite_tiles_pallas`
in `youreditableavatar_tpu/ops/gaussian_raster/composite_pallas.py`.

`composite_tiles_fused`: the (P_pad,) padded pair layout indexes
per-Gaussian field rows `fields_ext (N+1, 16)` (row 0 all zeros, column 9
the row id), and the gradient comes back per Gaussian, as the `fields_ext`
cotangent. `composite_tiles`: the caller has gathered the (P_pad, 16) pair
rows itself (padding rows zero), and the gradient comes back per pair, one
row per slot; the caller's gather sums it onto the Gaussians. Either way
each tile's range starts at a multiple of 128 (`CHUNK`), so the layout is a
sequence of 128-slot batches, each inside one tile.

On the card (`csrc/composite.cu`):
  forward  — one CTA per 32×32 tile, 256 threads × 4 pixels; the tile's
             depth-ordered pair range is staged 128 pairs at a time into
             shared memory, each staged row read as
             `fields_ext[pg_padded[slot]]` (fused) or `pair_rows[slot]`
             inside the kernel; the tile stops once every pixel is done
             (`__syncthreads_or`). When a backward will follow it also
             saves each pixel's state at the start of every batch it
             sweeps (`Checkpoints`).
  backward — one CTA per batch, resumed from its checkpoint: with the saved
             colour C and final T, the suffix the CUDA reference
             accumulates back to front is S = C − prefix. Each warp owns a
             16×8 pixel block and skips every pair whose α ≥ 1/255 box
             (`cull_box_plain`'s formula) misses it. Per pair, 9 pixel sums
             (warp shuffles, then shared memory across the warps that hit).
             K1b adds them into the zero-initialised (N+1, 16) table with
             float atomics, in no fixed order: its gradients hold to a
             tolerance, not bits. K6 writes them as the pair's own (16,)
             row: no atomics, and the same bits on every launch.
  All call one `__device__` function for the α / contrib / trigger
  decisions, so they agree bit for bit on which pairs count.

The plain PyTorch versions: the compositing is a scan over the padded
layout — one pair slot of every tile per step, checkpointed every `chunk`
steps so that its autograd gradient keeps only the per-chunk carries; CPU
tensors go to it, and its autograd is the CPU gradient. It can also return
the kernels' checkpoints and resume from them (`composite_resume_plain`).
`composite_backward_plain` repeats the batch-parallel backward's
arithmetic, vectorised over (batch, pixel), for the tests.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

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

CHUNK = 128  # alignment quantum of each tile's pair range: one batch
TILE_SIZE = 32  # the kernels' tile: 1024 pixels = 256 threads × 4
BLOCK_W, BLOCK_H = 16, 8  # one backward warp's pixel block


class Checkpoints(NamedTuple):
    """Each pixel's compositing state at the first slot of every batch a
    tile sweeps, indexed by the batch's global number (slot // CHUNK).
    Batches no tile swept are left unspecified (the kernel never writes
    them; the plain version leaves zeros)."""

    state: Tensor  # (NB, 4, PIX) f32: T, then the r, g, b colour prefix
    packed: Tensor  # (NB, PIX) int32: 2 · n_contrib + done
    swept: Tensor  # (T,) int32: batches each tile swept before it stopped


def swept_batches(ckpt: Checkpoints, starts: Tensor
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """(tile, local batch, global batch), each (Σ swept,) int64, of every
    batch a tile swept, tile by tile in order."""
    swept = ckpt.swept.long()
    tile = torch.repeat_interleave(
        torch.arange(swept.shape[0], device=swept.device), swept)
    lb = torch.arange(tile.shape[0], device=swept.device) - (
        torch.cumsum(swept, 0) - swept)[tile]
    return tile, lb, starts[tile].long() // CHUNK + lb


def _check_tile_size(tile_size: int) -> None:
    if tile_size != TILE_SIZE:
        raise ValueError(f"compositing requires tile_size == {TILE_SIZE}")


def _num_batches(p_pad: int) -> int:
    return -(-p_pad // CHUNK)


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


def _scan(fields_ext, pg_padded, starts, counts, px, py, state, max_count,
          chunk, ckpt=None):
    """Run `_plain_steps` over slots [0, max_count) in steps of `chunk`
    (remat under autograd). With `ckpt`, steps also break at every batch
    boundary, where each tile's state is recorded while it is live."""
    remat = torch.is_grad_enabled() and fields_ext.requires_grad
    s0 = 0
    while s0 < max_count:
        if ckpt is not None and s0 % CHUNK == 0:
            _record(ckpt, starts, counts, s0, state)
        s1 = min(s0 + chunk, max_count)
        if ckpt is not None:
            s1 = min(s1, (s0 // CHUNK + 1) * CHUNK)
        args = (s0, s1, fields_ext, pg_padded, starts, counts, px, py, *state)
        out = (checkpoint(_plain_steps, *args, use_reentrant=False) if remat
               else _plain_steps(*args))
        state = out if len(state) == 5 else out[:4]
        s0 = s1
    return state


def _record(ckpt, starts, counts, s0, state):
    """Checkpoint the tiles that sweep the batch at local slot s0: those
    with pairs there and a live pixel after the batch before."""
    trans, done, rgb, cnt = state[:4]
    sweeps = (s0 < counts) & ((s0 == 0) | (~done).any(dim=1))
    idx = torch.nonzero(sweeps).flatten()
    b = (starts[idx].long() + s0) // CHUNK
    ckpt.state[b] = torch.cat([trans[idx, None], rgb[idx]], dim=1).detach()
    ckpt.packed[b] = 2 * cnt[idx] + done[idx].to(torch.int32)
    ckpt.swept[idx] += 1


def composite_tiles_plain(
    fields_ext: Tensor, pg_padded: Tensor, starts: Tensor, counts: Tensor,
    num_tiles_x: int, num_tiles_y: int, tile_size: int = 32,
    chunk: int = 32, return_evals: bool = False,
    return_checkpoints: bool = False,
):
    """Plain PyTorch compositing; autograd gives its gradient.

    Returns (rgb (T, 3, PIX), final_t (T, PIX), n_contrib (T, PIX) int32),
    then, with `return_evals`, the number of (pair, pixel) evaluations that
    met a live pixel — the work the data needs (measurement only) — and,
    with `return_checkpoints`, the `Checkpoints` the kernel saves for its
    backward: the state at each batch a tile sweeps, a tile stopping after
    the first batch that leaves none of its pixels live.
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
    ckpt = None
    if return_checkpoints:
        nb = _num_batches(pg_padded.shape[0])
        ckpt = Checkpoints(
            torch.zeros((nb, 4, pix), dtype=torch.float32, device=dev),
            torch.zeros((nb, pix), dtype=torch.int32, device=dev),
            torch.zeros((num_t,), dtype=torch.int32, device=dev))
    max_count = int(counts.max()) if num_t else 0
    state = _scan(fields_ext, pg_padded, starts, counts, px, py, state,
                  max_count, chunk, ckpt)
    trans, _, rgb, cnt = state[:4]
    out = (rgb, trans, cnt)
    if return_evals:
        out += (int(state[4]),)
    if return_checkpoints:
        out += (ckpt,)
    return out


def composite_resume_plain(
    fields_ext: Tensor, pg_padded: Tensor, starts: Tensor, counts: Tensor,
    num_tiles_x: int, num_tiles_y: int, ckpt: Checkpoints, batch: Tensor,
    chunk: int = 32,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The plain compositing of every tile continued from its checkpoint at
    local batch `batch[t]` (< ckpt.swept[t]; tiles without pairs start
    fresh): (rgb, final_t, n_contrib), as from the first slot."""
    num_t = starts.shape[0]
    pix = TILE_SIZE * TILE_SIZE
    px, py = tile_pixel_coords(num_tiles_x, num_tiles_y, TILE_SIZE,
                               device=fields_ext.device)
    skip = torch.where(counts > 0, batch.long(), 0) * CHUNK
    b = ((starts.long() + skip) // CHUNK).clamp(max=ckpt.state.shape[0] - 1)
    fresh = (counts <= 0)[:, None]
    st, packed = ckpt.state[b], ckpt.packed[b]
    state = (
        torch.where(fresh, torch.ones_like(st[:, 0]), st[:, 0]),
        ~fresh & (packed & 1).bool(),
        torch.where(fresh[:, None], torch.zeros_like(st[:, 1:]), st[:, 1:]),
        torch.where(fresh, torch.zeros_like(packed), packed >> 1),
    )
    rest = counts - skip.to(counts.dtype)
    max_count = int(rest.max()) if num_t else 0
    state = _scan(fields_ext, pg_padded, starts + skip.to(starts.dtype), rest,
                  px, py, state, max_count, chunk)
    trans, _, rgb, cnt = state
    return rgb, trans, cnt


def cull_box_plain(rows: Tensor) -> Tensor:
    """(N, 4) f32 pixel boxes (x_lo, x_hi, y_lo, y_hi) of (N, ≥6) rows
    (mean x/y, conic a/b/c, opacity): outside its box no pixel passes the
    α ≥ 1/255 test of a pair. The kernel's `cull_box`, line for line, in
    float64; ±inf (no cull) where the kernel evaluates every pixel."""
    mx, my, ca, cb, cc, op = (rows[:, i] for i in range(6))
    a, b, c = ca.double(), cb.double(), cc.double()
    det = a * c - b * b
    ratio = a * c / det
    cull = (det > 0.0) & (a > 0.0) & (op > ALPHA_MIN) & (ratio < 1e5)
    t = torch.clamp(2.0 * torch.log(255.0 * op.double()), min=0.0)
    te = (t * 1.0001 + 1e-5) * (1.0 + 4e-6 * ratio)
    hx = torch.sqrt(te * c / det) + 1.0 + 1e-6 * mx.double().abs()
    hy = torch.sqrt(te * a / det) + 1.0 + 1e-6 * my.double().abs()
    box = torch.stack([mx - hx, mx + hx, my - hy, my + hy], dim=1).float()
    inf = torch.tensor([-float("inf"), float("inf")] * 2, device=rows.device)
    return torch.where(cull[:, None], box, inf)


def _warp_blocks(num_tiles_x: int, num_tiles_y: int, device):
    """(x0, x1, y0, y1), each (T, PIX) f32: the pixel block of the warp
    that owns each pixel in the backward (16 × 8, inclusive bounds)."""
    px, py = tile_pixel_coords(num_tiles_x, num_tiles_y, TILE_SIZE,
                               device=device)
    p = torch.arange(TILE_SIZE * TILE_SIZE, device=device)
    x0 = px - (p % TILE_SIZE % BLOCK_W).to(px.dtype)
    y0 = py - (p // TILE_SIZE % BLOCK_H).to(py.dtype)
    return x0, x0 + (BLOCK_W - 1), y0, y0 + (BLOCK_H - 1)


def composite_backward_plain(
    fields_ext: Tensor, pg_padded: Tensor, starts: Tensor, counts: Tensor,
    num_tiles_x: int, num_tiles_y: int, rgb: Tensor, final_t: Tensor,
    drgb: Tensor, dt: Tensor, ckpt: Checkpoints,
) -> Tensor:
    """Plain version of the batch-parallel backward (K1b / K6): every batch
    a tile swept, resumed from its checkpoint, with the per-warp box cull;
    vectorised over (batch, pixel), one slot of every batch per step.

    Returns (P_pad, 9) per-slot sums, zero where no pixel contributed: Σ
    dpower·dx, Σ dpower·dy, d conic a/b/c (scaled −½, −1, −½), d opacity,
    d colour r/g/b — what K1b adds onto the slot's Gaussian and K6 writes
    into the slot's row (columns 0-1 times the pair's conic)."""
    dev = fields_ext.device
    p_pad = pg_padded.shape[0]
    tile, lb, gb = swept_batches(ckpt, starts)
    n = torch.clamp(counts[tile].long() - lb * CHUNK, max=CHUNK)

    st = ckpt.state[gb]
    trans = st[:, 0]
    done = (ckpt.packed[gb] & 1).bool()
    g = drgb[tile]
    gt_tf = dt[tile] * final_t[tile]
    c = rgb[tile]
    cg_img = c[:, 0] * g[:, 0] + c[:, 1] * g[:, 1] + c[:, 2] * g[:, 2]
    pg_dot = st[:, 1] * g[:, 0] + st[:, 2] * g[:, 1] + st[:, 3] * g[:, 2]
    px, py = (x[tile] for x in tile_pixel_coords(num_tiles_x, num_tiles_y,
                                                 TILE_SIZE, device=dev))
    wx0, wx1, wy0, wy1 = (x[tile] for x in _warp_blocks(num_tiles_x,
                                                        num_tiles_y, dev))
    out = torch.zeros((p_pad, 9), dtype=torch.float32, device=dev)
    scale = torch.tensor([1.0, 1.0, -0.5, -1.0, -0.5, 1.0, 1.0, 1.0, 1.0],
                         device=dev)
    zero = torch.zeros_like(trans)
    for j in range(CHUNK):
        slot = torch.clamp(gb * CHUNK + j, max=p_pad - 1)
        rows = fields_ext[pg_padded[slot].long()]
        box = cull_box_plain(rows)
        miss = ((box[:, 1:2] < wx0) | (box[:, 0:1] > wx1)
                | (box[:, 3:4] < wy0) | (box[:, 2:3] > wy1))
        live = (j < n)[:, None] & ~done & ~miss
        mx, my, ca, cb, cc, op, r, gg, bb = (rows[:, i:i + 1] for i in range(9))
        dx = px - mx
        dy = py - my
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        gauss = torch.exp(power)
        raw = op * gauss
        alpha = torch.where(raw < ALPHA_CLAMP, raw,
                            torch.full_like(raw, ALPHA_CLAMP))
        ok = live & (power <= 0.0) & (alpha >= ALPHA_MIN)
        test_t = trans * (1.0 - alpha)
        trigger = ok & (test_t < T_EPS)
        contrib = ok & ~trigger
        w = alpha * trans
        dot_cg = r * g[:, 0] + gg * g[:, 1] + bb * g[:, 2]
        pg_dot = torch.where(contrib, pg_dot + w * dot_cg, pg_dot)
        dalpha = trans * dot_cg - (cg_img - pg_dot + gt_tf) / (1.0 - alpha)
        dalpha = torch.where(raw < ALPHA_CLAMP, dalpha, zero)
        dpower = dalpha * op * gauss
        dpdx = dpower * dx
        dpdy = dpower * dy
        terms = torch.stack([dpdx, dpdy, dpdx * dx, dpdx * dy, dpdy * dy,
                             dalpha * gauss, w * g[:, 0], w * g[:, 1],
                             w * g[:, 2]], dim=1)
        sums = torch.where(contrib[:, None], terms, zero[:, None]).sum(-1)
        trans = torch.where(contrib, test_t, trans)
        done = done | trigger
        valid = j < n
        out[(gb * CHUNK + j)[valid]] = sums[valid] * scale
    return out


def backward_raw_plain(fields_ext, pg_padded, slot_sums):
    """K1b's output from `composite_backward_plain`'s per-slot sums: the
    (N+1, 16) raw per-Gaussian table."""
    raw = torch.zeros_like(fields_ext)
    raw[:, :9].index_add_(0, pg_padded.long(), slot_sums)
    return raw


def backward_pairs_plain(pair_rows, slot_sums):
    """K6's output from `composite_backward_plain`'s per-slot sums: one
    (16,) row per slot, columns 0-1 the pair's conic times the moments."""
    ca, cb, cc = pair_rows[:, 2], pair_rows[:, 3], pair_rows[:, 4]
    m0, m1 = slot_sums[:, 0], slot_sums[:, 1]
    drows = torch.zeros_like(pair_rows)
    drows[:, 0] = ca * m0 + cb * m1
    drows[:, 1] = cb * m0 + cc * m1
    drows[:, 2:9] = slot_sums[:, 2:]
    return drows


def dfields_from_raw(fields_ext: Tensor, raw: Tensor) -> Tensor:
    """The `fields_ext` gradient from K1b's raw table: the kernel sums the
    raw mean moments (Σdpdx, Σdpdy); the conic is constant over a
    Gaussian's pairs, so dmean = conic · moments here."""
    ca, cb, cc = fields_ext[:, 2], fields_ext[:, 3], fields_ext[:, 4]
    m0, m1 = raw[:, 0], raw[:, 1]
    return torch.cat([(ca * m0 + cb * m1)[:, None],
                      (cb * m0 + cc * m1)[:, None], raw[:, 2:]], dim=1)


def _aligned(t: Tensor) -> Tensor:
    """`t` contiguous at a 16-byte aligned address (the kernels read float4)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(fields, pg_padded, starts, counts, ntx, save):
    """K1f over `fields_ext` rows through `pg_padded`, or over gathered
    pair rows (`pg_padded` None). Returns (rgb, final_t, n_contrib, the
    `Checkpoints` when `save`, else None)."""
    num_t = starts.shape[0]
    dev = fields.device
    pix = TILE_SIZE * TILE_SIZE
    p_pad = fields.shape[0] if pg_padded is None else pg_padded.shape[0]
    nb = _num_batches(p_pad)
    rgb = torch.empty((num_t, 3, pix), dtype=torch.float32, device=dev)
    final_t = torch.empty((num_t, pix), dtype=torch.float32, device=dev)
    cnt = torch.empty((num_t, pix), dtype=torch.int32, device=dev)
    ckpt = None
    if save:
        ckpt = Checkpoints(
            torch.empty((nb, 4, pix), dtype=torch.float32, device=dev),
            torch.empty((nb, pix), dtype=torch.int32, device=dev),
            torch.empty((num_t,), dtype=torch.int32, device=dev))
    _kernels.launch(
        "composite_forward", "yea_composite_forward", dev, fields.data_ptr(),
        0 if pg_padded is None else pg_padded.data_ptr(), starts.data_ptr(),
        counts.data_ptr(), rgb.data_ptr(), final_t.data_ptr(), cnt.data_ptr(),
        *((0, 0, 0) if ckpt is None else (x.data_ptr() for x in ckpt)),
        num_t, ntx, fields.shape[0], nb, int(pg_padded is not None),
        int(save))
    return rgb, final_t, cnt, ckpt


def _backward_raw(fields_ext, pg_padded, starts, counts, rgb, final_t, drgb,
                  dt, ntx, ckpt: Checkpoints):
    """K1b: (N+1, 16) raw per-Gaussian sums: Σdpdx, Σdpdy, d conic a/b/c,
    d opacity, d colour (columns 0..8)."""
    dfields = torch.zeros_like(fields_ext)
    drgb, dt = _aligned(drgb), _aligned(dt)
    _kernels.launch(
        "composite_backward", "yea_composite_backward", fields_ext.device,
        fields_ext.data_ptr(), pg_padded.data_ptr(), starts.data_ptr(),
        counts.data_ptr(), *(x.data_ptr() for x in ckpt),
        rgb.data_ptr(), final_t.data_ptr(), drgb.data_ptr(), dt.data_ptr(),
        dfields.data_ptr(), starts.shape[0], ckpt.state.shape[0], ntx,
        fields_ext.shape[0])
    return dfields


class _CompositeFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fields_ext, pg_padded, starts, counts, ntx, save):
        rgb, final_t, cnt, ckpt = _forward(fields_ext, pg_padded, starts,
                                           counts, ntx, save)
        if save:
            ctx.save_for_backward(fields_ext, pg_padded, starts, counts, rgb,
                                  final_t, *ckpt)
        ctx.ntx = ntx
        ctx.mark_non_differentiable(cnt)
        return rgb, final_t, cnt

    @staticmethod
    def backward(ctx, drgb, dt, _dcnt):
        fields_ext, pg_padded, starts, counts, rgb, final_t, *ckpt = (
            ctx.saved_tensors)
        raw = _backward_raw(fields_ext, pg_padded, starts, counts, rgb,
                            final_t, drgb, dt, ctx.ntx, Checkpoints(*ckpt))
        return dfields_from_raw(fields_ext, raw), None, None, None, None, None


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
    `chunk` is the plain version's checkpoint interval (pair slots). On the
    card the forward saves the backward's checkpoints only when a gradient
    can follow (grad mode on and `fields_ext` requiring it).
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
    save = torch.is_grad_enabled() and fields_ext.requires_grad
    return _CompositeFused.apply(fields_ext, pg_padded, starts, counts,
                                 num_tiles_x, save)


def composite_tiles_pairs_plain(
    pair_rows: Tensor, starts: Tensor, counts: Tensor, num_tiles_x: int,
    num_tiles_y: int, tile_size: int = 32, chunk: int = 32,
    return_evals: bool = False, return_checkpoints: bool = False,
):
    """Plain PyTorch version of `composite_tiles`: the same scan over the
    gathered rows themselves; autograd gives the per-pair gradient."""
    slots = torch.arange(pair_rows.shape[0], dtype=torch.int32,
                         device=pair_rows.device)
    return composite_tiles_plain(pair_rows, slots, starts, counts, num_tiles_x,
                                 num_tiles_y, tile_size, chunk, return_evals,
                                 return_checkpoints)


def _forward_rows(pair_rows, starts, counts, ntx, save=False):
    """K1f over gathered pair rows: (rgb, final_t, n_contrib, Checkpoints
    or None)."""
    return _forward(pair_rows, None, starts, counts, ntx, save)


def backward_pairs(pair_rows, starts, counts, rgb, final_t, drgb, dt, ntx,
                   ckpt: Checkpoints):
    """K6: the (P_pad, 16) per-pair gradient rows — columns 0-1 d mean, 2-4
    d conic, 5 d opacity, 6-8 d colour, 9-15 zero; padding slots zero —
    resumed from the forward's `ckpt`."""
    drows = torch.zeros_like(pair_rows)
    drgb, dt = _aligned(drgb), _aligned(dt)
    _kernels.launch(
        "composite_backward_pairs", "yea_composite_backward_pairs",
        pair_rows.device, pair_rows.data_ptr(), starts.data_ptr(),
        counts.data_ptr(), *(x.data_ptr() for x in ckpt), rgb.data_ptr(),
        final_t.data_ptr(), drgb.data_ptr(), dt.data_ptr(), drows.data_ptr(),
        starts.shape[0], ckpt.state.shape[0], ntx, pair_rows.shape[0])
    return drows


class _CompositePairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pair_rows, starts, counts, ntx, save):
        rgb, final_t, cnt, ckpt = _forward_rows(pair_rows, starts, counts,
                                                ntx, save)
        if save:
            ctx.save_for_backward(pair_rows, starts, counts, rgb, final_t,
                                  *ckpt)
        ctx.ntx = ntx
        ctx.mark_non_differentiable(cnt)
        return rgb, final_t, cnt

    @staticmethod
    def backward(ctx, drgb, dt, _dcnt):
        pair_rows, starts, counts, rgb, final_t, *ckpt = ctx.saved_tensors
        drows = backward_pairs(pair_rows, starts, counts, rgb, final_t, drgb,
                               dt, ctx.ntx, Checkpoints(*ckpt))
        return drows, None, None, None, None


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
    save = torch.is_grad_enabled() and pair_rows.requires_grad
    return _CompositePairs.apply(pair_rows, starts, counts, num_tiles_x, save)
