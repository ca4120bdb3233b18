"""The Gaussian-splat render, plain: the port's `render_gaussians`
(`ops/gaussian_raster/render.py`) with its kernels replaced by their plain
PyTorch versions, as the port runs on CPU tensors — the depth-ordered pair
expansion, the tile histogram and stable ranks (a sort), the padded
chunk-aligned layout, and the compositing scan
(`composite_cuda.composite_tiles_plain`, without its checkpoint store and
cull options), differentiated by autograd.

The pair budget is the pre-cull total rounded up to a whole block, so the
plain render never truncates: the port's budget is sized above the total
(`auto_size_raster_config`), and a layout does not depend on its budget
otherwise."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import Tensor
from torch.utils.checkpoint import checkpoint

from benchmark.reference.gs_binning import expand_packed, pack_depth_ordered
from benchmark.reference.gs_composite_xla import (
    ALPHA_CLAMP,
    ALPHA_MIN,
    NUM_FIELDS,
    T_EPS,
    assemble_image,
    tile_pixel_coords,
)
from benchmark.reference.gs_preprocess import preprocess_gaussians

CHUNK = 128  # alignment quantum of each tile's pair range
BLK = 1024  # the pair budget's block


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    tile_size: int = 32
    pair_budget: int = 1 << 19
    tile_capacity: int = 2048
    chunk: int = 32
    sh_degree: int = 3
    scale_mod: float = 1.0
    rect_mode: str = "support"


def _build_fields_ext(proj) -> Tensor:
    n = proj.opacity.shape[0]
    row_id = torch.arange(1, n + 1, dtype=torch.float32,
                          device=proj.opacity.device)
    fields = torch.cat(
        [proj.mean2d, proj.conic, proj.opacity[:, None], proj.color,
         row_id[:, None]], dim=1,
    )
    return torch.nn.functional.pad(fields, (0, NUM_FIELDS - 10, 1, 0))


def _layout(proj, ntx: int, nty: int, ts: int):
    """(pg_padded, aligned starts, tile counts, pre-cull total)."""
    num_t = ntx * nty
    packed = pack_depth_ordered(proj)
    total = int(packed[:, 0].sum())
    budget = max(BLK, -(-total // BLK) * BLK)
    tile, gauss, _ = expand_packed(packed, ntx, nty, budget, ts)
    gauss = torch.where(tile < num_t, gauss, torch.zeros_like(gauss))
    counts_ext = torch.bincount(tile.to(torch.int64),
                                minlength=num_t + 1)[:num_t + 1]
    padded_size = budget + num_t * CHUNK
    counts = counts_ext[:num_t]
    aligned = ((counts + CHUNK - 1) // CHUNK) * CHUNK
    astart_ext = torch.cat([
        torch.zeros(1, dtype=torch.int64, device=tile.device),
        torch.cumsum(aligned, 0)[:-1],
        torch.full((1,), padded_size, dtype=torch.int64, device=tile.device),
    ])
    order = torch.sort(tile, stable=True).indices
    tile_s = tile[order].to(torch.int64)
    first = torch.cumsum(counts_ext, 0) - counts_ext
    rank = torch.arange(tile.shape[0], device=tile.device) - first[tile_s]
    dst = torch.empty_like(tile_s)
    dst[order] = astart_ext[tile_s] + rank
    ids = torch.zeros(padded_size + 1, dtype=torch.int32, device=tile.device)
    ids[torch.clamp(dst, max=padded_size)] = gauss + 1
    return (ids[:padded_size], astart_ext[:num_t].to(torch.int32),
            counts.to(torch.int32), total)


def _plain_steps(s0, s1, fields_ext, pg_padded, starts, counts, px, py,
                 trans, done, rgb, cnt):
    """Pair slots s0 ≤ s < s1 of every tile, in the kernels' op order."""
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
    return trans, done, rgb, cnt


def composite_tiles_plain(fields_ext, pg_padded, starts, counts, ntx, nty,
                          ts: int, chunk: int):
    """(rgb (T, 3, PIX), final_t (T, PIX), n_contrib (T, PIX)); every
    `chunk` slots a checkpoint, so autograd keeps only the carries."""
    num_t, pix, dev = starts.shape[0], ts * ts, fields_ext.device
    px, py = tile_pixel_coords(ntx, nty, ts, device=dev)
    state = (torch.ones((num_t, pix), dtype=torch.float32, device=dev),
             torch.zeros((num_t, pix), dtype=torch.bool, device=dev),
             torch.zeros((num_t, 3, pix), dtype=torch.float32, device=dev),
             torch.zeros((num_t, pix), dtype=torch.int32, device=dev))
    remat = torch.is_grad_enabled() and fields_ext.requires_grad
    max_count = int(counts.max()) if num_t else 0
    for s0 in range(0, max_count, chunk):
        args = (s0, min(s0 + chunk, max_count), fields_ext, pg_padded, starts,
                counts, px, py, *state)
        state = (checkpoint(_plain_steps, *args, use_reentrant=False)
                 if remat else _plain_steps(*args))
    trans, _, rgb, cnt = state
    return rgb, trans, cnt


def render_gaussians(means3d, scales, quats, opacities, sh, camera,
                     cfg: RasterizeConfig, bg: Optional[Tensor] = None,
                     colors_override=None,
                     row_dtype: Optional[torch.dtype] = None
                     ) -> Dict[str, Tensor]:
    """`row_dtype`: store the per-Gaussian rows the compositing reads in
    that type (the lower-precision control), computing in f32."""
    dev = means3d.device
    bg = (torch.zeros(3, dtype=torch.float32, device=dev) if bg is None
          else torch.as_tensor(bg, dtype=torch.float32, device=dev))
    ts = cfg.tile_size
    ntx, nty = -(-camera.width // ts), -(-camera.height // ts)
    proj = preprocess_gaussians(
        means3d, scales, quats, opacities, sh, camera, cfg.sh_degree, ts,
        cfg.scale_mod, colors_override, rect_mode=cfg.rect_mode)
    with torch.no_grad():
        pg_padded, astart, counts, total = _layout(proj, ntx, nty, ts)
    fields_ext = _build_fields_ext(proj)
    if row_dtype is not None:
        fields_ext = fields_ext.to(row_dtype).to(torch.float32)
    rgb_t, t_t, cnt_t = composite_tiles_plain(fields_ext, pg_padded, astart,
                                              counts, ntx, nty, ts, cfg.chunk)
    rgb, final_t = assemble_image(rgb_t, t_t, ntx, nty, ts, camera.width,
                                  camera.height)
    return {"image": rgb + final_t[..., None] * bg, "final_t": final_t,
            "num_pairs": total, "n_contrib": int(cnt_t.sum()),
            "padded_pairs": int(pg_padded.shape[0]), "tiles": ntx * nty,
            "gaussians": int(means3d.shape[0])}
