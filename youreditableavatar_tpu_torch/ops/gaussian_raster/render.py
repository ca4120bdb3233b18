"""Public differentiable rendering entry point.

Counterpart of `youreditableavatar_tpu/ops/gaussian_raster/render.py`: takes
Gaussian parameters + camera, returns the composited image, per-Gaussian
screen radii and the alpha/transmittance maps, under the same output keys.

The path is always the sort-free counting layout: preprocess → depth pack →
pair expansion (K2) → tile histogram + stable ranks (K3a/K3b) → compositing
(K1f, with the analytic K1b as its gradient). The tensors' device picks the
implementation: CUDA tensors run the Hopper kernels, CPU tensors their
plain PyTorch versions. The JAX `"xla"` backend and its `tile_capacity`
truncation are not carried over; `num_tile_overflow` still reports the
tiles over `tile_capacity`, so the diagnostic means the same everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import Tensor

from youreditableavatar_tpu_torch.ops.gaussian_raster.binning import (
    pack_depth_ordered,
    pad_tile_ranges,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster.composite_cuda import (
    CHUNK,
    composite_tiles_fused,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster.composite_xla import (
    NUM_FIELDS,
    assemble_image,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster.counting import (
    counting_layout,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster.expand_cuda import (
    expand_pairs_kernel,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster.preprocess import (
    preprocess_gaussians,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster.types import RasterCamera
from youreditableavatar_tpu_torch.ops.padded_gather import gather_rows


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Static rasterizer configuration (the JAX fields minus the backend)."""

    tile_size: int = 32  # pixel tile edge (the kernels need 32)
    pair_budget: int = 1 << 19  # max (gaussian, tile) pairs; 1024-multiple
    tile_capacity: int = 2048  # per-tile depth reported by num_tile_overflow
    chunk: int = 32  # pair slots per checkpointed step of the plain scan
    sh_degree: int = 3
    scale_mod: float = 1.0
    rect_mode: str = "support"  # or "3sigma" (the CUDA reference's getRect)


def _build_fields_ext(proj) -> Tensor:
    """(N+1, 16) per-Gaussian field rows: row 0 zeros, column 9 the row id
    (1..N, exact in f32 below 2^24) that routes each pair's gradient."""
    n = proj.opacity.shape[0]
    row_id = torch.arange(1, n + 1, dtype=torch.float32,
                          device=proj.opacity.device)
    fields = torch.cat(
        [proj.mean2d, proj.conic, proj.opacity[:, None], proj.color,
         row_id[:, None]], dim=1,
    )
    return torch.nn.functional.pad(fields, (0, NUM_FIELDS - 10, 1, 0))


def build_pair_layout_counting(proj, ntx: int, nty: int, pair_budget: int,
                               tile_size: int):
    """Sort-free pair layout (port of `build_pallas_pair_layout_counting`).

    Returns (fields_ext, pg_padded, astart, tile_count, num_pairs):
    pg_padded (P_pad,) int32 holds gaussian+1 per chunk-aligned slot (0 on
    padding), P_pad = budget + T·CHUNK.
    """
    padded_size = pair_budget + ntx * nty * CHUNK
    with torch.no_grad():
        packed = pack_depth_ordered(proj)
        tile, gauss, total = expand_pairs_kernel(packed, pair_budget, ntx, nty,
                                                 tile_size)
        dst, astart, tile_count = counting_layout(tile, ntx * nty, CHUNK,
                                                  padded_size)
        pg_padded = _slot_ids(dst, gauss, padded_size)
    return _build_fields_ext(proj), pg_padded, astart, tile_count, total


def _slot_ids(dst: Tensor, gauss: Tensor, padded_size: int) -> Tensor:
    """(padded_size,) int32 gaussian+1 at each pair's slot, 0 elsewhere;
    destinations ≥ padded_size (culled or past the total) are dropped."""
    # One slot past the end collects them (JAX's mode="drop").
    ids = torch.zeros(padded_size + 1, dtype=torch.int32, device=dst.device)
    ids[torch.clamp(dst, max=padded_size).long()] = gauss + 1
    return ids[:padded_size]


def build_pallas_pair_layout(proj, binning, ntx: int, nty: int,
                             pair_budget: int):
    """(fields_ext (N+1, 16), pg_padded (P_pad,), aligned_starts (T,)) from
    a sort-path `TileBinning`: the layout `build_pair_layout_counting`
    reproduces bit for bit without the sort."""
    padded_size = pair_budget + ntx * nty * CHUNK
    with torch.no_grad():
        dst, astart, _total = pad_tile_ranges(binning, CHUNK, padded_size)
        pg_padded = _slot_ids(dst, binning.pair_gauss, padded_size)
    return _build_fields_ext(proj), pg_padded, astart


def gather_pair_rows(fields_ext: Tensor, pg_padded: Tensor) -> Tensor:
    """(P_pad, 16) pair rows `fields_ext[pg_padded]`, padding slots row 0.

    `index_select`'s bits through `gather_rows`: every padding slot reads
    row 0, the zero row whose gradient no caller keeps, so the backward
    spreads those slots over dump rows and drops them instead of adding
    them all onto row 0."""
    return gather_rows(fields_ext, pg_padded, pad=pg_padded == 0, pad_row=None)


def build_pallas_pair_rows(proj, binning, ntx: int, nty: int, pair_budget: int):
    """Chunk-aligned pair rows + aligned starts for `composite_tiles`.

    Returns (pair_rows (P_pad, NUM_FIELDS), aligned_starts (T,)); the
    gradient of the rows flows back to `proj` through one gather."""
    fields_ext, pg_padded, astart = build_pallas_pair_layout(
        proj, binning, ntx, nty, pair_budget)
    return gather_pair_rows(fields_ext, pg_padded), astart


def render_gaussians_checked(
    means3d, scales, quats, opacities, sh, camera,
    cfg: RasterizeConfig = RasterizeConfig(),
    bg=None, colors_override=None,
    snapshot_path: str = "snapshot_fw.npz",
) -> Dict[str, Tensor]:
    """`render_gaussians` + a non-finite check: if the image or alpha holds
    NaN/Inf, every input is saved to `snapshot_path` (npz) and a
    RuntimeError names it (the reference rasterizer's debug snapshot)."""
    out = render_gaussians(means3d, scales, quats, opacities, sh, camera, cfg,
                           bg, colors_override)
    if not (torch.isfinite(out["image"]).all() and torch.isfinite(out["alpha"]).all()):
        def host(x):
            return np.zeros(0) if x is None else x.detach().cpu().numpy()

        np.savez(
            snapshot_path,
            means3d=host(means3d), scales=host(scales), quats=host(quats),
            opacities=host(opacities), sh=host(sh),
            colors_override=host(colors_override),
            viewmat=host(camera.viewmat),
            fx=float(camera.fx), fy=float(camera.fy),
            cx=float(camera.cx), cy=float(camera.cy),
            width=camera.width, height=camera.height,
            bg=host(bg) if bg is not None else np.zeros(3),
        )
        raise RuntimeError(
            f"non-finite render output; inputs saved to {snapshot_path} "
            f"(reference debug-mode snapshot semantics)"
        )
    return out


def render_gaussians(
    means3d: Tensor,
    scales: Tensor,
    quats: Tensor,
    opacities: Tensor,
    sh: Optional[Tensor],
    camera: RasterCamera,
    cfg: RasterizeConfig = RasterizeConfig(),
    bg: Optional[Tensor] = None,
    colors_override: Optional[Tensor] = None,
) -> Dict[str, Tensor]:
    """Differentiably render N Gaussians to an image.

    Args:
      means3d (N, 3); scales (N, 3); quats (N, 4) wxyz; opacities (N,);
      sh (N, K, 3) or None with colors_override (N, 3); bg (3,).

    Returns a dict: image (H, W, 3); alpha = 1 − final_t (H, W); final_t;
    n_contrib (H, W) int32; radii (N,) int32; mean2d; depth; num_pairs ()
    int32 (pre-cull total, may exceed the budget); num_tile_overflow ().
    """
    dev = means3d.device
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=dev)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)

    ts = cfg.tile_size
    ntx = -(-camera.width // ts)
    nty = -(-camera.height // ts)
    proj = preprocess_gaussians(
        means3d, scales, quats, opacities,
        sh if sh is not None else torch.zeros((means3d.shape[0], 1, 3),
                                              device=dev),
        camera, cfg.sh_degree, ts, cfg.scale_mod, colors_override,
        rect_mode=cfg.rect_mode,
    )
    fields_ext, pg_padded, astart, tile_count, num_pairs = (
        build_pair_layout_counting(proj, ntx, nty, cfg.pair_budget, ts)
    )
    rgb_tiles, t_tiles, cnt_tiles = composite_tiles_fused(
        fields_ext, pg_padded, astart, tile_count, ntx, nty, ts, cfg.chunk
    )
    tile_overflow = torch.sum(tile_count > cfg.tile_capacity, dtype=torch.int32)

    rgb, final_t = assemble_image(rgb_tiles, t_tiles, ntx, nty, ts,
                                  camera.width, camera.height)
    cnt = cnt_tiles.reshape(nty, ntx, ts, ts).permute(0, 2, 1, 3)
    cnt = cnt.reshape(nty * ts, ntx * ts)[: camera.height, : camera.width]
    image = rgb + final_t[..., None] * bg
    return {
        "image": image,
        "alpha": 1.0 - final_t,
        "final_t": final_t,
        "n_contrib": cnt.to(torch.int32),
        "radii": proj.radius,
        "mean2d": proj.mean2d,
        "depth": proj.depth,
        "num_pairs": num_pairs,
        "num_tile_overflow": tile_overflow,
    }
