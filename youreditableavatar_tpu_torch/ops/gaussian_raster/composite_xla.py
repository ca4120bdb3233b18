"""Compositing constants and tile ↔ image layout helpers.

Counterpart of the shared parts of
`youreditableavatar_tpu/ops/gaussian_raster/composite_xla.py`. The CUDA
rasterizer's compositing semantics, per Gaussian i in depth order and per
pixel:

    alpha  = min(0.99, opacity · exp(power));  skip if power > 0 or alpha < 1/255
    test_T = T · (1 − alpha)
    if test_T < 1e-4: the pixel is done (no contribution from i onward)
    else: C += color · alpha · T;  T = test_T

The compositing itself (kernel and plain version) is `composite_cuda.py`.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

ALPHA_CLAMP = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4

# Columns of the (N+1, NUM_FIELDS) per-Gaussian rows: mean x/y, conic
# a/b/c, opacity, r/g/b, row id; 10..15 zero.
NUM_FIELDS = 16


def tile_pixel_coords(
    num_tiles_x: int,
    num_tiles_y: int,
    tile_size: int,
    device=None,
) -> Tuple[Tensor, Tensor]:
    """(px, py), each (T, PIX) f32: flat pixel p of a tile → (p % ts, p // ts)
    offset by the tile origin."""
    tile_ids = torch.arange(num_tiles_x * num_tiles_y, dtype=torch.int32,
                            device=device)
    base_x = (tile_ids % num_tiles_x) * tile_size
    base_y = torch.div(tile_ids, num_tiles_x, rounding_mode="floor") * tile_size
    p = torch.arange(tile_size * tile_size, dtype=torch.int32,
                     device=tile_ids.device)
    px = base_x[:, None] + p[None, :] % tile_size
    py = base_y[:, None] + torch.div(p, tile_size, rounding_mode="floor")[None, :]
    return px.to(torch.float32), py.to(torch.float32)


def assemble_image(
    rgb_tiles: Tensor,
    t_tiles: Tensor,
    num_tiles_x: int,
    num_tiles_y: int,
    tile_size: int,
    width: int,
    height: int,
) -> Tuple[Tensor, Tensor]:
    """(T, 3, PIX) tiles → (H, W, 3) image + (H, W) transmittance."""
    ts = tile_size
    rgb = rgb_tiles.reshape(num_tiles_y, num_tiles_x, 3, ts, ts)
    rgb = rgb.permute(0, 3, 1, 4, 2).reshape(num_tiles_y * ts,
                                             num_tiles_x * ts, 3)
    t = t_tiles.reshape(num_tiles_y, num_tiles_x, ts, ts)
    t = t.permute(0, 2, 1, 3).reshape(num_tiles_y * ts, num_tiles_x * ts)
    return rgb[:height, :width], t[:height, :width]
