"""Camera and projected-Gaussian types for the Gaussian rasterizer.

Counterpart of `youreditableavatar_tpu/ops/gaussian_raster/types.py`: a
direct pinhole map p_cam = W p + t, pix = (fx·x/z + cx, fy·y/z + cy), with
cx = (W-1)/2 for a centred principal point.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch
from torch import Tensor

from youreditableavatar_tpu_torch.utils.device import resolve_device


class RasterCamera(NamedTuple):
    """Pinhole camera for splatting; tensors live on the render's device."""

    viewmat: Tensor  # (4, 4) f32 world→camera
    fx: Tensor  # () focal, pixels
    fy: Tensor
    cx: Tensor  # () principal point, pixels
    cy: Tensor
    width: int
    height: int

    @property
    def tan_fovx(self) -> Tensor:
        return 0.5 * self.width / self.fx

    @property
    def tan_fovy(self) -> Tensor:
        return 0.5 * self.height / self.fy

    @property
    def campos(self) -> Tensor:
        r = self.viewmat[:3, :3]
        t = self.viewmat[:3, 3]
        return -r.T @ t

    @staticmethod
    def from_fov(
        viewmat,
        fovx: float,
        fovy: float,
        width: int,
        height: int,
        cx: float | None = None,
        cy: float | None = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "RasterCamera":
        dev = resolve_device(device)
        fx = 0.5 * width / np.tan(0.5 * fovx)
        fy = 0.5 * height / np.tan(0.5 * fovy)

        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=dev)

        return RasterCamera(
            viewmat=f32(viewmat),
            fx=f32(fx),
            fy=f32(fy),
            cx=f32((width - 1) / 2.0 if cx is None else cx),
            cy=f32((height - 1) / 2.0 if cy is None else cy),
            width=int(width),
            height=int(height),
        )


class GaussiansProjected(NamedTuple):
    """Per-Gaussian screen-space quantities emitted by preprocess."""

    mean2d: Tensor  # (N, 2) pixel coordinates
    depth: Tensor  # (N,) camera-space z
    conic: Tensor  # (N, 3) inverse 2D covariance (A, B, C)
    color: Tensor  # (N, 3) clamped RGB
    opacity: Tensor  # (N,)
    radius: Tensor  # (N,) int32 3σ pixel radius (0 = culled)
    rect_min: Tensor  # (N, 2) int32 inclusive tile bbox min (x, y)
    rect_max: Tensor  # (N, 2) int32 exclusive tile bbox max (x, y)
    tiles_touched: Tensor  # (N,) int32


class TileBinning(NamedTuple):
    """Sorted (gaussian, tile) pair lists + per-tile ranges."""

    pair_gauss: Tensor  # (P,) int32 gaussian index per sorted pair
    pair_tile: Tensor  # (P,) int32 tile id per sorted pair (sentinel = T)
    tile_start: Tensor  # (T,) int32 first pair index of each tile
    tile_count: Tensor  # (T,) int32 number of pairs of each tile
    num_pairs: Tensor  # () int32 total real pairs (may exceed budget P)
