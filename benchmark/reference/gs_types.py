# Frozen copy of youreditableavatar_tpu_torch/ops/gaussian_raster/types.py (the plain PyTorch path only).
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


