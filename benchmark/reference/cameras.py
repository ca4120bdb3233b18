"""The look-at `GSCamera` of the port's `models/cameras.py`, as far as the
random camera sampler uses it, with the raster camera it hands on."""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from benchmark.reference.gs_types import RasterCamera


@dataclasses.dataclass
class GSCamera:
    """A posed pinhole camera (3DGS convention: R = cam→world rotation)."""

    R: np.ndarray  # (3, 3) c2w rotation
    T: np.ndarray  # (3,) w2c translation
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def viewmat(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.R.T
        m[:3, 3] = self.T
        return m

    def raster_camera(self, device) -> RasterCamera:
        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return RasterCamera(
            viewmat=f32(self.viewmat), fx=f32(self.fx), fy=f32(self.fy),
            cx=f32(self.cx), cy=f32(self.cy),
            width=self.width, height=self.height,
        )


def c2w_to_gs_camera(c2w: np.ndarray, focal: float, width: int,
                     height: int) -> GSCamera:
    """OpenGL-style look-at c2w → COLMAP-convention GSCamera."""
    gl2cv = np.diag([1.0, -1.0, -1.0])
    r_c2w = c2w[:3, :3] @ gl2cv
    t_c2w = c2w[:3, 3]
    r_w2c = r_c2w.T
    t_w2c = -r_w2c @ t_c2w
    return GSCamera(
        R=r_c2w.astype(np.float32),
        T=t_w2c.astype(np.float32),
        fx=focal, fy=focal,
        cx=(width - 1) / 2.0, cy=(height - 1) / 2.0,
        width=width, height=height,
    )
