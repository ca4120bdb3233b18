"""Camera layer: posed pinhole cameras and synthetic ring samplers.

Counterpart of the parts of `youreditableavatar_tpu/models/cameras.py` that
the init-texture fit uses: `GSCamera`, `spherical_c2w`, `gen_tet_camera`,
`c2w_to_gs_camera` and `sample_ring_cameras`. All host-side numpy; a
camera becomes device tensors through `GSCamera.raster_camera(device)`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from youreditableavatar_tpu_torch.ops.gaussian_raster.types import RasterCamera
from youreditableavatar_tpu_torch.utils.device import resolve_device


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
    name: str = ""
    image: Optional[np.ndarray] = None  # (H, W, 3) float32 in [0, 1]
    mask: Optional[np.ndarray] = None  # (H, W) float32

    @property
    def viewmat(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.R.T
        m[:3, 3] = self.T
        return m

    @property
    def c2w(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.R
        m[:3, 3] = -self.R @ self.T
        return m

    @property
    def campos(self) -> np.ndarray:
        return -self.R @ self.T

    def raster_camera(self, device=None) -> RasterCamera:
        dev = resolve_device(device)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        return RasterCamera(
            viewmat=f32(self.viewmat), fx=f32(self.fx), fy=f32(self.fy),
            cx=f32(self.cx), cy=f32(self.cy),
            width=self.width, height=self.height,
        )


def spherical_c2w(elevation_deg: float, azimuth_deg: float, radius: float,
                  center: np.ndarray | None = None,
                  up: np.ndarray | None = None) -> np.ndarray:
    """Look-at c2w with columns [right, up, −lookat]; scene-up is +z."""
    el = np.deg2rad(elevation_deg)
    az = np.deg2rad(azimuth_deg)
    pos = radius * np.array(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)]
    )
    center = np.zeros(3) if center is None else np.asarray(center, np.float64)
    up = np.array([0.0, 0.0, 1.0]) if up is None else np.asarray(up)
    lookat = center - pos
    lookat = lookat / np.linalg.norm(lookat)
    right = np.cross(lookat, up)
    right = right / np.linalg.norm(right)
    up2 = np.cross(right, lookat)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, up2, -lookat], axis=-1)
    c2w[:3, 3] = pos
    return c2w


# Focal scale + vertical center shift per crop type.
SAMPLE_TYPE_PARAMS = {
    "full": (1.4, -0.05),
    "upper": (2.2, +0.3),
    "lower": (1.8, -0.3),
}


def gen_tet_camera(idx: int, radius: float, elevation_deg: float,
                   azimuth_deg: float, fov_deg: float, height: int,
                   sample_type: str = "full") -> Tuple[np.ndarray, float]:
    """(c2w, focal_px) for probe views; the first two use full framing."""
    scale, z_shift = SAMPLE_TYPE_PARAMS["full" if idx < 2 else sample_type]
    c2w = spherical_c2w(elevation_deg, azimuth_deg, radius,
                        np.array([0.0, 0.0, z_shift]))
    focal = 0.5 * height / np.tan(0.5 * np.deg2rad(fov_deg))
    return c2w, float(scale * focal)


def c2w_to_gs_camera(c2w: np.ndarray, focal: float, width: int, height: int,
                     name: str = "") -> GSCamera:
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
        width=width, height=height, name=name,
    )


def sample_ring_cameras(
    radius: float = 2.7,
    elevations: Sequence[float] = (5.0, 25.0, -20.0),
    counts: Sequence[int] = (8, 12, 12),
    fov_deg: float = 50.0,
    height: int = 2048,
    width: int = 2048,
    sample_type: str = "full",
    pose_transform=None,
) -> List[GSCamera]:
    """The 3-ring view set (elevations × evenly spaced azimuths)."""
    out = []
    idx = 0
    for elev, n in zip(elevations, counts):
        for k in range(n):
            c2w, focal = gen_tet_camera(idx, radius, elev, 360.0 * k / n,
                                        fov_deg, height, sample_type)
            if pose_transform is not None:
                c2w = pose_transform(c2w)
            out.append(c2w_to_gs_camera(c2w, focal, width, height,
                                        name=f"ring{idx:03d}"))
            idx += 1
    return out
