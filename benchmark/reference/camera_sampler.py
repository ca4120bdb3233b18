# Frozen copy of youreditableavatar_tpu_torch/data/camera_sampler.py (the plain PyTorch path only).
"""Random local/global camera sampling for the spatial (SDS) stage.

Counterpart of `youreditableavatar_tpu/data/camera_sampler.py` (the same
numpy code, so both packages draw the same cameras for a seed), after
`tetgs_spatial/data/uncond.py:31-545`
(`RandomCameraLocalGlobalIterableDataset`): per step, a batch of spherical
cameras — elevation drawn half the time uniformly in angle, half uniformly on
the sphere (inverse-transform), batch-stratified azimuth, uniform distance
and fovy ranges — each produced in TWO framings sharing the pose: a LOCAL
garment crop (focal × 2.2, look-at center shifted by the edit-region type)
and a GLOBAL full-body view (focal × 1.4, center z −0.05). Warmup
progressively widens the ranges from the eval view (`uncond.py:118-129`).

Pure-numpy host sampling; `GSCamera.raster_camera(device)` places a
camera on a device (default cuda).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from benchmark.reference.cameras import GSCamera, c2w_to_gs_camera


@dataclasses.dataclass(frozen=True)
class RandomCameraConfig:
    height: int = 512
    width: int = 512
    batch_size: int = 1
    elevation_range: Tuple[float, float] = (-10, 90)
    azimuth_range: Tuple[float, float] = (-180, 180)
    camera_distance_range: Tuple[float, float] = (1.0, 1.5)
    fovy_range: Tuple[float, float] = (40, 70)
    batch_uniform_azimuth: bool = True
    global_focal_scale: float = 1.4
    local_focal_scale: float = 2.2
    global_center_perturb: float = -0.05
    local_type: str = "full"  # "full" | "upper" | "lower"
    local_center_perturb: Tuple[float, float, float] = (-0.05, 0.3, -0.35)
    # Warmup (`progressive_until`): ranges lerp from the eval view.
    progressive_until: int = 0
    eval_elevation_deg: float = 5.0


@dataclasses.dataclass
class CameraBatch:
    """One sampled step: paired local/global cameras (shared poses)."""

    local: List[GSCamera]
    global_: List[GSCamera]
    elevation_deg: np.ndarray
    azimuth_deg: np.ndarray
    camera_distances: np.ndarray


class RandomCameraSampler:
    def __init__(self, cfg: RandomCameraConfig, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)

    def _ranges(self, global_step: int):
        cfg = self.cfg
        if cfg.progressive_until > 0 and global_step < cfg.progressive_until:
            r = global_step / cfg.progressive_until
            elev = (
                (1 - r) * cfg.eval_elevation_deg + r * cfg.elevation_range[0],
                (1 - r) * cfg.eval_elevation_deg + r * cfg.elevation_range[1],
            )
            azim = (r * cfg.azimuth_range[0], r * cfg.azimuth_range[1])
            return elev, azim
        return cfg.elevation_range, cfg.azimuth_range

    def sample(self, global_step: int = 0) -> CameraBatch:
        cfg = self.cfg
        b = cfg.batch_size
        elev_range, azim_range = self._ranges(global_step)

        if self.rng.random() < 0.5:
            elevation_deg = self.rng.uniform(*elev_range, b)
        else:
            lo = (elev_range[0] + 90.0) / 180.0
            hi = (elev_range[1] + 90.0) / 180.0
            u = self.rng.uniform(lo, hi, b)
            elevation_deg = np.rad2deg(np.arcsin(2 * u - 1.0))

        if cfg.batch_uniform_azimuth:
            azimuth_deg = (self.rng.uniform(0, 1, b) + np.arange(b)) / b * (
                azim_range[1] - azim_range[0]
            ) + azim_range[0]
        else:
            azimuth_deg = self.rng.uniform(*azim_range, b)

        dist = self.rng.uniform(*cfg.camera_distance_range, b)
        fovy_deg = self.rng.uniform(*cfg.fovy_range, b)
        focal = 0.5 * cfg.height / np.tan(0.5 * np.deg2rad(fovy_deg))

        local_shift = {
            "full": cfg.local_center_perturb[0],
            "upper": cfg.local_center_perturb[1],
            "lower": cfg.local_center_perturb[2],
        }[cfg.local_type]

        locals_, globals_ = [], []
        for i in range(b):
            el, az = np.deg2rad(elevation_deg[i]), np.deg2rad(azimuth_deg[i])
            pos = dist[i] * np.array(
                [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)]
            )
            for center_z, fscale, out in (
                (local_shift, cfg.local_focal_scale, locals_),
                (cfg.global_center_perturb, cfg.global_focal_scale, globals_),
            ):
                center = np.array([0.0, 0.0, center_z])
                lookat = center - pos
                lookat /= np.linalg.norm(lookat)
                up = np.array([0.0, 0.0, 1.0])
                right = np.cross(lookat, up)
                right /= np.linalg.norm(right)
                up2 = np.cross(right, lookat)
                c2w = np.eye(4)
                c2w[:3, :3] = np.stack([right, up2, -lookat], axis=-1)
                c2w[:3, 3] = pos
                out.append(
                    c2w_to_gs_camera(
                        c2w, float(focal[i] * fscale), cfg.width, cfg.height
                    )
                )
        return CameraBatch(
            local=locals_,
            global_=globals_,
            elevation_deg=elevation_deg,
            azimuth_deg=azimuth_deg,
            camera_distances=dist,
        )
