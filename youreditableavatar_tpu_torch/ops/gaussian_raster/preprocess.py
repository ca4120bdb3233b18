"""Per-Gaussian preprocess: projection, EWA covariance, SH color, tile bbox.

Counterpart of `youreditableavatar_tpu/ops/gaussian_raster/preprocess.py`
(`preprocessCUDA` semantics): frustum cull (z ≤ 0.2), world→pixel
projection, cov3D→cov2D→conic, 3σ radius, tile rectangle and SH→RGB.
Culled Gaussians are masked with radius = 0 / tiles_touched = 0.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from youreditableavatar_tpu_torch.ops.covariance import (
    build_cov3d,
    conic_and_radius,
    project_cov2d,
    view_transform_points,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster.types import (
    GaussiansProjected,
    RasterCamera,
)
from youreditableavatar_tpu_torch.ops.sh import sh_to_color

NEAR_PLANE = 0.2  # frustum cull threshold (forward.cu `in_frustum`)


def preprocess_gaussians(
    means3d: Tensor,
    scales: Tensor,
    quats: Tensor,
    opacities: Tensor,
    sh: Tensor,
    camera: RasterCamera,
    sh_degree: int,
    tile_size: int,
    scale_mod: float = 1.0,
    colors_override: Optional[Tensor] = None,
    cov3d_override: Optional[Tensor] = None,
    rect_mode: str = "support",
) -> GaussiansProjected:
    """Project N Gaussians into screen space for one camera.

    rect_mode: "support" (exact α ≥ 1/255 support bbox) or "3sigma" (the
    CUDA reference's `getRect` square from the integer 3σ radius).
    """
    if rect_mode not in ("support", "3sigma"):
        raise ValueError(f"unknown rect_mode {rect_mode!r}")
    t = view_transform_points(means3d, camera.viewmat)
    depth = t[..., 2]
    in_front = depth > NEAR_PLANE
    safe_z = torch.where(in_front, depth, torch.ones_like(depth))

    px = camera.fx * t[..., 0] / safe_z + camera.cx
    py = camera.fy * t[..., 1] / safe_z + camera.cy
    mean2d = torch.stack([px, py], dim=-1)

    cov6 = cov3d_override if cov3d_override is not None else build_cov3d(
        scales, quats, scale_mod
    )
    cov2d = project_cov2d(
        means3d, cov6, camera.viewmat,
        (camera.fx, camera.fy), (camera.tan_fovx, camera.tan_fovy),
    )
    conic, radius, det = conic_and_radius(cov2d)
    radius = torch.where(in_front & (det > 0.0), radius, torch.zeros_like(radius))

    if colors_override is not None:
        color = colors_override
    else:
        color = sh_to_color(sh_degree, sh, means3d, camera.campos)

    ntx = -(-camera.width // tile_size)
    nty = -(-camera.height // tile_size)
    # Integer tile rectangle (getRect semantics: min inclusive, max
    # exclusive, clamped); index bookkeeping, so no gradient flows here.
    with torch.no_grad():
        pix = mean2d
        if rect_mode == "3sigma":
            gate = radius > 0
            rx = torch.where(gate, radius.to(torch.float32),
                             torch.zeros_like(px))
            ry = rx
        else:
            two_l = 2.0 * torch.log(torch.clamp(255.0 * opacities, min=1e-6))
            gate = (radius > 0) & (two_l > 0.0)
            zero = torch.zeros_like(px)
            rx = torch.where(gate, torch.sqrt(two_l * torch.abs(cov2d[..., 0])), zero)
            ry = torch.where(gate, torch.sqrt(two_l * torch.abs(cov2d[..., 2])), zero)
        rect_min_x = torch.clamp((pix[..., 0] - rx) / tile_size, 0, ntx).to(torch.int32)
        rect_min_y = torch.clamp((pix[..., 1] - ry) / tile_size, 0, nty).to(torch.int32)
        rect_max_x = torch.clamp(
            torch.floor((pix[..., 0] + rx + tile_size - 1) / tile_size), 0, ntx
        ).to(torch.int32)
        rect_max_y = torch.clamp(
            torch.floor((pix[..., 1] + ry + tile_size - 1) / tile_size), 0, nty
        ).to(torch.int32)
        w_t = torch.clamp(rect_max_x - rect_min_x, min=0)
        h_t = torch.clamp(rect_max_y - rect_min_y, min=0)
        tiles = torch.where(gate, w_t * h_t, torch.zeros_like(w_t))

    return GaussiansProjected(
        mean2d=mean2d,
        depth=depth,
        conic=conic,
        color=color,
        opacity=opacities,
        radius=radius,
        rect_min=torch.stack([rect_min_x, rect_min_y], dim=-1),
        rect_max=torch.stack([rect_max_x, rect_max_y], dim=-1),
        tiles_touched=tiles.to(torch.int32),
    )
