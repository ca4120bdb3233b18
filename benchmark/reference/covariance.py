# Frozen copy of youreditableavatar_tpu_torch/ops/covariance.py (the plain PyTorch path only).
"""Gaussian covariance math: 3D build + EWA perspective projection to 2D.

Counterpart of `youreditableavatar_tpu/ops/covariance.py` (the CUDA
rasterizer's `computeCov3D` / `computeCov2D` semantics), in the same
expanded element-wise form so that the two agree to f32 rounding.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from benchmark.reference.quaternion import quat_normalize

# Screen-space low-pass filter added to the 2D covariance diagonal (px²).
COV2D_BLUR = 0.3


def build_cov3d(scales: Tensor, quats: Tensor, scale_mod: float = 1.0) -> Tensor:
    """Σ = R S Sᵀ Rᵀ as the 6 unique entries (xx, xy, xz, yy, yz, zz)."""
    q = quat_normalize(quats)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)

    s = scales * scale_mod
    s0, s1, s2 = s[..., 0] ** 2, s[..., 1] ** 2, s[..., 2] ** 2
    xx = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    xy = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    xz = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    yy = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    yz = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    zz = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return torch.stack([xx, xy, xz, yy, yz, zz], dim=-1)




def view_transform_points(means: Tensor, viewmat: Tensor) -> Tensor:
    """p_cam = W p + t, expanded."""
    w = viewmat
    mx, my, mz = means[..., 0], means[..., 1], means[..., 2]
    tx = w[0, 0] * mx + w[0, 1] * my + w[0, 2] * mz + w[0, 3]
    ty = w[1, 0] * mx + w[1, 1] * my + w[1, 2] * mz + w[1, 3]
    tz = w[2, 0] * mx + w[2, 1] * my + w[2, 2] * mz + w[2, 3]
    return torch.stack([tx, ty, tz], dim=-1)


def project_cov2d(
    means: Tensor,
    cov6: Tensor,
    viewmat: Tensor,
    focal: Tuple[Tensor, Tensor],
    tan_fov: Tuple[Tensor, Tensor],
) -> Tensor:
    """EWA projection of 3D covariances: (N, 3) screen-space (a, b, c) with
    the low-pass blur on the diagonal."""
    t = view_transform_points(means, viewmat)
    fx, fy = focal
    tanx, tany = tan_fov

    # Clamp the ray to 1.3× the frustum to bound the Jacobian.
    tz = t[..., 2]
    txc = torch.clamp(t[..., 0] / tz, -1.3 * tanx, 1.3 * tanx) * tz
    tyc = torch.clamp(t[..., 1] / tz, -1.3 * tany, 1.3 * tany) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z

    w = viewmat
    j00, j02 = fx * inv_z, -fx * txc * inv_z2
    j11, j12 = fy * inv_z, -fy * tyc * inv_z2
    u0 = j00 * w[0, 0] + j02 * w[2, 0]
    u1 = j00 * w[0, 1] + j02 * w[2, 1]
    u2 = j00 * w[0, 2] + j02 * w[2, 2]
    v0 = j11 * w[1, 0] + j12 * w[2, 0]
    v1 = j11 * w[1, 1] + j12 * w[2, 1]
    v2 = j11 * w[1, 2] + j12 * w[2, 2]

    xx, xy, xz = cov6[..., 0], cov6[..., 1], cov6[..., 2]
    yy, yz, zz = cov6[..., 3], cov6[..., 4], cov6[..., 5]
    vu0 = xx * u0 + xy * u1 + xz * u2
    vu1 = xy * u0 + yy * u1 + yz * u2
    vu2 = xz * u0 + yz * u1 + zz * u2
    vv0 = xx * v0 + xy * v1 + xz * v2
    vv1 = xy * v0 + yy * v1 + yz * v2
    vv2 = xz * v0 + yz * v1 + zz * v2

    a = u0 * vu0 + u1 * vu1 + u2 * vu2 + COV2D_BLUR
    b = v0 * vu0 + v1 * vu1 + v2 * vu2
    c = v0 * vv0 + v1 * vv1 + v2 * vv2 + COV2D_BLUR
    return torch.stack([a, b, c], dim=-1)


def conic_and_radius(cov2d: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Inverse 2D covariance (A, B, C), integer 3σ radius (0 = degenerate)
    and the determinant."""
    a, b, c = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    det = a * c - b * b
    inv_det = torch.where(det != 0.0, 1.0 / det, torch.zeros_like(det))
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lam1 = mid + disc
    lam2 = mid - disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(lam1, lam2)))
    radius = torch.where(det > 0.0, radius, torch.zeros_like(radius))
    return conic, radius.to(torch.int32), det
