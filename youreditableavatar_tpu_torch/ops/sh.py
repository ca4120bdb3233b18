"""Real spherical harmonics evaluation (degrees 0..3) for Gaussian colors.

Counterpart of `youreditableavatar_tpu/ops/sh.py`: the CUDA-rasterizer
colour path (+0.5 offset, clamp at 0); autograd gives the clamp masking.
"""

from __future__ import annotations

import torch
from torch import Tensor

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh_basis(degree: int, dirs: Tensor) -> Tensor:
    """(..., 3) unit directions → (..., (degree+1)**2) basis values."""
    if degree < 0 or degree > 3:
        raise ValueError(f"SH degree must be in [0, 3], got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    basis = [SH_C0 * torch.ones_like(x)]
    if degree >= 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        xy = x * y
        basis += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(basis, dim=-1)


def eval_sh(degree: int, sh: Tensor, dirs: Tensor) -> Tensor:
    """SH (..., K, 3) at unit directions (..., 3) → raw RGB (..., 3)."""
    k = num_sh_coeffs(degree)
    basis = eval_sh_basis(degree, dirs)
    return torch.sum(basis[..., :, None] * sh[..., :k, :], dim=-2)


def sh_to_color(degree: int, sh: Tensor, means: Tensor, campos: Tensor) -> Tensor:
    """Colour from SH seen from `campos`: +0.5 offset, clamp ≥ 0."""
    dirs = means - campos
    dirs = dirs / torch.clamp(
        torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12
    )
    return torch.clamp(eval_sh(degree, sh, dirs) + 0.5, min=0.0)


def rgb_to_sh_dc(rgb: Tensor) -> Tensor:
    """Invert the DC term: color ≈ SH_C0 * dc + 0.5."""
    return (rgb - 0.5) / SH_C0


def sh_dc_to_rgb(dc: Tensor) -> Tensor:
    return dc * SH_C0 + 0.5
