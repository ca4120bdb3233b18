"""Quaternion ↔ rotation-matrix math (wxyz, normalized internally).

Counterpart of `youreditableavatar_tpu/ops/quaternion.py`.
"""

from __future__ import annotations

import torch
from torch import Tensor


def quat_normalize(q: Tensor, eps: float = 1e-12) -> Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=eps)


def quat_to_matrix(q: Tensor) -> Tensor:
    """(…, 4) wxyz quaternion → (…, 3, 3) rotation matrix. Normalizes input."""
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        torch.stack([1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z),
                     2.0 * (x * z + w * y)], dim=-1),
        torch.stack([2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z),
                     2.0 * (y * z - w * x)], dim=-1),
        torch.stack([2.0 * (x * z - w * y), 2.0 * (y * z + w * x),
                     1.0 - 2.0 * (x * x + y * y)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def matrix_to_quat(m: Tensor) -> Tensor:
    """(…, 3, 3) rotation matrix → (…, 4) wxyz quaternion (branch-free,
    largest-denominator candidate, canonical sign w ≥ 0)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw2 = torch.clamp(1.0 + m00 + m11 + m22, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)
    cands = torch.stack([
        torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1),
    ], dim=-2)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = quat_normalize(torch.gather(cands, -2, idx)[..., 0, :])
    return torch.where(q[..., :1] < 0.0, -q, q)


def quat_multiply(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product of wxyz quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )
