# Frozen copy of youreditableavatar_tpu_torch/ops/quaternion.py (the plain PyTorch path only).
"""Quaternion ↔ rotation-matrix math (wxyz, normalized internally).

Counterpart of `youreditableavatar_tpu/ops/quaternion.py`.
"""

from __future__ import annotations

import torch
from torch import Tensor


def quat_normalize(q: Tensor, eps: float = 1e-12) -> Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=eps)






