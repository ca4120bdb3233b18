"""Shared graphics math (focal/fov, triangle metrics).

Counterpart of `youreditableavatar_tpu/utils/graphics.py`.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor


def focal2fov(focal: float, pixels: int) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def triangle_area(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """(N,) area of triangles."""
    return 0.5 * torch.linalg.norm(torch.cross(b - a, c - a, dim=-1), dim=-1)


def circumcircle_radius(a: Tensor, b: Tensor, c: Tensor,
                        eps: float = 1e-12) -> Tensor:
    """(N,) circumcircle radius of triangles (a, b, c)."""
    la = torch.linalg.norm(b - c, dim=-1)
    lb = torch.linalg.norm(a - c, dim=-1)
    lc = torch.linalg.norm(a - b, dim=-1)
    s = 0.5 * (la + lb + lc)
    k = torch.sqrt(torch.clamp(s * (s - la) * (s - lb) * (s - lc), min=eps))
    return la * lb * lc / (4.0 * k)


def inverse_sigmoid(x: Tensor) -> Tensor:
    return torch.log(x / (1.0 - x))
