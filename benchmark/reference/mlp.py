# Frozen copy of youreditableavatar_tpu_torch/models/mlp.py (the plain PyTorch path only).
"""Small MLPs for implicit fields (replaces tcnn FullyFusedMLP + VanillaMLP).

Counterpart of `youreditableavatar_tpu/models/mlp.py`: the same layer list
[{'w': (din, dout), 'b': (dout,)}, ...] — here an `nn.ModuleList` of
`MLPLayer`s holding `w` and `b` as parameters — with the optional sphere
initialization for SDF heads. Plain f32 matmuls; TF32 must stay off on the
card (`torch.backends.cuda.matmul.allow_tf32`, which PyTorch leaves off by
default and `chip_smoke.py` sets off).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor, nn


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    dim_in: int = 32
    dim_out: int = 1
    n_neurons: int = 64
    n_hidden_layers: int = 1
    # Geometric (sphere) init for SDF heads: output ≈ ‖x‖ − radius at start.
    sphere_init: bool = False
    sphere_init_radius: float = 0.5
    sphere_init_inside_out: bool = False
    weight_norm: bool = False  # kept for config parity; applied at init only


class MLPLayer(nn.Module):
    """One affine layer: `w` (din, dout) and `b` (dout,)."""

    def __init__(self, w: Tensor, b: Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)




_ACTIVATIONS = {
    "relu": F.relu,
    # jax.nn.gelu defaults to the tanh approximation.
    "gelu": lambda h: F.gelu(h, approximate="tanh"),
    "softplus": F.softplus,
}


def mlp_apply(params, x: Tensor, activation: str = "relu") -> Tensor:
    """Forward pass; hidden activation relu (reference default), linear out."""
    act = _ACTIVATIONS[activation]
    h = x
    for i, layer in enumerate(params):
        h = h @ layer.w + layer.b
        if i < len(params) - 1:
            h = act(h)
    return h
