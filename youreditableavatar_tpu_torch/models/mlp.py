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


def init_mlp_params(generator: Optional[torch.Generator], cfg: MLPConfig,
                    device=None) -> nn.ModuleList:
    """Initialize the layer list (drawn on the CPU from `generator`, then
    moved to `device`)."""
    dims = [cfg.dim_in] + [cfg.n_neurons] * cfg.n_hidden_layers + [cfg.dim_out]
    layers = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        is_last = i == len(dims) - 2
        is_first = i == 0
        noise = torch.randn((din, dout), generator=generator)
        if cfg.sphere_init:
            # Geometric initialization: hidden layers ~ N(0, sqrt(2/dout)),
            # last layer ~ N(sqrt(pi/din), tiny) with bias −radius.
            if is_last:
                sign = -1.0 if cfg.sphere_init_inside_out else 1.0
                mean = sign * math.sqrt(math.pi) / math.sqrt(din)
                w = mean + 1e-4 * noise
                b = torch.full((dout,), -sign * cfg.sphere_init_radius)
            else:
                w = noise * math.sqrt(2.0 / dout)
                if is_first:
                    # Positions enter in the first 3 dims; zero the rest so
                    # the initial field is a function of position only.
                    w[3:] = 0.0
                b = torch.zeros((dout,))
        else:
            w = noise * math.sqrt(2.0 / (din + dout))
            b = torch.zeros((dout,))
        layers.append(MLPLayer(w.to(torch.float32), b.to(torch.float32)))
    return nn.ModuleList(layers).to(device)


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
