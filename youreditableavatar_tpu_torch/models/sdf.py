"""Implicit SDF field: hash-grid encoding + MLP head.

Counterpart of `youreditableavatar_tpu/models/sdf.py` (HashGrid 16 levels ×
2 features, 2^19 table, base res 16, growth 1.3819, progressive start level
8; 1-hidden-layer 64-wide ReLU MLP; finite-difference normals; sphere sdf
bias). `SDFField` stays a stateless config object: every method takes
(params, points), so one field serves the live and the frozen parameters.
The parameters are an `SDFParams` module — `grid` (L, T, F) and the MLP's
per-layer `w` (din, dout) / `b` (dout,) — the JAX pytree's layout, so
`sdf_params_from_numpy` carries weights across with a copy.

`forward_sdf_chunked` evaluates chunks of 262,144 points in a Python loop;
each chunk is one encode call, so one K4 launch in backward.

`normal_type="analytic"` differentiates the field with autograd once; the
normals it returns carry no gradient of their own.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor, nn

from youreditableavatar_tpu_torch.models.mlp import (
    MLPConfig,
    MLPLayer,
    init_mlp_params,
    mlp_apply,
)
from youreditableavatar_tpu_torch.ops.hashgrid import (
    HashGridConfig,
    hashgrid_encode,
    init_hashgrid_params,
    progressive_level_mask,
)
from youreditableavatar_tpu_torch.utils.device import resolve_device
from youreditableavatar_tpu_torch.utils.registry import register


@dataclasses.dataclass(frozen=True)
class SDFFieldConfig:
    radius: float = 1.0  # bbox half-extent; points live in [-radius, radius]³
    grid: HashGridConfig = dataclasses.field(
        default_factory=lambda: HashGridConfig(
            n_levels=16,
            n_features_per_level=2,
            log2_hashmap_size=19,
            base_resolution=16,
            per_level_scale=1.381912879967776,
            progressive=True,
            start_level=8,
            start_step=0,
            update_steps=1000,
        )
    )
    n_neurons: int = 64
    n_hidden_layers: int = 1
    normal_type: str = "finite_difference"  # or "analytic"
    finite_difference_normal_eps: float = 0.01
    progressive_eps: bool = False  # Neuralangelo-style eps from active level
    sdf_bias: Union[str, float] = 0.0  # 0.0 or "sphere"
    sdf_bias_radius: float = 0.5


class SDFParams(nn.Module):
    """Field parameters: `grid` (L, T, F) and `mlp`, a list of layers with
    `w` (din, dout) and `b` (dout,)."""

    def __init__(self, grid: Tensor, mlp: nn.ModuleList):
        super().__init__()
        self.grid = nn.Parameter(grid)
        self.mlp = mlp


def sdf_params_from_numpy(d: Mapping[str, Any], device=None) -> SDFParams:
    """The JAX field pytree {"grid": (L,T,F), "mlp": [{"w","b"}, ...]} (as
    numpy or anything `np.asarray` reads) → an `SDFParams` on `device`."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev)

    layers = nn.ModuleList(MLPLayer(t(l["w"]), t(l["b"])) for l in d["mlp"])
    return SDFParams(t(d["grid"]), layers)


def _generator(seed: Union[int, torch.Generator, None]) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(0 if seed is None else int(seed))


@functools.lru_cache(maxsize=None)
def fd_offsets(eps: float, device: torch.device) -> Tensor:
    """The (3, 3) f32 finite-difference steps eps·e_i on `device`, copied
    there once per (eps, device): a host copy at every call would wait for
    the stream each time."""
    return torch.tensor([[eps, 0, 0], [0, eps, 0], [0, 0, eps]],
                        dtype=torch.float32, device=device)


@register("implicit-sdf")
class SDFField:
    """Stateless field; all state in the `SDFParams`."""

    def __init__(self, cfg: SDFFieldConfig = SDFFieldConfig()):
        self.cfg = cfg
        self.mlp_cfg = MLPConfig(
            dim_in=cfg.grid.out_dim,
            dim_out=1,
            n_neurons=cfg.n_neurons,
            n_hidden_layers=cfg.n_hidden_layers,
        )

    def init_params(self, generator: Union[int, torch.Generator, None] = None,
                    device=None) -> SDFParams:
        """Fresh parameters drawn on the CPU from `generator` (a
        `torch.Generator` or a seed), placed on `device` (default cuda)."""
        dev = resolve_device(device)
        g = _generator(generator)
        grid = init_hashgrid_params(g, self.cfg.grid)
        mlp = init_mlp_params(g, self.mlp_cfg)
        return SDFParams(grid, mlp).to(dev)

    def contract(self, points: Tensor) -> Tensor:
        """[-radius, radius]³ → [0, 1]³ (bounded `contract_to_unisphere`)."""
        r = self.cfg.radius
        return torch.clamp((points + r) / (2 * r), 0.0, 1.0)

    def level_mask(self, global_step: int, device=None) -> Tensor:
        return progressive_level_mask(self.cfg.grid, global_step, device=device)

    def forward_sdf(
        self,
        params: SDFParams,
        points: Tensor,
        level_mask: Optional[Tensor] = None,
        n_active: Optional[int] = None,
    ) -> Tensor:
        """(N, 3) → (N,) signed distance. `n_active` skips masked
        progressive levels entirely (exact; see `hashgrid_encode`)."""
        x = self.contract(points)
        enc = hashgrid_encode(params.grid, x, self.cfg.grid, level_mask,
                              n_active=n_active)
        sdf = mlp_apply(params.mlp, enc)[..., 0]
        return sdf + self._bias(points)

    def _bias(self, points: Tensor) -> Union[Tensor, float]:
        if self.cfg.sdf_bias == "sphere":
            return torch.linalg.norm(points, dim=-1) - self.cfg.sdf_bias_radius
        return float(self.cfg.sdf_bias)

    def fd_eps(self, global_step: int = 0) -> float:
        cfg = self.cfg
        if not cfg.progressive_eps:
            return cfg.finite_difference_normal_eps
        g = cfg.grid
        level = min(
            g.start_level + max(global_step - g.start_step, 0) // g.update_steps,
            g.n_levels,
        )
        grid_res = g.base_resolution * g.per_level_scale ** (level - 1)
        return 2 * cfg.radius / grid_res

    def forward_with_normal(
        self,
        params: SDFParams,
        points: Tensor,
        level_mask: Optional[Tensor] = None,
        eps: Optional[float] = None,
    ) -> Tuple[Tensor, Tensor]:
        """(N, 3) → (sdf (N,), unit normal (N, 3)).

        Forward-difference normals: grad_i = (sdf(p + eps·e_i) − sdf(p)) / eps.
        """
        if self.cfg.normal_type == "analytic":
            with torch.enable_grad():
                p = points.detach().requires_grad_()
                sdf = self.forward_sdf(params, p, level_mask)
                grads = torch.autograd.grad(sdf.sum(), p)[0]
            n = grads / torch.clamp(
                torch.linalg.norm(grads, dim=-1, keepdim=True), min=1e-12)
            return sdf.detach(), n

        e = self.cfg.finite_difference_normal_eps if eps is None else eps
        r = self.cfg.radius
        offsets = fd_offsets(e, points.device)
        p_off = torch.clamp(points[:, None, :] + offsets[None], -r, r)
        all_pts = torch.cat([points, p_off.reshape(-1, 3)])
        all_sdf = self.forward_sdf(params, all_pts, level_mask)
        n = points.shape[0]
        sdf = all_sdf[:n]
        sdf_off = all_sdf[n:].reshape(n, 3)
        grad = (sdf_off - sdf[:, None]) / e
        normal = grad / torch.clamp(
            torch.linalg.norm(grad, dim=-1, keepdim=True), min=1e-12)
        return sdf, normal

    def forward_sdf_chunked(
        self,
        params: SDFParams,
        points: Tensor,
        chunk: int = 262144,
        level_mask: Optional[Tensor] = None,
        n_active: Optional[int] = None,
    ) -> Tensor:
        """Chunked field eval (`chunk_batch`): chunks of `chunk` points
        bound activation memory on big tet grids."""
        n = points.shape[0]
        if n <= chunk:
            return self.forward_sdf(params, points, level_mask, n_active)
        return torch.cat([
            self.forward_sdf(params, points[s:s + chunk], level_mask, n_active)
            for s in range(0, n, chunk)
        ])
