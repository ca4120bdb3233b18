# Frozen copy of youreditableavatar_tpu_torch/ops/hashgrid.py (the plain PyTorch path only).
"""Multiresolution hash-grid encoding (replaces tiny-cuda-nn's HashGrid).

Counterpart of `youreditableavatar_tpu/ops/hashgrid.py`: 16 levels × 2
features, 2^19 table, base res 16, growth 1.3819, and the progressive level
curriculum (`progressive_level_mask`).

The encoding is a `torch.autograd.Function`, the counterpart of the JAX
custom VJP:
  * forward — plain tensor indexing gathers the 8 corner rows per level
    (the JAX XLA gather) and keeps the (la, N, 8, F) corner features for
    the backward;
  * backward — the point gradient from the elementwise trilinear formulas
    (zero where x was clipped), and the table gradient through
    `hashgrid_cuda.hash_scatter_add` (K4: `csrc/hash_scatter.cu` on CUDA
    tensors, `index_add_` on CPU tensors) for the production width
    `n_features_per_level == 2`, or `index_add_` for other widths — the JAX
    package's exact gate between its Pallas and XLA paths. `level_mask`
    gets no gradient.

`n_active` (a Python int) computes only the first n levels and zero-fills
the rest, exactly as the masked curriculum would.

The JAX backend switch (`backend=`, `YEA_HASHGRID_BACKEND`) is not carried
over: the tensors' device picks the implementation, and `backend` is
accepted and ignored.

Corner ids use int64 arithmetic with each product masked to 32 bits, so
hashed levels give the same ids as the JAX uint32 hash bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import Tensor


# Spatial hashing primes (instant-ngp convention; the first "prime" is 1 so
# axis 0 indexes linearly).
_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.381912879967776
    # Progressive curriculum on by default (ProgressiveBandHashGrid with
    # start_level 8).
    progressive: bool = True
    start_level: int = 8
    start_step: int = 0
    update_steps: int = 1000

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    def level_resolutions(self) -> list[int]:
        return [
            int(self.base_resolution * self.per_level_scale**lvl)
            for lvl in range(self.n_levels)
        ]




def _hash_corner(coords: Tensor, res: int, table_size: int) -> Tensor:
    """Integer corner coords (..., 3) → int64 table index."""
    c = coords.to(torch.int64)
    if (res + 1) ** 3 <= table_size:
        # Dense indexing when the level fits.
        return c[..., 0] + c[..., 1] * (res + 1) + c[..., 2] * (res + 1) ** 2
    h = ((c[..., 0] * _PRIMES[0]) & _U32) ^ ((c[..., 1] * _PRIMES[1]) & _U32) \
        ^ ((c[..., 2] * _PRIMES[2]) & _U32)
    return h % table_size


_OFFSETS = tuple(
    (i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)
)


def _level_corners(x: Tensor, res: int, table_size: int):
    """Per-level corner data: idx (N,8), per-axis weight factors
    wx/wy/wz (N,8)."""
    offsets = torch.tensor(_OFFSETS, dtype=torch.int64, device=x.device)
    xs = x * res
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, res - 1)
    w = xs - x0.to(torch.float32)  # (N, 3)
    corners = x0[:, None, :] + offsets[None, :, :]
    idx = _hash_corner(corners, res, table_size)
    one = offsets[None] == 1  # (1, 8, 3)
    wx = torch.where(one[..., 0], w[:, None, 0], 1 - w[:, None, 0])
    wy = torch.where(one[..., 1], w[:, None, 1], 1 - w[:, None, 1])
    wz = torch.where(one[..., 2], w[:, None, 2], 1 - w[:, None, 2])
    return idx, wx, wy, wz


def _encode_plain(params: Tensor, x: Tensor, cfg: HashGridConfig,
                  level_mask: Optional[Tensor], want_residuals: bool = False,
                  n_active: Optional[int] = None):
    """Gather path; optionally also the (la, N, 8, F) corner features."""
    la = cfg.n_levels if n_active is None else n_active
    x = torch.clamp(x, 0.0, 1.0)
    n = x.shape[0]
    feats, cfs = [], []
    for lvl, res in enumerate(cfg.level_resolutions()[:la]):
        idx, wx, wy, wz = _level_corners(x, res, cfg.table_size)
        cf = params[lvl][idx]  # (N, 8, F)
        weight = wx * wy * wz  # (N, 8)
        feats.append(torch.sum(cf * weight[..., None], dim=1))  # (N, F)
        if want_residuals:
            cfs.append(cf)
    out = torch.stack(feats, dim=1)  # (N, la, F)
    if level_mask is not None:
        out = out * level_mask[None, :la, None]
    if la < cfg.n_levels:
        pad = out.new_zeros((n, cfg.n_levels - la, cfg.n_features_per_level))
        out = torch.cat([out, pad], dim=1)
    out = out.reshape(n, cfg.out_dim)
    if want_residuals:
        return out, torch.stack(cfs)
    return out


def hashgrid_encode(
    params: Tensor,
    x: Tensor,
    cfg: HashGridConfig,
    level_mask: Optional[Tensor] = None,
    backend: Optional[str] = None,
    n_active: Optional[int] = None,
) -> Tensor:
    """Encode positions with the multiresolution hash grid.

    Args:
      params: (L, T, F) table.
      x: (N, 3) positions in [0, 1]³ (callers contract to this range).
      cfg: static config.
      level_mask: optional (L,) float mask for the progressive curriculum.
      backend: ignored (the tensors' device picks the implementation).
      n_active: count of progressive levels to compute (exact — masked
        levels give zero features and zero table gradients either way).
    Returns:
      (N, L*F) features.
    """
    del backend
    if level_mask is not None:
        level_mask = level_mask.to(device=x.device, dtype=torch.float32)
    # Autograd differentiates the gather itself: no hand-written backward.
    return _encode_plain(params, x, cfg, level_mask, n_active=n_active)


def progressive_level_mask(cfg: HashGridConfig,
                           global_step: Union[int, Tensor],
                           device=None) -> Tensor:
    """(L,) 0/1 mask for the level curriculum."""
    if not cfg.progressive:
        return torch.ones((cfg.n_levels,), dtype=torch.float32, device=device)
    step = int(global_step)
    current = min(cfg.start_level
                  + max(step - cfg.start_step, 0) // cfg.update_steps,
                  cfg.n_levels)
    return (torch.arange(cfg.n_levels, device=device)
            < current).to(torch.float32)
