"""Pair-budget sizing + overflow governance.

Counterpart of `youreditableavatar_tpu/ops/gaussian_raster/budget.py`: an
exact count pre-pass (`count_pairs`), bucketed budget growth
(`fit_pair_budget`) and a runtime governor (`BudgetGovernor`) that grows
the budget or fails loudly instead of training on truncated renders.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import torch


class PairOverflowError(RuntimeError):
    """A render exceeded its static pair budget (or tile capacity)."""


def count_pairs(means3d, scales, quats, opacities, sh, camera, cfg) -> torch.Tensor:
    """Exact (gaussian, tile) pair total for a scene + camera: () int32.

    Equals `render_gaussians(...)["num_pairs"]` but runs only preprocess.
    """
    from youreditableavatar_tpu_torch.ops.gaussian_raster.preprocess import (
        preprocess_gaussians,
    )

    with torch.no_grad():
        proj = preprocess_gaussians(
            means3d, scales, quats, opacities,
            sh if sh is not None else torch.zeros(
                (means3d.shape[0], 1, 3), device=means3d.device),
            camera, cfg.sh_degree, cfg.tile_size, cfg.scale_mod, None,
            rect_mode=cfg.rect_mode,
        )
        return torch.sum(proj.tiles_touched, dtype=torch.int32)


def fit_pair_budget(
    n_pairs: int,
    headroom: float = 1.2,
    min_budget: int = 1 << 12,
    max_budget: int = 1 << 24,
    align: int = 128,
) -> int:
    """Smallest bucket of the ladder {2^k, 1.5·2^k} ≥ n_pairs·headroom,
    rounded up to an `align` multiple."""
    need = max(int(float(n_pairs) * headroom), min_budget)
    if need > max_budget:
        raise PairOverflowError(
            f"required pair budget {need} exceeds max_budget {max_budget}"
        )
    b = min_budget
    while b < need:
        b = b * 3 // 2 if (b & (b - 1)) == 0 else b * 4 // 3
    return -(-b // align) * align


@dataclasses.dataclass
class BudgetGovernor:
    """Watches render diagnostics; grows budgets or fails loudly.

    Policies: "grow" (return a config with the next-bucket budget and, on
    tile overflow, doubled tile_capacity), "raise", or "warn".
    """

    policy: str = "grow"
    headroom: float = 1.2
    max_budget: int = 1 << 24
    name: str = "raster"
    events: list = dataclasses.field(default_factory=list)

    def check(self, cfg: Any, num_pairs: int, num_tile_overflow: int = 0,
              step: Optional[int] = None) -> Optional[Any]:
        num_pairs = int(num_pairs)
        num_tile_overflow = int(num_tile_overflow)
        pair_over = num_pairs > cfg.pair_budget
        if not pair_over and num_tile_overflow == 0:
            return None
        msg = (
            f"[{self.name}] overflow at step {step}: num_pairs={num_pairs} "
            f"(budget {cfg.pair_budget}), tile_overflow={num_tile_overflow} "
            f"(capacity {cfg.tile_capacity})"
        )
        self.events.append(
            {"step": step, "num_pairs": num_pairs,
             "pair_budget": cfg.pair_budget,
             "num_tile_overflow": num_tile_overflow,
             "tile_capacity": cfg.tile_capacity, "policy": self.policy}
        )
        if self.policy == "raise":
            raise PairOverflowError(msg)
        if self.policy == "warn":
            warnings.warn(msg + " — rendering truncated", RuntimeWarning)
            return None
        if self.policy != "grow":
            raise ValueError(f"unknown overflow policy {self.policy!r}")
        new_budget = cfg.pair_budget
        if pair_over:
            new_budget = fit_pair_budget(
                num_pairs, headroom=self.headroom, max_budget=self.max_budget,
            )
        new_capacity = cfg.tile_capacity * (2 if num_tile_overflow else 1)
        return dataclasses.replace(
            cfg, pair_budget=new_budget, tile_capacity=new_capacity
        )
