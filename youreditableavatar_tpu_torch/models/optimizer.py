"""Per-parameter-group Adam with the 3DGS exponential position schedule.

Counterpart of `youreditableavatar_tpu/models/optimizer.py` (optax
`multi_transform` of `optax.adam` per `TetGSParams` leaf): one
`torch.optim.Adam` param group per leaf, eps 1e-15, positions at
`position_lr × spatial_lr_scale` with the log-lerp + delay schedule, and
sh_rest at feature_lr / 20. As in optax, the schedule is read at the step
count before it increments, starting at 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from youreditableavatar_tpu_torch.models.tetgs import PARAM_NAMES, TetGSParams


@dataclasses.dataclass(frozen=True)
class OptimizationParams:
    iterations: int = 15_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001


def expon_lr_schedule(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
) -> Callable[[int], float]:
    """3DGS log-lerp schedule, evaluated in f32 like the JAX version."""

    def schedule(step) -> float:
        step = torch.as_tensor(step, dtype=torch.float32)
        if lr_init == 0.0 and lr_final == 0.0:
            return 0.0
        if lr_delay_steps > 0:
            delay = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0)
            )
        else:
            delay = 1.0
        t = torch.clamp(step / max_steps, 0.0, 1.0)
        log_lerp = torch.exp(
            math.log(lr_init) * (1 - t) + math.log(lr_final) * t
        )
        return float(delay * log_lerp)

    return schedule


class TetGSOptimizer:
    """Adam over the TetGSParams leaves; sets the position lr from its
    schedule before every step."""

    def __init__(self, adam: torch.optim.Adam, pos_schedule: Callable[[int], float]):
        self.adam = adam
        self.pos_schedule = pos_schedule
        self.count = 0

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        for group in self.adam.param_groups:
            if group["name"] == "delta":
                group["lr"] = self.pos_schedule(self.count)
        self.adam.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def make_tetgs_optimizer(
    params: TetGSParams,
    opt: OptimizationParams,
    spatial_lr_scale: float,
    adam_eps: float = 1e-15,
) -> TetGSOptimizer:
    """Adam over every leaf of `params`, one param group each."""
    pos_schedule = expon_lr_schedule(
        lr_init=opt.position_lr_init * spatial_lr_scale,
        lr_final=opt.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps,
    )
    lrs = {
        "delta": pos_schedule(0),
        "log_scales": opt.scaling_lr,
        "quats": opt.rotation_lr,
        "opacity_raw": opt.opacity_lr,
        "sh_dc": opt.feature_lr,
        "sh_rest": opt.feature_lr / 20.0,
    }
    groups = [
        {"params": [getattr(params, name)], "lr": lrs[name], "name": name}
        for name in PARAM_NAMES
    ]
    adam = torch.optim.Adam(groups, eps=adam_eps)
    return TetGSOptimizer(adam, pos_schedule)
