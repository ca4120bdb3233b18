"""Name → optimizer / schedule parsing.

Counterpart of `youreditableavatar_tpu/utils/optim.py`, which builds optax
transformations by name. Here `parse_optimizer` returns a factory: call it
on the parameters to get a `torch.optim.Optimizer`. The update rules and
defaults are optax's, not torch's:
  * adam, adamw, sgd — `torch.optim.Adam`, `AdamW`, `SGD` (the same rules;
    adamw's decoupled decay defaults to 0.01 as the JAX parser passes it);
  * adagrad — optax's: the accumulator starts at 0.1 and the step is
    g / sqrt(Σg² + eps) (torch starts at 0 and adds eps outside the root);
  * rmsprop — optax's: decay 0.9, g / sqrt(ν + eps);
  * lion — optax's rule and its default decoupled decay 1e-3 (no
    `torch.optim` class exists).
`parse_scheduler` returns the optax schedule as a function of the step.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Iterable, Tuple

import torch
from torch import Tensor

OptimizerFactory = Callable[[Iterable[Tensor]], torch.optim.Optimizer]


class _Elementwise(torch.optim.Optimizer):
    """An optimizer whose update is elementwise in (param, grad, state)."""

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, p.grad, self.state[p], group)
        return loss

    def _update(self, p: Tensor, g: Tensor, state: dict, group: dict) -> None:
        raise NotImplementedError


class Adagrad(_Elementwise):
    """optax.adagrad: Σ starts at `initial_accumulator_value`;
    p -= lr · g / sqrt(Σg² + eps) (0 where Σ is 0)."""

    def __init__(self, params, lr: float, eps: float = 1e-7,
                 initial_accumulator_value: float = 0.1):
        super().__init__(params, dict(lr=lr, eps=eps,
                                      init=initial_accumulator_value))

    def _update(self, p, g, state, group):
        if not state:
            state["sum"] = torch.full_like(p, group["init"])
        s = state["sum"]
        s.add_(g * g)
        scale = torch.where(s > 0, torch.rsqrt(s + group["eps"]),
                            torch.zeros_like(s))
        p.sub_(group["lr"] * (scale * g))


class RMSprop(_Elementwise):
    """optax.rmsprop (not centred, no momentum): ν = decay·ν + (1−decay)·g²
    from 0; p -= lr · g / sqrt(ν + eps)."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    def _update(self, p, g, state, group):
        if not state:
            state["nu"] = torch.zeros_like(p)
        d = group["decay"]
        nu = (1 - d) * (g * g) + d * state["nu"]
        state["nu"] = nu
        p.sub_(group["lr"] * (torch.rsqrt(nu + group["eps"]) * g))


class Lion(_Elementwise):
    """optax.lion: u = sign((1−b1)·g + b1·m); m = b2·m + (1−b2)·g;
    p -= lr · (u + weight_decay · p)."""

    def __init__(self, params, lr: float, betas: Tuple[float, float] = (0.9, 0.99),
                 weight_decay: float = 1e-3):
        super().__init__(params, dict(lr=lr, betas=betas,
                                      weight_decay=weight_decay))

    def _update(self, p, g, state, group):
        if not state:
            state["mu"] = torch.zeros_like(p)
        b1, b2 = group["betas"]
        mu = state["mu"]
        u = torch.sign((1.0 - b1) * g + b1 * mu) + group["weight_decay"] * p
        state["mu"] = (1 - b2) * g + b2 * mu
        p.sub_(group["lr"] * u)


def parse_optimizer(
    name: str,
    lr: float,
    betas: Tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.01,
) -> OptimizerFactory:
    """Optimizer by name → a factory of `torch.optim.Optimizer`s."""
    key = name.lower().replace("_", "")
    if key == "adam":
        return functools.partial(torch.optim.Adam, lr=lr, betas=betas, eps=eps)
    if key == "adamw":
        return functools.partial(torch.optim.AdamW, lr=lr, betas=betas,
                                 eps=eps, weight_decay=weight_decay)
    if key == "sgd":
        return functools.partial(torch.optim.SGD, lr=lr)
    if key == "adagrad":
        return functools.partial(Adagrad, lr=lr, eps=eps)
    if key == "rmsprop":
        return functools.partial(RMSprop, lr=lr, eps=eps)
    if key == "lion":
        return functools.partial(Lion, lr=lr, betas=betas)
    raise ValueError(f"unknown optimizer {name!r}")


def parse_scheduler(name: str, lr: float, max_steps: int,
                    final_factor: float = 0.01) -> Callable[[int], float]:
    """Schedule by name → the learning rate as a function of the step
    (optax's `constant_schedule`, `exponential_decay`,
    `cosine_decay_schedule`, `linear_schedule`)."""
    key = name.lower()
    if key in ("constant", "none"):
        return lambda step: lr
    if key in ("exponential", "exp"):
        return lambda step: lr * final_factor ** (step / max_steps)

    def clipped(step):
        return min(max(step, 0), max_steps)

    if key == "cosine":
        def cosine(step):
            c = 0.5 * (1 + math.cos(math.pi * clipped(step) / max_steps))
            return lr * ((1 - final_factor) * c + final_factor)
        return cosine
    if key == "linear":
        end = lr * final_factor
        return lambda step: (lr - end) * (1 - clipped(step) / max_steps) + end
    raise ValueError(f"unknown scheduler {name!r}")
