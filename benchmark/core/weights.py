"""Random weights drawn on the card from the run's seed, in a few large
calls: blocks of N(0, 1) draws from one `torch.Generator` on the device,
handed out as views leaf by leaf (`take`). The inits of
`benchmark/reference` draw through `Pool.take` when given a pool."""

from __future__ import annotations

import math

import torch

BLOCK = 1 << 28  # draws per call: 1 GiB of f32


class Pool:
    def __init__(self, seed: int, device, block: int = BLOCK):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.block = block
        self._buf = None
        self._used = 0

    def take(self, shape) -> torch.Tensor:
        n = math.prod(shape)
        if self._buf is None or self._used + n > self._buf.numel():
            self._buf = torch.randn(max(self.block, n), generator=self.generator,
                                    device=self.device)
            self._used = 0
        out = self._buf[self._used:self._used + n].view(tuple(shape))
        self._used += n
        return out

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        """U(lo, hi) draws, from the normal block through the normal CDF."""
        z = self.take(shape)
        return lo + (hi - lo) * 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
