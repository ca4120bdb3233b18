"""What the control and the planted faults are made of: each entry's
`CONTROL` and `FAULTS` are context managers under which its `run` drives
a whole run with the timed path replaced or broken underneath
(`benchmark/calibrate.py` at the cell's own size, the tests at the TEST
widths). The benchmark's own runs use none of them."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32():
    """TF32 on for matmuls and cuDNN inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@contextlib.contextmanager
def patched(owner, name: str, value):
    """`owner.name` is `value` inside the block."""
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def frozen_state(optimizer_cls):
    """`optimizer_cls` whose step leaves the parameters as they were."""
    class Frozen(optimizer_cls):
        def step(self, closure=None):
            params = [p for g in self.param_groups for p in g["params"]]
            keep = [p.detach().clone() for p in params]
            super().step(closure)
            with torch.no_grad():
                for p, k in zip(params, keep):
                    p.copy_(k)
    return Frozen
