"""Small shared helpers: seeded generator streams, replication checks,
timing and cleanup.

Counterpart of `youreditableavatar_tpu/utils/misc.py`. As there, parameters
start replicated by construction (every rank builds them from the same
inputs) instead of the reference's post-init ``broadcast(params, src=0)``,
and `assert_replicated` checks the invariant. Not carried over:
`apply_platform_env`, `scaled_dot_bf16` and `dtype_of`, which serve JAX's
platform selection and the TPU's bf16 matrix unit only.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor


def key_seq(seed: int, device=None) -> Iterator[torch.Generator]:
    """Infinite stream of fresh generators, the i-th seeded by (seed, i)."""
    for i in itertools.count():
        state = np.random.SeedSequence([int(seed), i]).generate_state(1)[0]
        yield torch.Generator(device=device or "cpu").manual_seed(int(state))


def _tensors(tree: Any) -> List[Tensor]:
    """The tensors of a tensor, a module, a dict or a sequence (in order)."""
    if isinstance(tree, Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def tree_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def assert_replicated(tensors: Any, group=None, atol: float = 0.0) -> None:
    """Check that every rank of `group` (the world by default) holds the
    same values: rank 0's copy of each tensor is broadcast and compared on
    every rank. Collective — every rank calls it with the same tensors — and
    every rank raises when any rank differs. A no-op outside a process
    group or in a one-rank group."""
    leaves = [t.detach() for t in _tensors(tensors)]
    if not (dist.is_initialized() and leaves) or dist.get_world_size(group) < 2:
        return
    src = dist.get_global_rank(group, 0) if group is not None else 0
    bad = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for t in leaves:
        ref = t.clone()
        dist.broadcast(ref, src=src, group=group)
        if not torch.allclose(ref, t, rtol=0.0, atol=atol, equal_nan=True):
            bad.fill_(1.0)
    dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=group)
    if bad.item() > 0:
        raise AssertionError("pytree is not replicated across devices")


def synchronize() -> None:
    """Wait for the work queued on the card, if this process uses one."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(label: str, sink: Optional[Dict[str, float]] = None):
    """Wall-clock timer that waits for the card's queued work at exit."""
    t0 = time.perf_counter()
    yield
    synchronize()
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[label] = dt


def cleanup() -> None:
    """Free host garbage and the CUDA caching allocator's unused blocks
    between pipeline stages (the reference's `cleanup()`); live tensors are
    untouched."""
    import gc

    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
