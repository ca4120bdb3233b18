"""CUDA graphs of differentiable functions: forward and backward captured
once, then replayed with the host out of the way.

`GraphedChain` is `torch.cuda.make_graphed_callables` for a chain of plain
functions of tensors that read some leaves (parameters) besides their
arguments, as one step calls them: function 0's forward, …, function N−1's
forward, then the backwards in reverse order, which autograd keeps. The
forwards are captured in that order and the backwards in reverse, into one
memory pool, so a replay reuses memory only as the capture did. Beyond
`make_graphed_callables`:

  * an argument of function i may be made from the outputs of function
    i − 1 (the warm-up's), so a chain's later functions warm up on real
    values;
  * an output the eager function gives without gradient (integer, or made
    under `no_grad`) comes back marked non-differentiable, as eagerly;
  * each graph's launches of the port's kernels are taken at its capture
    and added to `_kernels.LAUNCHES` at each replay, so the counts stay
    per call; the warm-up's and the capture's own launches are not
    counted;
  * `_kernels.GRAPHS["captured"]` counts the functions captured,
    `["replayed"]` the forward replays.

Each replay copies its arguments into the graph's static inputs (device
copies; an argument that already lies there is not copied). The outputs
are the graph's static outputs: the next replay of the same chain
overwrites them, so a caller copies out what it keeps longer. The leaves
must keep their storage (in-place updates, as an optimizer makes, are
what the graphs read). Autocast must be off.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor
from torch.utils import _pytree as pytree

from youreditableavatar_tpu_torch import _kernels

WARMUP_ITERS = 2  # eager forward + backward passes before the captures

Args = Union[Tuple, Callable[[Any], Tuple]]


def _static_copy(t: Tensor) -> Tensor:
    """A static input: a copy of `t`, a leaf that requires grad where `t`
    does."""
    s = t.detach().clone()
    return s.requires_grad_() if t.requires_grad else s


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before[k] for k, n in _kernels.LAUNCHES.items()
            if n != before[k]}


class _Part:
    """One function's graphs, static tensors and launch counts."""

    def __init__(self, fn: Callable, static_in: List[Tensor], spec):
        self.fn = fn
        self.static_in = static_in
        self.in_spec = spec
        self.fwd = torch.cuda.CUDAGraph()
        self.bwd = torch.cuda.CUDAGraph()
        self.static_out: Tuple[Tensor, ...] = ()
        self.out_grad: Tuple[bool, ...] = ()  # which outputs take gradients
        self.out_spec = None
        self.grad_out: Tuple[Optional[Tensor], ...] = ()
        self.grad_in: Tuple[Optional[Tensor], ...] = ()
        self.fwd_launches: Dict[str, int] = {}
        self.bwd_launches: Dict[str, int] = {}

    def call(self):
        return self.fn(*pytree.tree_unflatten(self.static_in, self.in_spec))


def _add(launches: Dict[str, int]) -> None:
    for k, n in launches.items():
        _kernels.LAUNCHES[k] += n


class _Replay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part: _Part, leaves_start: int, *inputs):
        for s, x in zip(part.static_in, inputs[:leaves_start]):
            if s.data_ptr() != x.data_ptr():
                s.copy_(x)
        part.fwd.replay()
        _add(part.fwd_launches)
        _kernels.GRAPHS["replayed"] += 1
        ctx.part = part
        out = tuple(o.detach() for o in part.static_out)
        ctx.mark_non_differentiable(*(o for o, g in zip(out, part.out_grad)
                                      if not g))
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        part = ctx.part
        for buf, g in zip(part.grad_out, grads):
            if buf is not None and buf.data_ptr() != g.data_ptr():
                buf.copy_(g)
        part.bwd.replay()
        _add(part.bwd_launches)
        return (None, None) + tuple(
            None if g is None else g.detach() for g in part.grad_in)


class GraphedChain:
    """`fns[i]`, called on the tensors of `args[i]` (a tuple, or for i > 0
    a function of the outputs of `fns[i − 1]` that returns one), captured
    forward and backward on their CUDA device. `leaves` are the tensors
    the functions read that take gradients and are not arguments; each
    function has an output that takes a gradient.
    `chain(i, *args)` replays function i on new arguments of the same
    shapes and returns its outputs, differentiable as the eager ones."""

    def __init__(self, fns: Sequence[Callable], args: Sequence[Args],
                 leaves: Sequence[Tensor]):
        self.leaves = tuple(leaves)
        counted = dict(_kernels.LAUNCHES)
        try:
            self.parts = self._warm_up(fns, args)
            self._capture()
        finally:
            _kernels.LAUNCHES.update(counted)
        _kernels.GRAPHS["captured"] += len(self.parts)

    def _warm_up(self, fns, args) -> List[_Part]:
        """Static inputs from the sample arguments, and WARMUP_ITERS eager
        passes on a side stream, which build and initialise what the
        functions launch before any capture."""
        parts: List[_Part] = []
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = None
            for fn, a in zip(fns, args):
                a = a(out) if callable(a) else a
                flat, spec = pytree.tree_flatten(tuple(a))
                part = _Part(fn, [_static_copy(t) for t in flat], spec)
                parts.append(part)
                for _ in range(WARMUP_ITERS):
                    out = part.call()
                    self._grads(part, pytree.tree_leaves(out),
                                [torch.zeros_like(o)
                                 for o in pytree.tree_leaves(out)
                                 if o.requires_grad])
        torch.cuda.synchronize()
        return parts

    def _grads(self, part: _Part, outs: Sequence[Tensor],
               grad_outs: Sequence[Tensor]):
        diff = [o for o in outs if o.requires_grad]
        wrt = [t for t in list(part.static_in) + list(self.leaves)
               if t.requires_grad]
        return torch.autograd.grad(diff, wrt, grad_outs, allow_unused=True)

    def _capture(self) -> None:
        pool = torch.cuda.graph_pool_handle()
        for part in self.parts:
            before = dict(_kernels.LAUNCHES)
            with torch.cuda.graph(part.fwd, pool=pool):
                out = part.call()
            part.fwd_launches = _launches_since(before)
            flat, part.out_spec = pytree.tree_flatten(out)
            part.static_out = tuple(flat)
        for part in reversed(self.parts):
            part.grad_out = tuple(torch.empty_like(o) if o.requires_grad
                                  else None for o in part.static_out)
            before = dict(_kernels.LAUNCHES)
            with torch.cuda.graph(part.bwd, pool=pool):
                grads = iter(self._grads(
                    part, part.static_out,
                    [g for g in part.grad_out if g is not None]))
            part.bwd_launches = _launches_since(before)
            part.grad_in = tuple(
                next(grads) if t.requires_grad else None
                for t in list(part.static_in) + list(self.leaves))
        # Let the capture's autograd graph go: kept, its nodes would hold
        # the leaves' gradient accumulators of the side streams, and every
        # backward would then sync those streams with its own.
        for part in self.parts:
            part.out_grad = tuple(o.requires_grad for o in part.static_out)
            part.static_out = tuple(o.detach() for o in part.static_out)

    def __call__(self, i: int, *args):
        part = self.parts[i]
        flat = pytree.tree_leaves(tuple(args))
        if len(flat) != len(part.static_in):
            raise ValueError(f"function {i} was captured with "
                             f"{len(part.static_in)} tensors, called with "
                             f"{len(flat)}")
        out = _Replay.apply(part, len(flat), *flat, *self.leaves)
        return pytree.tree_unflatten(list(out), part.out_spec)
