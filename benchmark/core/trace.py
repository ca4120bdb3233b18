"""A short profiled window of the timed path (`torch.profiler`, CPU and
CUDA activities) and what the per-layer readers take from it.

`union_length` is a frozen copy of `chip_smoke.py:1434`; the device
intervals are read as `chip_smoke.py:1463` (`profile_window`) reads them:
device-side events only, user annotations left out, their union the busy
time, so overlapping intervals count once."""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Callable, Dict, List, Tuple


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals: overlaps and
    repeats count once."""
    total, cur_start, cur_end = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_end is None or a > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def longest_gaps(intervals, host_ops, count: int = 10):
    """The `count` longest idle gaps between device intervals, each named
    by the host operation that was running when the gap began (the
    outermost one that had started and not ended): [(name, seconds)]."""
    gaps, reach = [], None
    for a, b in sorted(intervals):
        if reach is not None and a > reach:
            gaps.append((reach, a))
        reach = b if reach is None else max(reach, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for start, end in gaps[:count]:
        name = "host"
        best = None
        for n, a, b in host_ops:
            if a <= start < b and (best is None or b - a > best):
                name, best = n, b - a
        out.append([name, (end - start) / 1e6])
    return out


@dataclasses.dataclass
class Trace:
    """What one profiled window recorded. Times in microseconds."""

    iters: int  # steps or calls inside the window
    wall_us: float  # host clock over the window, ending in a synchronize
    device: List[Tuple[str, float, float]]  # (name, start, end) on the device
    kernels: List[Tuple[str, float, float]]  # the kernel launches among them
    host_ops: List[Tuple[str, float, float]]  # top-level CPU operations

    @property
    def busy_us(self) -> float:
        return union_length([(a, b) for _, a, b in self.device])

    def kernel_time_us(self, pattern: str) -> Tuple[int, float]:
        """(launches, device µs) of the kernels whose name the regular
        expression `pattern` finds (the name may come mangled)."""
        rx = re.compile(pattern)
        hit = [(a, b) for n, a, b in self.kernels if rx.search(n)]
        return len(hit), sum(b - a for a, b in hit)

    def breakdown(self, count: int = 10) -> Dict[str, list]:
        per_name: Dict[str, float] = {}
        for n, a, b in self.device:
            per_name[n] = per_name.get(n, 0.0) + (b - a)
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:count]
        return {"device_ops": [[n, us / 1e6] for n, us in top],
                "idle_gaps": longest_gaps([(a, b) for _, a, b in self.device],
                                          self.host_ops, count)}


def profile(run: Callable[[], int]) -> Trace:
    """Profile `run()`, which runs the work and returns how many steps or
    calls it made; the window ends in a `torch.cuda.synchronize()`."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iters = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    device, kernels, host = [], [], []
    for e in prof.events():
        if e.is_user_annotation:
            continue
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == cuda:
            device.append(span)
            if not e.name.startswith(("Memcpy", "Memset")):
                kernels.append(span)
        elif e.cpu_parent is None:
            host.append(span)
    return Trace(iters, wall_us, device, kernels, host)
