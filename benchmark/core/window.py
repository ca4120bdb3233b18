"""The measured window, and the statistics the end-to-end metrics take
from it.

Two loops, both closed (the next step or call starts when the last has
ended):
  * `step_window` — steps until `seconds` have passed; the window starts at
    the first step's call and ends at a `torch.cuda.synchronize()` after
    the last. Each step's duration comes from CUDA events recorded on the
    stream at the step boundaries, read once after the window.
  * `call_window` — whole calls: the next call starts only if the last
    call's duration still fits before `seconds` (the first always does);
    the window ends with the last call."""

from __future__ import annotations

import math
import time
from typing import Callable, List, Tuple

# Fewest steps in a window for its 90th percentile to have ten samples
# beyond it.
P90_MIN_STEPS = 100


class _Marks:
    """Step boundaries: CUDA events on the stream on a card (read once
    after the window), the host clock elsewhere (the CPU tests)."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def sync(self):
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def mark(self):
        if self.cuda:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def durations_ms(self) -> List[float]:
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


def step_window(step: Callable[[int], object], seconds: float,
                device) -> Tuple[float, List[float]]:
    """Run `step(i)` for i = 0, 1, … until `seconds` have passed →
    (window seconds, per-step milliseconds)."""
    marks = _Marks(device)
    marks.sync()
    t0 = time.perf_counter()
    marks.mark()
    i = 0
    while True:
        step(i)
        i += 1
        marks.mark()
        if time.perf_counter() - t0 >= seconds:
            break
    marks.sync()
    return time.perf_counter() - t0, marks.durations_ms()


def call_window(call: Callable[[int], object], seconds: float,
                device) -> Tuple[float, int]:
    """Run whole calls `call(i)` while the next still fits → (window
    seconds to the end of the last call, calls made)."""
    marks = _Marks(device)
    marks.sync()
    t0 = time.perf_counter()
    n = 0
    while True:
        c0 = time.perf_counter()
        call(n)
        marks.sync()
        n += 1
        end = time.perf_counter()
        if (end - t0) + (end - c0) > seconds:
            break
    return time.perf_counter() - t0, n


def step_ms(window_s: float, steps: int) -> float:
    """The whole window over the steps it completed, in ms."""
    return window_s * 1e3 / steps


def p90(values: List[float]):
    """Nearest-rank 90th percentile, or None for fewer than
    P90_MIN_STEPS values."""
    if len(values) < P90_MIN_STEPS:
        return None
    ordered = sorted(values)
    return ordered[math.ceil(0.9 * len(ordered)) - 1]
