"""What a cell's entry is given and what it hands back to `run.py`."""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from benchmark.core.trace import Trace


def process_start_time() -> float:
    """`time.time()` at which this process started (Linux's /proc), or
    now where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return time.time()


@dataclasses.dataclass
class Context:
    name: str  # the cell
    config: Dict[str, Any]  # configs/<config>.json
    workload: Dict[str, Any]  # workloads/<cell>.json
    seed: int
    seconds: float
    trace: bool
    device: Any
    started: float  # time.time() at process start
    cache_dir: Path  # the program's caches, a fixed directory in the checkout

    def setup_seconds(self) -> float:
        return time.time() - self.started


@dataclasses.dataclass
class CellRun:
    attempted: int
    failed: int
    # End-to-end metrics by name: (value, unit).
    metrics: Dict[str, Tuple[float, str]]
    # The numbers that decide `correct`: (name, value, limit); each passes
    # when value <= limit.
    checks: List[Tuple[str, float, float]]
    memory_peak_bytes: int
    # The traced run's profiled window, and what the per-layer readers take
    # beside it (`layer`).
    trace: Optional[Trace] = None
    layer: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(v <= lim for _, v, lim in self.checks)


class SetupLog:
    """Prints on standard error how far set-up had got, in seconds since
    the process started, each time it is called."""

    def __init__(self, ctx: Context):
        self.ctx = ctx

    def __call__(self, what: str) -> None:
        print(f"setup: {what} at {self.ctx.setup_seconds():.3f} s",
              file=sys.stderr, flush=True)


def tuples(d: Dict[str, Any]) -> Dict[str, Any]:
    """A JSON object's lists as tuples (the configs' dataclass fields)."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def seed_words(seed: int) -> int:
    """The run's seed as a non-negative int below 2**63."""
    return int(seed) % (1 << 63)
