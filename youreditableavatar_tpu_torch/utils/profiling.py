"""Tracing, step timing, metrics logging.

Counterpart of `youreditableavatar_tpu/utils/profiling.py`:

  * `trace(logdir)` — context manager around `torch.profiler` (host and, on
    the card, CUDA activity); writes a Chrome trace `trace.json` to
    `logdir`;
  * `StepTimer` — per-step wall time that waits for the card at each mark,
    with p50/p95 summaries;
  * `MetricsLogger` — a JSONL metrics stream, line for line the JAX
    package's (+ TensorBoard when asked and installed).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from youreditableavatar_tpu_torch.utils.misc import synchronize


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; yields the `torch.profiler.profile`."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Wall-clock step timer; each mark waits for the card's queued work."""

    def __init__(self, name: str = "step"):
        self.name = name
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        synchronize()
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        """`result` is accepted for the JAX signature; every mark waits for
        all queued work."""
        synchronize()
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times[1:] or self.times)  # drop the warm-up step
        return {
            f"{self.name}_mean_ms": float(t.mean() * 1e3),
            f"{self.name}_p50_ms": float(np.percentile(t, 50) * 1e3),
            f"{self.name}_p95_ms": float(np.percentile(t, 95) * 1e3),
            f"{self.name}_steps": len(self.times),
        }


class MetricsLogger:
    """JSONL metrics writer (+ optional TensorBoard)."""

    def __init__(self, out_dir: str, use_tensorboard: bool = False):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass  # TensorBoard is optional; the JSONL stream is not
            else:
                self._tb = SummaryWriter(out_dir)

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            if isinstance(v, (str, bool)) or v is None:
                rec[k] = v
            elif np.isscalar(v) or hasattr(v, "item"):
                rec[k] = float(v)
            else:
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                try:
                    self._tb.add_scalar(k, float(v), step)
                except (TypeError, ValueError):
                    pass

    def close(self):
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
