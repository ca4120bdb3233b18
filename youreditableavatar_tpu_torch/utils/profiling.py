"""Tracing, program spans, metrics logging.

Counterpart of `youreditableavatar_tpu/utils/profiling.py`:

  * `trace(logdir)` — context manager around `torch.profiler` (host and, on
    the card, CUDA activity) under `recording()`; writes a Chrome trace
    `trace.json`, in which each span sits over its kernels and gaps, and
    the spans' records `spans.json` to `logdir`;
  * `span(name)` — a named stretch of the program (a step, a stage of it,
    a network's call). Off, it is one shared no-op context; armed — under
    `recording()` or under any running `torch.profiler` — it records the
    host interval, its parent and root span and, where CUDA is
    initialised, a pair of timing events on the current stream. It adds no
    host synchronisation; `take_spans()` reads the events;
  * `count(name, n)` — a program counter (work done, bytes moved). Off,
    it is one bool test; inside a `counting()` block it adds `n` to the
    block's `collections.Counter` (and to every enclosing block's). A
    count that costs work to compute (a tensor on the device, which
    stays there until the counter is read) is taken only where
    `is_counting()` says so.
    `to_device` / `to_host` move a caller's data either way and count
    the bytes they copy (`to_device` does not wait for the stream);
  * `MetricsLogger` — a JSONL metrics stream, line for line the JAX
    package's (+ TensorBoard when asked and installed).

Not carried over: `StepTimer`, whose every mark waited for the card.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Any, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from youreditableavatar_tpu_torch.utils.misc import synchronize


@dataclasses.dataclass(frozen=True)
class Span:
    """One span as `take_spans()` returns it. `parent` and `root` index the
    list it came in (`parent` -1 for a root; a root is its own `root`).
    Host times are `time.perf_counter_ns()`, taken just before each of the
    span's two event records; `device_ms` is the stream time between them
    (None without CUDA)."""

    name: str
    parent: int
    root: int
    thread: int
    host_start_ns: int
    host_end_ns: int
    device_ms: Optional[float]


class _Record:
    __slots__ = ("name", "parent", "root", "thread", "host_start_ns",
                 "host_end_ns", "events")

    def __init__(self, name, parent, thread):
        self.name = name
        self.parent = parent
        self.root = self if parent is None else parent.root
        self.thread = thread
        self.host_start_ns = self.host_end_ns = None
        self.events = None


class _Recorder:
    """The process's span records, the per-thread stacks of open spans and
    how many `recording()` blocks are open."""

    def __init__(self):
        self.records: List[_Record] = []
        self.lock = threading.Lock()
        self.local = threading.local()
        self.recording = 0

    def stack(self) -> List[_Record]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_RECORDER = _Recorder()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("record", "annotation")

    def __init__(self, name: str):
        stack = _RECORDER.stack()
        self.record = _Record(name, stack[-1] if stack else None,
                              threading.get_ident())
        # Only the operator's recording annotates: under a profiler that
        # somebody else started, the caller's host-op tree stays as it was.
        self.annotation = (torch.profiler.record_function(name)
                           if _RECORDER.recording else None)

    def __enter__(self):
        rec = self.record
        with _RECORDER.lock:
            _RECORDER.records.append(rec)
        _RECORDER.stack().append(rec)
        if self.annotation is not None:
            self.annotation.__enter__()
        if torch.cuda.is_initialized():
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
        rec.host_start_ns = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[0].record()
        return self

    def __exit__(self, *exc):
        rec = self.record
        rec.host_end_ns = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _RECORDER.stack().pop()
        return False


def span(name: str):
    """A context manager around one named stretch of the program; the
    shared no-op context unless `recording()` is open or a torch profiler
    runs."""
    if not (_RECORDER.recording or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def recording():
    """Arm the spans for an operator's own trace: each span is recorded
    and also entered as `torch.profiler.record_function(name)`."""
    with _RECORDER.lock:
        _RECORDER.recording += 1
    try:
        yield
    finally:
        with _RECORDER.lock:
            _RECORDER.recording -= 1


def take_spans() -> List[Span]:
    """The spans recorded since the last call, in the order they were
    entered, with their device milliseconds; clears the records. Waits
    for the card where a span recorded events. Take them when no span is
    open: a parent already taken reads as -1."""
    with _RECORDER.lock:
        records, _RECORDER.records = _RECORDER.records, []
    if any(r.events is not None for r in records):
        synchronize()
    index = {id(r): i for i, r in enumerate(records)}
    out = []
    for r in records:
        ms = (r.events[0].elapsed_time(r.events[1])
              if r.events is not None else None)
        parent = -1 if r.parent is None else index.get(id(r.parent), -1)
        out.append(Span(r.name, parent, index.get(id(r.root), -1), r.thread,
                        r.host_start_ns, r.host_end_ns, ms))
    return out


_COUNTERS: List[collections.Counter] = []


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` of every open `counting()` block; nothing
    when none is open. `n` may be a 0-d tensor on the device: the counter
    then holds a tensor, and the host waits only where it is read."""
    if _COUNTERS:
        for c in _COUNTERS:
            c[name] += n


def is_counting() -> bool:
    """Whether a `counting()` block is open: the guard of a count whose
    `n` costs work to compute."""
    return bool(_COUNTERS)


@contextlib.contextmanager
def counting():
    """Yield a `collections.Counter` that the program's `count()` calls
    inside the block add to (from any thread)."""
    counter = collections.Counter()
    with _RECORDER.lock:
        _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        with _RECORDER.lock:
            _COUNTERS[:] = [c for c in _COUNTERS if c is not counter]


def to_device(data, device, dtype=None) -> torch.Tensor:
    """`data`, a host array or a tensor, as a tensor on `device` (cast to
    `dtype` where given): the one place a caller's data is moved to the
    device. A copy from the host counts its bytes as `h2d_bytes`; to a
    CUDA device it goes through pinned memory and does not wait for the
    stream, so the host keeps queueing work behind it."""
    device = torch.device(device)
    if torch.is_tensor(data) and (data.device.type != "cpu"
                                  or device.type == "cpu"):
        # Already on a device (or a host tensor for the host): no upload.
        return data.detach().to(device=device, dtype=dtype)
    # Copied only where it is not contiguous or not writable (a torch
    # tensor cannot share a read-only array).
    host = torch.as_tensor(np.require(data, requirements="CW"))
    if dtype is not None:
        host = host.to(dtype)
    count("h2d_bytes", host.numel() * host.element_size())
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.clone().to(device)


def to_host(data) -> np.ndarray:
    """`data`, a tensor or a host array, as a host array; a tensor's
    bytes are counted as `d2h_bytes`."""
    if not torch.is_tensor(data):
        return np.asarray(data)
    count("d2h_bytes", data.numel() * data.element_size())
    return data.detach().cpu().numpy()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block under `recording()`; yields the
    `torch.profiler.profile`. Writes `trace.json` (Chrome) and the spans
    recorded inside the block, `spans.json`, to `logdir`."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    take_spans()  # only the block's own spans go to spans.json
    with recording(), profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as fh:
        json.dump([dataclasses.asdict(s) for s in take_spans()], fh)


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
