"""The program's spans in a traced run's profiled window, and what the
span readers (`benchmark/metrics/*_ms.py`) take from them.

The port records a span (`youreditableavatar_tpu_torch.utils.profiling
.span`) wherever a torch profiler runs, and adds no annotation to a
profiler it did not start; so the spans taken after the window are the
window's, and the trace's host-op tree is what it was without them. Each
span holds its host interval and the stream time between its two CUDA
events (`device_ms`). A root span is one step or call; the readers read
nothing unless the window holds one root per step or call.

Idle charged to spans: each span's two events are made by top-level
`cudaEventRecord` (`cudaEventRecordWithFlags`) calls, which the trace
lists among its host ops on its own clock. The shift between the host's
clock and the trace's is the one that lines up the most of those calls
with the events' host times; most events must line up, else nothing is
charged. Each idle instant of the device (the window less
the union of its intervals) goes to the root's child span that the host
was in then; idle while the host was in a root but in none
of its children, or in no root, goes to the root's own time ("self")."""

from __future__ import annotations

import bisect
import statistics
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

# The SDS step's stages; the rest of `edit.step` (`edit.prepare`,
# `edit.record`, the root's own time, the gaps between steps) is glue.
STAGES = ("edit.render", "edit.guidance", "edit.losses", "edit.backward",
          "edit.optimizer")
SELF = ""
# The runtime call a `torch.cuda.Event.record` makes, by CUDA version.
RECORD_CALLS = ("cudaEventRecord", "cudaEventRecordWithFlags")
# An event lines up with a record call that starts within MATCH_US of its
# host time on the trace's clock; more than MATCH_SHARE of them must, or
# no idle is charged: a shift that lines up most events is the clocks',
# not a chance one. Not all can: the profiler nests an odd record call
# under another host op, and a host pause can fall between an event's
# host time and its call (95–100 of 100 lined up in the SDS windows on
# the H100).
MATCH_US = 250.0
MATCH_SHARE = 0.5


def _say(what: str) -> None:
    print(f"spans: {what}", file=sys.stderr)


def _take():
    try:
        from youreditableavatar_tpu_torch.utils.profiling import take_spans
    except ImportError:
        return None
    return take_spans()


def _checked(found, iters: int) -> Optional[list]:
    if not found:
        _say("the program recorded none in the window")
        return None
    roots = sum(s.parent == -1 for s in found)
    if roots != iters:
        _say(f"{roots} root spans in a window of {iters} steps or calls: "
             f"none read")
        return None
    if any(s.device_ms is None for s in found):
        _say("spans without CUDA events: none read")
        return None
    return found


def spans(run) -> Optional[list]:
    """The window's spans (taken once, kept on the run), or None: without
    a trace, on a program that records none, or where the roots are not
    one per step or call."""
    if run.trace is None:
        return None
    if "spans" not in run.layer:
        run.layer["spans"] = _checked(_take(), run.trace.iters)
        if run.layer["spans"] is not None:
            report(run)
    return run.layer["spans"]


def device_ms(run, names: Sequence[str]) -> Optional[float]:
    """The device ms of the spans of these names, per step or call."""
    found = spans(run)
    if found is None:
        return None
    return sum(s.device_ms for s in found if s.name in names) / run.trace.iters


def glue_ms(run) -> Optional[float]:
    """The roots' device ms less that of their STAGES children, per step:
    `edit.prepare`, `edit.record` and the root's own time."""
    found = spans(run)
    if found is None:
        return None
    roots = sum(s.device_ms for s in found if s.parent == -1)
    stages = sum(s.device_ms for s in found if s.parent >= 0
                 and s.name in STAGES and found[s.parent].parent == -1)
    return (roots - stages) / run.trace.iters


def _shift(hosts: List[float], calls: List[float]) -> float:
    """The trace clock less the host clock (µs): the median of the densest
    MATCH_US-wide cluster of call − event differences, over the pairs whose
    places in the two sorted lists differ by at most the lists' lengths
    do, plus one."""
    k = abs(len(hosts) - len(calls)) + 1
    d = sorted(c - hosts[i] for j, c in enumerate(calls)
               for i in range(max(0, j - k), min(len(hosts), j + k + 1)))
    best, lo, a = 0, 0, 0
    for b in range(len(d)):
        while d[b] - d[a] > MATCH_US:
            a += 1
        if b - a + 1 > best:
            best, lo = b - a + 1, a
    return statistics.median(d[lo:lo + best])


def _placed(run, found) -> Optional[List[List[float]]]:
    """Each span's host [start, end] on the trace's clock (µs), or None
    where too few of its events line up with an event record."""
    calls = sorted(a for n, a, _ in run.trace.host_ops if n in RECORD_CALLS)
    hosts = sorted(ns / 1e3 for s in found
                   for ns in (s.host_start_ns, s.host_end_ns))
    if not calls:
        _say("no top-level event record in the trace: idle not charged")
        return None
    shift = _shift(hosts, calls)
    lined = 0
    for h in hosts:
        k = bisect.bisect_left(calls, h + shift)
        near = [calls[j] for j in (k - 1, k) if 0 <= j < len(calls)]
        lined += min(abs(c - h - shift) for c in near) <= MATCH_US
    _say(f"{lined} of {len(hosts)} span events line up with one of "
         f"{len(calls)} top-level event records (trace clock = host clock "
         f"+ {shift:.1f} us)")
    if lined <= MATCH_SHARE * len(hosts):
        _say("too few: idle not charged")
        return None
    return [[s.host_start_ns / 1e3 + shift, s.host_end_ns / 1e3 + shift]
            for s in found]


def _idle_gaps(trace):
    """The device's idle intervals inside the window: the span of every
    host op and device interval, less the union of the device's."""
    every = trace.host_ops + trace.device
    starts, ends = [a for _, a, _ in every], [b for _, _, b in every]
    gaps, reach = [], min(starts)
    for a, b in sorted((a, b) for _, a, b in trace.device):
        if a > reach:
            gaps.append((reach, a))
        reach = max(reach, b)
    if max(ends) > reach:
        gaps.append((reach, max(ends)))
    return gaps


def idle_by_span(run) -> Optional[Dict[int, float]]:
    """Idle µs charged to each child of a root (by index), and to SELF
    for the rest; None where the spans cannot be placed."""
    if "span_idle" in run.layer:
        return run.layer["span_idle"]
    found = spans(run)
    placed = _placed(run, found) if found is not None else None
    if placed is None:
        run.layer["span_idle"] = None
        return None
    children = [i for i, s in enumerate(found)
                if s.parent >= 0 and found[s.parent].parent == -1]
    cuts = sorted({x for i in children for x in placed[i]})
    # The innermost child over each piece between two cuts: the one that
    # began last among those covering it (children of one thread nest).
    owner = []
    for lo, hi in zip(cuts, cuts[1:]):
        over = [i for i in children
                if placed[i][0] <= lo and hi <= placed[i][1]]
        owner.append(max(over, key=lambda i: placed[i][0]) if over else SELF)
    charged: Dict = defaultdict(float)
    for a, b in _idle_gaps(run.trace):
        charged[SELF] += b - a
        k = max(bisect.bisect_right(cuts, a) - 1, 0)
        while k < len(owner) and cuts[k] < b:
            part = min(b, cuts[k + 1]) - max(a, cuts[k])
            if part > 0 and owner[k] != SELF:
                charged[owner[k]] += part
                charged[SELF] -= part
            k += 1
    run.layer["span_idle"] = dict(charged)
    return run.layer["span_idle"]


def idle_ms(run, names: Sequence[str]) -> Optional[float]:
    """Idle ms per step or call charged to the root's children of these
    names."""
    charged = idle_by_span(run)
    if charged is None:
        return None
    found = run.layer["spans"]
    return sum(us for i, us in charged.items()
               if i != SELF and found[i].name in names) / 1e3 / run.trace.iters


def glue_idle_ms(run) -> Optional[float]:
    """Idle ms per step charged to anything but the STAGES spans."""
    charged = idle_by_span(run)
    if charged is None:
        return None
    stages = idle_ms(run, STAGES) * run.trace.iters * 1e3
    return (sum(charged.values()) - stages) / 1e3 / run.trace.iters


def report(run) -> None:
    """One table per root on standard error: for each name among its
    children, the count, device ms, host ms and idle ms charged."""
    found = run.layer["spans"]
    charged = idle_by_span(run) or {}
    for r, root in enumerate(found):
        if root.parent != -1:
            continue
        rows: Dict[str, List[float]] = {}
        for i, s in enumerate(found):
            if s.parent == r:
                row = rows.setdefault(s.name, [0, 0.0, 0.0, 0.0])
                row[0] += 1
                row[1] += s.device_ms
                row[2] += (s.host_end_ns - s.host_start_ns) / 1e6
                row[3] += charged.get(i, 0.0) / 1e3
        host = (root.host_end_ns - root.host_start_ns) / 1e6
        _say(f"root {r} {root.name}: device {root.device_ms:.3f} ms, "
             f"host {host:.3f} ms")
        for name, (n, dev, hst, idle) in rows.items():
            _say(f"  {name:<16} x{n:<3} device {dev:9.3f}  host {hst:9.3f}  "
                 f"idle {idle:8.3f}" + ("" if charged else " (not charged)"))
    if charged:
        t = run.trace
        window_idle = (t.wall_us - t.busy_us) / 1e3
        _say(f"idle charged {sum(charged.values()) / 1e3:.3f} ms in all, "
             f"{charged.get(SELF, 0.0) / 1e3:.3f} outside the children; "
             f"window wall - busy {window_idle:.3f} ms")
