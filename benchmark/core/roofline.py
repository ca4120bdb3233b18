"""The H100's published peaks and the least time of a piece of work.

`bound` is a frozen copy of `chip_smoke.py:339` (`bound`), with its peaks
(`chip_smoke.py:130-131`): NVIDIA's H100 SXM data sheet, dense f32 outside
the tensor cores and HBM3 bandwidth, at the 700 W power limit."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(bytes_moved: float, ops: float):
    """(least milliseconds, "bytes" or "operations"): the larger of the
    bytes over the bandwidth and the operations over the f32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
