"""Device ms a call of SAM's global-attention blocks (`sam.global` spans,
inside `sam.encode`), in the profiled window (`benchmark/core/spans.py`).
Reads `sam_global_ms.<anything>`."""

from benchmark.core import spans


def read(run, kernels):
    return spans.device_ms(run, ("sam.global",))
