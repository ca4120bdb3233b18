"""Device ms a step in the program's `edit.backward` span, the SDS step's
backward, all of it: the stream time between the span's two CUDA events,
in the profiled window (`benchmark/core/spans.py`). Reads
`backward_ms.<anything>`."""

from benchmark.core import spans


def read(run, kernels):
    return spans.device_ms(run, ("edit.backward",))
