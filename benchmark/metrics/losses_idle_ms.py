"""Device idle ms a step charged to the program's `edit.losses` span: idle
instants of the profiled window while the host was in it
(`benchmark/core/spans.py`). The profiler stretches the host's work, so
idle reads higher there than in the unprofiled step. Reads
`losses_idle_ms.<anything>`."""

from benchmark.core import spans


def read(run, kernels):
    return spans.idle_ms(run, ("edit.losses",))
