"""Device idle ms a call charged to the program's `localize.backproject`
spans: idle instants of the profiled window while the host was in one
(`benchmark/core/spans.py`). The profiler stretches the host's work, so
idle reads higher there than in the unprofiled call. Reads
`backproject_idle_ms.<anything>`."""

from benchmark.core import spans


def read(run, kernels):
    return spans.idle_ms(run, ("localize.backproject",))
