"""Device idle ms a step charged to the SDS step's glue: idle instants of
the profiled window while the host was in `edit.prepare`, `edit.record`,
`edit.step` outside its children, or between steps
(`benchmark/core/spans.py`). With the five stages' idle it sums to the
window's idle a step. Reads `glue_idle_ms.<anything>`."""

from benchmark.core import spans


def read(run, kernels):
    return spans.glue_idle_ms(run)
