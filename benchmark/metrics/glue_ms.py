"""Device ms a step of the SDS step's glue: `edit.step` less its five
stage spans, that is `edit.prepare` (draws, cameras, prompts, uploads),
`edit.record` (the one read-back, the governor) and the root's own time,
in the profiled window (`benchmark/core/spans.py`). Reads
`glue_ms.<anything>`."""

from benchmark.core import spans


def read(run, kernels):
    return spans.glue_ms(run)
