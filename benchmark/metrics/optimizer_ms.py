"""Device ms a step in the program's `edit.optimizer` span, the SDS step's
AdamW update: the stream time between the span's two CUDA events, in the
profiled window (`benchmark/core/spans.py`). Reads
`optimizer_ms.<anything>`."""

from benchmark.core import spans


def read(run, kernels):
    return spans.device_ms(run, ("edit.optimizer",))
