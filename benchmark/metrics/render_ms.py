"""Device ms a step in the program's `edit.render` span, the SDS step's
render: the live field's surface (hash grid, marching tets) and its
normal maps (K5): the stream time between the span's two CUDA events, in
the profiled window (`benchmark/core/spans.py`). Reads
`render_ms.<anything>`."""

from benchmark.core import spans


def read(run, kernels):
    return spans.device_ms(run, ("edit.render",))
