"""Device ms a step in the program's `edit.losses` span, the SDS step's
recon, control-SDF, normal-consistency and image terms: the stream time
between the span's two CUDA events, in the profiled window
(`benchmark/core/spans.py`). Reads `losses_ms.<anything>`."""

from benchmark.core import spans


def read(run, kernels):
    return spans.device_ms(run, ("edit.losses",))
