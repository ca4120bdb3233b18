"""Device ms a step or call of ControlNet-Union's passes
(`controlnet` spans): the stream time between
each span's two CUDA events, in the profiled window
(`benchmark/core/spans.py`). Reads `controlnet_ms.<anything>`."""

from benchmark.core import spans


def read(run, kernels):
    return spans.device_ms(run, ("controlnet",))
