"""Device ms a step or call of the text towers' prompt
encoding (`text` spans): the stream time between
each span's two CUDA events, in the profiled window
(`benchmark/core/spans.py`). Reads `text_ms.<anything>`."""

from benchmark.core import spans


def read(run, kernels):
    return spans.device_ms(run, ("text",))
