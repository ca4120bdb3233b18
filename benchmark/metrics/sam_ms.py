"""Device ms a call of SAM's image encoder and mask decoder (`sam.encode`
and `sam.decode` spans): the stream time between each span's two CUDA
events, in the profiled window (`benchmark/core/spans.py`). Reads
`sam_ms.<anything>`."""

from benchmark.core import spans


def read(run, kernels):
    return spans.device_ms(run, ("sam.encode", "sam.decode"))
