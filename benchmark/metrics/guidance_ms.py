"""Device ms a step in the program's `edit.guidance` span, the SDS step's
guidance term: the VAE encoder and the UNet at CFG batch 2: the stream
time between the span's two CUDA events, in the profiled window
(`benchmark/core/spans.py`). Reads `guidance_ms.<anything>`."""

from benchmark.core import spans


def read(run, kernels):
    return spans.device_ms(run, ("edit.guidance",))
