"""Device ms a step or call of the UNet's forward passes
(`unet` spans): the stream time between
each span's two CUDA events, in the profiled window
(`benchmark/core/spans.py`). Reads `unet_ms.<anything>`."""

from benchmark.core import spans


def read(run, kernels):
    return spans.device_ms(run, ("unet",))
