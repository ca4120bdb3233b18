"""Device ms a step or call of the VAE's encodes and decodes
(`vae_encode`, `vae_decode` spans): the stream time between
each span's two CUDA events, in the profiled window
(`benchmark/core/spans.py`). Reads `vae_ms.<anything>`."""

from benchmark.core import spans


def read(run, kernels):
    return spans.device_ms(run, ("vae_encode", "vae_decode"))
