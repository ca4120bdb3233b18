"""Device ms a call of the localization's back-projection
(`localize.backproject` spans: the mesh raster, the face-id and mask
downloads, the votes), in the profiled window
(`benchmark/core/spans.py`). Reads `backproject_ms.<anything>`."""

from benchmark.core import spans


def read(run, kernels):
    return spans.device_ms(run, ("localize.backproject",))
