"""Device ms a call of GroundingDINO's multi-scale deformable attention
(`gdino.msda` spans, inside `gdino`), in the profiled window
(`benchmark/core/spans.py`). Reads `msda_ms.<anything>`."""

from benchmark.core import spans


def read(run, kernels):
    return spans.device_ms(run, ("gdino.msda",))
