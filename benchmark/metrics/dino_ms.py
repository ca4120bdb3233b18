"""Device ms a call of GroundingDINO's forward passes (`gdino` spans), in
the profiled window (`benchmark/core/spans.py`). Reads
`dino_ms.<anything>`."""

from benchmark.core import spans


def read(run, kernels):
    return spans.device_ms(run, ("gdino",))
