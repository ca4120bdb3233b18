"""The device's idle share of the cell's step or call: 1 − its busy time
per step or call (the union of the device's intervals in the profiled
window) over the measured time of the same run, `run.layer["unit_ms"]`.
The profiled window's own wall is not the denominator: the profiler's
host work per launch stretches it. Reads `idle_share.<anything>`."""


def read(run, kernels):
    t, measured = run.trace, run.layer.get("unit_ms")
    if t is None or t.iters <= 0 or t.busy_us <= 0 or not measured:
        return None
    return 1.0 - t.busy_us / 1e3 / t.iters / measured
