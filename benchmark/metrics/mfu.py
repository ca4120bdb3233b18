"""The step's or call's share of the chip's peak, in %: the least time on
the chip that the entry counted on the plain reference
(`run.layer["least_ms"]`) over the measured time of the same run
(`run.layer["unit_ms"]`). Reads `mfu.<anything>`."""


def read(run, kernels):
    least, measured = run.layer.get("least_ms"), run.layer.get("unit_ms")
    if not least or not measured:
        return None
    return 100.0 * least / measured
