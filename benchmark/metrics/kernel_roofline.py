"""The hand-written kernels' share of their rooflines in the profiled
window, in %: Σ bound times over Σ device times. Every kernel file under
`benchmark/kernels/` whose `match` finds launches in the trace counts, its
bound per launch `bound()` of the bytes and operations the file counts
from the quantities per launch that the entry worked out
(`run.layer["launch_quantities"]`). A kernel that launched but whose
quantities the cell does not give, and a kernel that the cell's file
lists (`kernels`) but that matched no launch, are named on standard error.
Reads `kernel_roofline.<anything>`."""

import sys

from benchmark.core.roofline import bound


def read(run, kernels):
    t, quantities = run.trace, run.layer.get("launch_quantities")
    if t is None or not quantities:
        return None
    bound_ms = device_ms = 0.0
    for name, k in sorted(kernels.items()):
        count, us = t.kernel_time_us(k["match"])
        if count == 0:
            if name in run.layer.get("expected_kernels", ()):
                print(f"kernel_roofline: {name} is listed for the cell and "
                      f"matched no launch", file=sys.stderr)
            continue
        needed = set(k["bytes"]) | set(k.get("operations", {}))
        missing = sorted(needed - set(quantities))
        if missing:
            print(f"kernel_roofline: {name} launched {count} times; the cell "
                  f"gives no {', '.join(missing)}: left out", file=sys.stderr)
            continue
        moved = sum(c * quantities[q] for q, c in k["bytes"].items())
        ops = sum(c * quantities[q] for q, c in k.get("operations", {}).items())
        bound_ms += count * bound(moved, ops)[0]
        device_ms += us / 1e3
    if device_ms <= 0:
        return None
    return 100.0 * bound_ms / device_ms
