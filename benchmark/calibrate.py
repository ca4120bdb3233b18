#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process, each
from a whole run of the cell's entry (`run`) at the cell's own size:

    python3 benchmark/calibrate.py --workload geo_edit.sds --seeds 1-12 \\
        --control-seeds 1-3 --fault-seeds 1-3 --seconds 2

For each seed the program's numbers against the plain reference (the lower
readings); for each control seed the same run with the entry's `CONTROL`
in the program's place (the reference in the nearest precision below the
configuration's); for each fault seed one run under each of the entry's
`FAULTS` (the upper readings). Each line gives the run's checks against
the cell's limits and whether it came out correct. The benchmark's own
runs never run this."""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(text: str):
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="each run's window (whole calls: at least one)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.core.cell import Context
    from benchmark.run import CACHE, cell_spec

    _, _, wl, cfg = cell_spec(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    entry = importlib.import_module(f"benchmark.entries.{wl['entry']}")
    runs = [(s, "program", contextlib.nullcontext) for s in seeds(args.seeds)]
    runs += [(s, "control", entry.CONTROL) for s in seeds(args.control_seeds)]
    runs += [(s, name, hook) for s in seeds(args.fault_seeds)
             for name, hook in entry.FAULTS.items()]
    for s, name, hook in runs:
        ctx = Context(name=args.workload, config=cfg, workload=wl, seed=s,
                      seconds=args.seconds, trace=False, device=dev,
                      started=time.time(), cache_dir=CACHE)
        with hook():
            res = entry.run(ctx)
        print(json.dumps({
            "workload": args.workload, "seed": s, "variant": name,
            "correct": res.correct, "failed": res.failed,
            "checks": {k: [v, lim] for k, v, lim in res.checks},
            "gaps": res.layer.get("gaps"),
            "readings": res.layer.get("readings")}), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
