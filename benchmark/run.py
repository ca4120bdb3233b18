#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 benchmark/run.py --workload geo_edit.sds --seed 7 --seconds 45 --trace 0

Everything is found by name from `BENCHMARK.json` at the root of the
checkout:
  * the cell `benchmark/workloads/<cell>.json` — its entry, its traffic and
    the limits of its comparison;
  * its configuration `benchmark/configs/<config>.json` — the sizes as run;
  * the entry `benchmark/entries/<entry>.py`, whose `run(context)` sets the
    program up, measures, and compares with the plain reference;
  * each per-layer metric's reader `benchmark/metrics/<metric>.py`, or,
    where there is none, the reader of its kind, the name's part before
    the first dot (`idle_share.view` → `idle_share.py`); its
    `read(cell_run, kernels)` returns the value or None;
  * every kernel's bound arithmetic `benchmark/kernels/<kernel>.json`.

With `--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, the device's busy time and a breakdown.
The last line of standard output is one JSON object; the numbers compared
with their limits are the last lines of standard error. No result is
printed, and the exit code is not 0, without a CUDA card or with fewer
cards than the cell asks for, or if JAX or the JAX package was loaded."""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
# The program's caches, at fixed paths inside the checkout.
CACHE = BENCH / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "youreditableavatar_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's, Flax's
    or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cell_spec(name: str):
    """(BENCHMARK.json, its entry of the cell, the cell's file, the
    configuration's file)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    workload = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    return bench, cell, workload, config


def reader_path(metric: str) -> Path:
    """The metric's own reader, or its kind's."""
    own = BENCH / "metrics" / f"{metric}.py"
    return own if own.is_file() else BENCH / "metrics" / f"{metric.split('.')[0]}.py"


def window_tenths(durations_ms) -> str:
    """The mean step of each tenth of the window, in ms: warm-up or drift
    inside the window shows as a trend."""
    n = len(durations_ms)
    parts = [durations_ms[n * k // 10:n * (k + 1) // 10] for k in range(10)]
    return " ".join(f"{sum(p) / len(p):.3f}" for p in parts if p)


def cell_metrics(bench, cell_name: str, kind: str):
    """The cell's metrics of `kind` ("end_to_end" or "per_layer")."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from benchmark.core.cell import Context, process_start_time

    started = process_start_time()
    bench, cell, workload, config = cell_spec(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA card(s); this "
              f"machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if config["precision"]["tf32"] is False:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    dev = torch.device("cuda", 0)
    entry = importlib.import_module(f"benchmark.entries.{workload['entry']}")
    ctx = Context(name=args.workload, config=config, workload=workload,
                  seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  device=dev, started=started, cache_dir=CACHE)
    res = entry.run(ctx)

    if res.layer.get("durations_ms"):
        print(f"window: {len(res.layer['durations_ms'])} steps; mean ms by "
              f"tenth: {window_tenths(res.layer['durations_ms'])}",
              file=sys.stderr)
    found = forbidden_modules()
    if found:
        print("benchmark: these modules were loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    out = {"correct": res.correct, "attempted": res.attempted,
           "failed": res.failed, "metrics": {}}
    if args.trace:
        kernels = {p.stem: json.loads(p.read_text())
                   for p in sorted((BENCH / "kernels").glob("*.json"))}
        res.layer["expected_kernels"] = workload.get("kernels", [])
        for m in cell_metrics(bench, args.workload, "per_layer"):
            reader = load_module(reader_path(m["name"]),
                                 "bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(res, kernels)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, args.workload, "end_to_end"):
            if m["name"] in res.metrics:
                out["metrics"][m["name"]] = {"value": res.metrics[m["name"]][0],
                                             "unit": m["unit"]}
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                     "count": cell["chips"],
                     "memory_peak_bytes": res.memory_peak_bytes}
    if args.trace and res.trace is not None:
        out["device"]["busy_s"] = res.trace.busy_us / 1e6
        out["device"]["window_s"] = res.trace.wall_us / 1e6
        out["breakdown"] = res.trace.breakdown()
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in res.checks}
    for name, v, lim in res.checks:
        print(f"check {name}: {v!r} (limit {lim!r}) "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
