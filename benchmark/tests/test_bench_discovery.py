"""Discovery by name: a configuration, a cell, a per-layer metric and a
kernel's bound added as new files and BENCHMARK.json entries are found
without editing any file that is there; and the harness refuses to run
without a card."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.run import reader_path

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark's own files (BENCHMARK.json and `paths`)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for p in bench["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    return tmp_path


def _run(checkout, code):
    return subprocess.run([sys.executable, "-c", code], cwd=checkout,
                          capture_output=True, text=True, timeout=120)


def test_added_files_are_found_by_name(checkout):
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "dummy_config", "source": "https://example.org/dummy",
        "file": "benchmark/configs/dummy_config.json", "reduced": [],
        "why": "a configuration added as a file"})
    bench["workloads"].append({
        "name": "dummy.cell", "config": "dummy_config", "traffic": "dummy",
        "chips": 1, "why": "a cell added as a file"})
    bench["per_layer"].append({
        "name": "dummy.metric", "unit": "share", "better": "lower",
        "source": "device_trace", "layer": "device", "moves": "step_ms",
        "workloads": ["dummy.cell"]})
    bench["per_layer"].append({
        "name": "kernel_roofline.dummy", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "kernels", "moves": "step_ms",
        "workloads": ["dummy.cell"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    b = checkout / "benchmark"
    (b / "configs" / "dummy_config.json").write_text(
        json.dumps({"name": "dummy_config", "width": 7}))
    (b / "workloads" / "dummy.cell.json").write_text(
        json.dumps({"entry": "dummy_entry", "rate": 3}))
    (b / "entries" / "dummy_entry.py").write_text("def run(ctx):\n    return ctx\n")
    (b / "metrics" / "dummy.metric.py").write_text(
        "def read(run, kernels):\n    return kernels['dummy_kernel']['bytes']['rows']\n")
    # A kernel whose launch is in the trace below, bound by 2 µs.
    (b / "kernels" / "dummy_kernel.json").write_text(
        json.dumps({"match": "dummy_kernel", "bytes": {"rows": 5}}))
    out = _run(checkout, """
import importlib, json, sys
sys.path.insert(0, '.')
from benchmark import run
from benchmark.core.cell import CellRun
from benchmark.core.trace import Trace
bench, cell, workload, config = run.cell_spec('dummy.cell')
entry = importlib.import_module('benchmark.entries.' + workload['entry'])
metrics = [m['name'] for m in run.cell_metrics(bench, 'dummy.cell', 'per_layer')]
kernels = {p.stem: json.loads(p.read_text())
           for p in (run.BENCH / 'kernels').glob('*.json')}
reader = run.load_module(run.reader_path('dummy.metric'), 'm')
roofline = run.load_module(run.reader_path('kernel_roofline.dummy'), 'k')
launches = [('void dummy_kernel(float*)', 0.0, 4.0),
            ('void resolve_kernel(float*)', 10.0, 14.0)]
res = CellRun(attempted=1, failed=0, metrics={}, checks=[],
              memory_peak_bytes=0,
              trace=Trace(1, 20.0, launches, launches, []),
              layer={'launch_quantities': {
                  'rows': 2 * 3.35e12 * 1e-6 / 5, 'mesh_faces': 3.35e12 * 1e-6 / 36,
                  'mesh_pairs': 0, 'mesh_tiles': 0, 'mesh_pixels': 0}})
without = {k: v for k, v in kernels.items() if k != 'dummy_kernel'}
print(json.dumps([cell['config'], config['width'], workload['rate'],
                  entry.run(7), metrics, reader.read(None, kernels),
                  roofline.read(res, without), roofline.read(res, kernels)]))
""")
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got[:6] == ["dummy_config", 7, 3, 7,
                       ["dummy.metric", "kernel_roofline.dummy"], 5]
    # The resolve alone: 1 of 4 µs; with the added kernel: 3 of 8 µs.
    assert got[6] == pytest.approx(25.0) and got[7] == pytest.approx(37.5)


def test_every_named_file_exists():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = ROOT / "benchmark"
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        spec = json.loads((b / "workloads" / f"{w['name']}.json").read_text())
        assert (b / "entries" / f"{spec['entry']}.py").is_file()
    for m in bench["per_layer"]:
        assert reader_path(m["name"]).is_file()


@pytest.mark.parametrize("trace", ["0", "1"])
def test_no_result_without_a_card(checkout, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "geo_edit.sds",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", trace],
        cwd=checkout, capture_output=True, text=True, timeout=120)
    if out.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
