"""BENCHMARK.json against the limits its readers hold it to: the keys of
each entry, the names and units, the lengths, the bounds, and that every
cell reports `setup_s`, another end-to-end metric and a per-layer metric
that moves one of its end-to-end metrics."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        used = {w["config"] for w in BENCH["workloads"]}
        assert c["name"] in used


def test_workloads():
    assert 1 <= len(BENCH["workloads"]) <= 24
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def _metrics(kind):
    return BENCH[kind]


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_entries(kind):
    cells = {w["name"] for w in BENCH["workloads"]}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in _metrics(kind):
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        if kind == "end_to_end":
            assert set(m) - {"workloads"} == {"name", "unit", "better",
                                              "bound", "source"}
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert set(m) - {"workloads"} == {"name", "unit", "better",
                                              "source", "layer", "moves"}
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert _line(m["layer"])
            if "roofline" in m["name"] or "mfu" in m["name"]:
                assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in BENCH["workloads"]:
        cell = w["name"]
        mine = {n for n, m in e2e.items() if cell in m.get("workloads", [cell])}
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in BENCH["per_layer"]
                 if cell in m.get("workloads", [cell])]
        assert layer
        for m in layer:
            assert m["moves"] in mine, (cell, m["name"])


def test_layers_are_spelled_one_way():
    perf = (ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert f"**{m['layer']}**" in perf, m["layer"]


def test_run_seconds_fit_a_full_check():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
