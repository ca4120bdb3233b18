"""What the benchmark's runs load: no module whose top-level name, compared
whole, is `jax`, `jaxlib`, `flax` or the JAX package
(`youreditableavatar_tpu`, a prefix of the port's name); and the plain
reference loads nothing of the port either."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "youreditableavatar_tpu"}


def _top_levels(code):
    out = subprocess.run([sys.executable, "-c", code + """
import json, sys
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_the_port():
    mods = sorted(p.stem for p in (ROOT / "benchmark" / "reference").glob("*.py")
                  if p.stem != "__init__")
    names = _top_levels("import importlib, sys\nsys.path.insert(0, '.')\n"
                        + "".join(f"importlib.import_module('benchmark.reference.{m}')\n"
                                  for m in mods))
    assert not names & FORBIDDEN
    assert "youreditableavatar_tpu_torch" not in names


def test_a_run_loads_the_port_and_not_jax():
    names = _top_levels("""
import sys, time
sys.path.insert(0, '.')
import benchmark.run, benchmark.calibrate
from benchmark.entries import sds_edit
from benchmark.tests import tiny
ctx = tiny.context('geo_edit.sds', tiny.sds_config(),
                   tiny.load('workloads', 'geo_edit.sds'), tmp='/tmp')
ctx.cache_dir = __import__('pathlib').Path(__import__('tempfile').mkdtemp())
ctx.started = time.time()
assert sds_edit.run(ctx).correct
""")
    assert "youreditableavatar_tpu_torch" in names
    assert not names & FORBIDDEN
    assert "youreditableavatar_tpu" not in names  # compared whole
