"""Nothing that ``bench/run.py`` runs imports JAX or the JAX package: a fresh
interpreter runs a tiny CPU run of every driver and lists the top-level
names it then holds, compared whole (the port's name begins with the JAX
package's)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROGRAM = """
import json, sys, tempfile, time
sys.path[:0] = [{root!r}, {root!r} + '/src']
from bench import harness, run
from bench import test_bench_train
with tempfile.TemporaryDirectory() as tmp:
    run.execute("mamba2-train", 5, 0.05, False, "cpu", time.perf_counter(), overrides=test_bench_train.TINY, tmp=tmp)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def test_no_module_of_a_run_is_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", PROGRAM.format(root=str(ROOT))], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    held = set(json.loads(out.splitlines()[-1]))
    assert "repro_torch" in held and "bench" in held
    assert not held & {"jax", "jaxlib", "flax", "repro"}, sorted(held & {"jax", "jaxlib", "flax", "repro"})
