"""Import guard: the PyTorch port, chip_smoke.py and the case modules it
takes from tests/ never import JAX or the JAX package, and every module of the port imports on a machine without a
card, nvcc or triton."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import repro_torch

ROOT = Path(__file__).resolve().parents[1]


def _port_modules():
    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(m.name)
    return names


def test_port_modules_import_without_jax_or_reference():
    mods = _port_modules()
    assert len(mods) > 15
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.')) or m == 'repro']\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-2000:]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_and_port_sources_never_import_jax_or_reference():
    shared = [ROOT / "tests" / f for f in ("dp_cases.py", "train_cases.py", "moe_cases.py")]  # chip_smoke imports them
    files = [ROOT / "chip_smoke.py", *shared, *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]
    for f in files:
        roots = _imported_roots(f)
        assert not roots & {"jax", "jaxlib", "repro"}, (f, roots)
