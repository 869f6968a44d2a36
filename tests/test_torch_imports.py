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


DRY_RUN_MODULES = ("repro_torch.launch.specs", "repro_torch.launch.dryrun", "repro_torch.launch.op_cost")


def test_dry_run_modules_are_walked():
    """The dry run's modules are among those the import guard walks."""
    assert set(DRY_RUN_MODULES) <= set(_port_modules())


def test_dry_run_modules_import_without_jax_or_a_process_group():
    """Importing the dry run's modules pulls in no JAX and no ``repro``,
    starts no process group (the fake group starts in ``dryrun.main``
    alone), leaves no fake tensor mode active and leaves the kernel
    libraries unbuilt."""
    code = (
        "import importlib, sys\n"
        f"for m in {DRY_RUN_MODULES!r}: importlib.import_module(m)\n"
        "import torch.distributed as dist\n"
        "from torch._guards import active_fake_mode\n"
        "from repro_torch.kernels import cuda_lib\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.')) or m == 'repro']\n"
        "assert not bad, bad\n"
        "assert not dist.is_initialized()\n"
        "assert active_fake_mode() is None\n"
        "assert not cuda_lib._LIBS\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-2000:]
