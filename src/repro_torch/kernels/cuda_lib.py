"""Build, load and count the port's hand-written CUDA kernels.

Each source in ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes``. Builds
happen at first use, all sources in parallel (one ``nvcc`` each), into the
``build/`` directory at the root of the checkout that holds these sources
(the port runs from a source checkout, ``PYTHONPATH=src``); a library's file name carries a hash of
its sources and flags, so an edited kernel rebuilds and an unchanged one is
only loaded. Nothing here runs when the module is imported.

``COUNTS`` is ``repro_torch.obs.COUNTS``, the port's one registry of
counters: ``launch:<kernel>`` is bumped by a wrapper exactly where it
launches its CUDA kernel, ``plain:<kernel>`` where a CPU tensor takes the
plain torch version, and ``build`` once per library compiled by this
process; ``counts()`` and ``reset_counts()`` are its views.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from repro_torch.obs import COUNTS, counts, reset_counts  # noqa: F401  (the registry and its views)

CSRC = Path(__file__).resolve().parent / "csrc"
#: the checkout's root when this package sits at ``<root>/src/repro_torch``
CHECKOUT = Path(__file__).resolve().parents[3]
BUILD_DIR = CHECKOUT / "build"
SOURCES = {
    "sage_unpack": "sage_unpack.cu",
    "sage_decode": "sage_decode.cu",
    "reformat": "reformat.cu",
    "ssd_chunk": "ssd_chunk.cu",
    "ssd_chunk_bwd": "ssd_chunk_bwd.cu",
    "ssd_chain": "ssd_chain.cu",
    "banded_align": "banded_align.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

#: per library: {"seconds", "built", "log"} of this process's build/load
BUILD_INFO: dict[str, dict] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels are "
        "built from src/repro_torch/kernels/csrc at first use"
    )


def _require_checkout() -> None:
    """Builds go only into the checkout that holds ``csrc/``, never beside
    an installed copy of the package."""
    if CSRC.parents[2].name != "src":
        raise RuntimeError(
            f"repro_torch builds its CUDA kernels into <checkout>/build and must "
            f"run from a source checkout (PYTHONPATH=src); found it at {CSRC.parent.parent}"
        )


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*")):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, dict]:
    """Compile (or load) every kernel library; returns ``BUILD_INFO``.

    Missing libraries are compiled concurrently, one ``nvcc`` per source;
    a failed compile raises with the compiler's output."""
    with _LOCK:
        todo = [n for n in SOURCES if n not in _LIBS]
        if not todo:
            return BUILD_INFO
        _require_checkout()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name in todo:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / SOURCES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ), tmp, out)
        errors = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            BUILD_INFO[name] = {"built": True, "log": log}
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, out)
            COUNTS["build"] += 1
        if errors:
            raise RuntimeError("\n".join(errors))
        secs = time.perf_counter() - t0
        for name in todo:
            _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
            info = BUILD_INFO.setdefault(name, {"built": False, "log": ""})
            info["seconds"] = secs
        return BUILD_INFO


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for ``name`` (built at first use)."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def check(rc: int, name: str, err_fn) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        msg = err_fn(rc)
        raise RuntimeError(
            f"{name}: CUDA launch failed with error {rc} "
            f"({msg.decode() if msg else 'unknown'})"
        )


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the wrappers then take their
    plain version), False when every tensor lies on CUDA; raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors must all be on the CPU or all on CUDA, got {sorted(kinds)}")


def require_cuda(*tensors, name: str) -> None:
    """Every tensor must be on one CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
