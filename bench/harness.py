"""The run of one cell: its files found by name, its context, its result.

``BENCHMARK.json`` names each cell's configuration and traffic; the files
are ``bench/configs/<config>.json``, ``bench/traffic/<cell>.json`` and
``bench/drivers/<traffic kind>.py``, and each per-layer metric's reader is
``bench/metrics/<metric>.py`` or, shared by the cells of one quantity,
``bench/metrics/<stem>.py`` (``device_idle.train`` reads with
``device_idle.py``). Nothing here is particular to a cell.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
#: top-level modules the benchmark's process may never hold (whole names)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(bench: dict, workload: str) -> dict:
    """The files of ``workload`` by name: its entry, configuration, traffic,
    driver and per-layer metric readers; raises naming what is missing."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    traffic = BENCH / "traffic" / f"{w['traffic']}.json"
    kind = load_json(traffic)["kind"]
    out = {"workload": w, "config": ROOT / conf["file"], "traffic": traffic,
           "driver": BENCH / "drivers" / f"{kind}.py",
           "metrics": {m["name"]: reader_file(m["name"]) for m in metrics_of(bench, "per_layer", workload)}}
    for key in ("config", "traffic", "driver"):
        if not out[key].is_file():
            raise FileNotFoundError(f"{workload}: {key} file {out[key]} is missing")
    for name, p in out["metrics"].items():
        if not p.is_file():
            raise FileNotFoundError(f"{workload}: per-layer metric {name} has no reader {p}")
    return out


def reader_file(metric: str) -> Path:
    """A per-layer metric's reader: ``metrics/<metric>.py``, else the file of
    its stem, the part before the first dot."""
    own = BENCH / "metrics" / f"{metric}.py"
    return own if own.is_file() else BENCH / "metrics" / f"{metric.split('.')[0]}.py"


def metrics_of(bench: dict, group: str, workload: str) -> list:
    """The ``group`` ("end_to_end" / "per_layer") metrics a cell reports: an
    end-to-end metric without a ``workloads`` list is every cell's; a
    per-layer metric is reported in the cells it lists."""
    if group == "end_to_end":
        return [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    return [m for m in bench["per_layer"] if workload in m["workloads"]]


def load_module(path: Path, name: str):
    spec_ = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def reader(path: Path):
    """The ``read(rec)`` function of a per-layer metric's file."""
    return load_module(path, "bench_metric_" + path.stem.replace(".", "_").replace("-", "_")).read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def nvidia_smi() -> Optional[dict]:
    """The card's name, clocks, power and limit, or None without the tool."""
    q = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return dict(zip(q.split(","), (v.strip() for v in out.splitlines()[0].split(","))))


class Run:
    """One run of one cell: its files, seed, window and device, the set-up
    phases it times, the harness's spans, and a log of earlier lines."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool, device: str,
                 t_start: float, bench: Optional[dict] = None, tmp: Optional[Path] = None,
                 overrides: Optional[dict] = None) -> None:
        from bench.trace import Spans

        self.bench = bench if bench is not None else spec()
        self.files = cell_files(self.bench, workload)
        self.workload = workload
        self.cfg = load_json(self.files["config"])
        self.traffic = load_json(self.files["traffic"])
        for key, val in (overrides or {}).items():  # tests: small shapes on the CPU
            if key == "arch":
                self.cfg["arch"] = {**self.cfg["arch"], **val}
            else:
                self.traffic[key] = val
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_start = t_start
        self.phases: dict[str, float] = {}
        self.spans = Spans()
        self.tmp = Path(tmp or os.environ.get("TMPDIR") or "/tmp")
        self.faults: set[str] = set()  # planted by the harness's own tests

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        self.phases[name] = time.perf_counter() - t0
        self.log("phase", name=name, seconds=self.phases[name])

    def log(self, what: str, **kw) -> None:
        print(json.dumps({"bench": what, **kw}, default=float), flush=True)

    def sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every reading within its limit, {name: {value, limit}}); a reading
    without a limit, or a limit without a reading, is not correct."""
    checks = {k: {"value": readings.get(k), "limit": limits.get(k)} for k in sorted(set(readings) | set(limits))}
    ok = all(c["value"] is not None and c["limit"] is not None and math.isfinite(c["value"])
             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
