"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's files by name (``bench/harness.py``), sets up, warms up,
measures for ``--seconds``, checks what the timed path produced against the
plain reference, and prints one JSON object as the last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number beside its limit (also the last lines of standard error).
Earlier lines of standard output give the set-up's phases, peak memory,
counts and the card's clocks and power. It exits non-zero and prints no
result without a CUDA device, or where the process holds JAX or the JAX
package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# every build and kernel cache of the program stays inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def execute(workload: str, seed: int, seconds: float, trace: bool, device: str, t_start: float,
            overrides=None, tmp=None, faults=()) -> dict:
    """One run of ``workload`` on ``device``: the result object."""
    import torch

    from bench import harness

    ctx = harness.Run(workload, seed, seconds, trace, device, t_start, overrides=overrides, tmp=tmp)
    ctx.faults.update(faults)
    ctx.phases["import"] = time.perf_counter() - t_start
    driver = importlib.import_module(f"bench.drivers.{ctx.traffic['kind']}")
    out = driver.run(ctx)
    correct, checks = harness.judge(out["readings"], ctx.traffic["limits"])
    units = {m["name"]: m["unit"] for m in ctx.bench["end_to_end"] + ctx.bench["per_layer"]}
    metrics = {}
    if not trace:
        for m in harness.metrics_of(ctx.bench, "end_to_end", workload):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    else:
        for name, path in ctx.files["metrics"].items():
            v = harness.reader(path)(out["rec"])
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": ctx.files["workload"]["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": dev}
    if trace:
        win = out["rec"].window
        if device != "cpu" and win.busy_s <= 0:
            raise RuntimeError("the profiler saw no device operation in the traced window")
        dev.update(busy_s=win.busy_s, window_s=win.window_s)
        result["breakdown"] = {"device_ops": win.top_ops(), "idle_gaps": win.idle_gaps()}
    result["checks"] = checks
    ctx.log("phases", **ctx.phases)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench import harness

    chips = harness.cell_files(harness.spec(), args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401  (the system under test, from the checkout's src/)
    except ImportError as e:
        print(f"bench: the system under test cannot be imported ({e}); run from a checkout", file=sys.stderr)
        return 4
    print(json.dumps({"bench": "card", "smi": harness.nvidia_smi()}), flush=True)
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    print(json.dumps({"bench": "card_after", "smi": harness.nvidia_smi()}), flush=True)
    held = harness.forbidden_modules()
    if held:
        print(f"bench: the process holds {held} after the window; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
