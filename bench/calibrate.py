"""Readings that set a cell's limits (``limits`` in its traffic file), on the card.

    python3 bench/calibrate.py --workload <name> --seeds 1,2,... [--control-seeds 1,2,3]

For each seed of a ``train`` cell, in one process: the system's set-up and
first steps, and the readings that the run's check compares (the lower
readings). For each control seed also the control, the plain reference in
the system's place with fp8 products (the precision below the
configuration's bf16), and the fault "half of the batch left out" planted
in the reference put in the system's place; their readings are the upper
ones. One JSON line a reading. The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def emit(**kw) -> None:
    print(json.dumps(kw, default=float), flush=True)


def train_seed(ctx, control: bool) -> None:
    import torch

    from bench.drivers import train

    cell = train.Cell(ctx)
    prog = {"losses": [float(x) for x in cell.losses], "m1": cell.m1, "change": cell.change}
    batches, rs, k = cell.batches, cell.rs, cell.pipe.k
    cell.close()
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    emit(seed=ctx.seed, side="program", **train.check(ctx, prog, batches, rs, k))
    if not control:
        return
    tr, cfg = ctx.traffic, ctx.cfg["arch"]
    _wrong, rebuilt = train.token_check(batches, rs, k)
    first = rebuilt[: tr["checked_steps"]]
    ref = train.reference_train(cfg, tr, ctx.seed, ctx.device, first, "f32", tr["reference_rows"])
    for side, kw in (("control_fp8", {"precision": "fp8"}), ("fault_half_batch", {"precision": "f32", "half": True})):
        other = train.reference_train(cfg, tr, ctx.seed, ctx.device, first, kw.pop("precision"),
                                      tr["reference_rows"], **kw)
        r = train.readings(other, ref)
        emit(seed=ctx.seed, side=side, leaves=r.pop("_leaves"), loss_gap=r.pop("_loss_gap"), **r)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args()
    from bench import harness

    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds:
        ctx = harness.Run(args.workload, seed, 0, False, "cuda", time.perf_counter())
        train_seed(ctx, seed in control)
    return 0


if __name__ == "__main__":
    sys.exit(main())
