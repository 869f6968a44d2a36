"""Profile training steps of the PyTorch port: the wall time of a few steps
of ``make_train_step`` (remat on, bf16 activations, AdamW) on random tokens,
then one step under ``torch.profiler`` (device time, kernels launched, busy
share, the top device ops) and the optimizer on its own (``global_norm`` and
``adamw_update`` on stand-in gradients of the parameters' shapes, each
profiled: device time and kernels).

It uses only the port's public training API, so the same script measures
two trees of the port one after the other (``PYTHONPATH`` picks the tree):

  PYTHONPATH=src python examples/profile_train_step_torch.py --arch mamba2-370m
  PYTHONPATH=src python examples/profile_train_step_torch.py --device cpu --reduced --seq 64
  PYTHONPATH=src python examples/profile_train_step_torch.py --arch deepseek-moe-16b --device cpu --reduced --seq 64

Prints one JSON line.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch
from repro_torch.core.decode_torch import resolve_device
from repro_torch.training import optimizer as TO
from repro_torch.training.steps import TrainOptions, init_train_state, make_train_step


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def profiled(fn, dev) -> dict:
    """``fn()`` once on the host clock and once under torch.profiler: wall ms,
    device ms (every kernel, copy and memset), device events, busy share and
    the top 8 device ops by time."""
    sync(dev)
    t0 = time.perf_counter()
    fn()
    sync(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms, "device_events": sum(r[2] for r in rows),
            "device_busy_share": device_ms / wall_ms if rows else None,
            "top": [{"name": n[:60], "ms": t / 1e3, "count": c} for n, t, c in rows[:8]]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true", help="the configuration's reduced cut")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=6, help="timed steps after two warm-up steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default="", help="a name for this tree in the output")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opts = TrainOptions(adamw=TO.AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=args.steps + 4))
    model, opt = init_train_state(torch.Generator(device=dev).manual_seed(args.seed), cfg, opts, device=dev)
    step = make_train_step(cfg, opts)
    toks = np.random.default_rng(args.seed).integers(0, cfg.vocab, (args.batch, args.seq + 1)).astype(np.int32)
    batch = {"tokens": torch.as_tensor(toks[:, :-1], device=dev), "labels": torch.as_tensor(toks[:, 1:], device=dev)}
    state = {"model": model, "opt": opt}

    def one_step():
        state["model"], state["opt"], m = step(state["model"], state["opt"], batch)
        return m["loss"]

    losses = [float(one_step()) for _ in range(2)]
    step_ms = []
    for _ in range(args.steps):
        sync(dev)
        t0 = time.perf_counter()
        losses.append(float(one_step()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    train = profiled(one_step, dev)

    params = {k: p.detach() for k, p in state["model"].named_parameters()}
    grads = {k: torch.randn(p.shape, generator=torch.Generator(device=dev).manual_seed(i), device=dev) * 1e-3
             for i, (k, p) in enumerate(params.items())}
    norm = profiled(lambda: TO.global_norm(grads), dev)
    upd = profiled(lambda: TO.adamw_update(opts.adamw, grads, state["opt"], params), dev)
    out = {"label": args.label, "arch": cfg.name, "device": str(dev), "batch": args.batch, "seq": args.seq,
           "params": sum(p.numel() for p in params.values()), "leaves": len(params),
           "losses": losses, "step_ms": step_ms, "median_step_ms": float(np.median(step_ms)),
           "train_step": train, "global_norm": norm, "adamw_update": upd}
    if dev.type == "cuda":
        out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                     capture_output=True, text=True, check=True).stdout.strip()
    assert all(np.isfinite(losses)), losses
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
