"""Multi-pod dry run, the port of ``src/repro/launch/dryrun.py``: trace every
(arch x shape x mesh) cell's step once at the production size and write the
roofline inputs of one rank.

Where ``repro`` lowers and compiles on 512 forced host devices and walks
the HLO, the port runs the step eagerly on one rank of a ``"fake"``
process group (``FakeStore``, 256 ranks for one pod, 512 for two) under
``FakeTensorMode``: the collectives go nowhere, the tensors are shapes
without memory. ``launch/op_cost.py`` counts the rank's FLOPs, bytes and
collective bytes over the dispatched ops, and ``MemTracker``
(``torch.distributed._tools.mem_tracker``) its peak memory. The kernel
wrappers take their plain versions on the fake CPU tensors, so B6 and the
attention count the plain arithmetic, not the CUDA kernels; the fused
SAGe decode (``--sage-fused``) is given by shape (``launch/specs.py``).
The roofline terms use the H100 SXM data-sheet rates of
``launch/mesh.py``: a collective whose group stays inside one 8-GPU node
moves at NVLink's rate, one whose group spans nodes (on the production
mesh, every group of the 16-rank data and model axes) at the rate of a
GPU's InfiniBand port. The numbers are estimates from shapes, not
measurements, and are not XLA's: ``cost_source`` says where they come
from.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]

Artifacts: one JSON a cell under ``build/dryrun_torch/`` (``--out``).
Run it as a process of its own: it starts a process group of 256 or 512
fake ranks.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape
from repro_torch.training.steps import TrainOptions

OUT = "build/dryrun_torch"
COST_SOURCE = ("torch dispatch: one rank's aten ops under FakeTensorMode on a fake process group "
               "(launch/op_cost.py; flops = flop_counter's product formulas, bytes = unfused operand + result "
               "bytes, collectives = c10d ops by result bytes), peak from MemTracker; the kernels' plain "
               "versions run (fake tensors lie on the CPU device); H100 SXM data-sheet rates, collectives "
               "at NVLink's 450 GB/s inside an 8-GPU node and at 50 GB/s (a GPU's 400 Gb/s InfiniBand port) "
               "where their group spans nodes")


def model_flops(cfg, cell) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (forward only), N the active
    parameters, as ``repro`` counts them."""
    n = cfg.n_active_params()
    if cell.kind == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch  # decode: one token a sequence


def _tag(arch: str, shape: str, multi_pod: bool, suffix: str) -> str:
    return f"{arch}_{shape}_{'pod2' if multi_pod else 'pod1'}{suffix}.json"


def _world(n: int) -> None:
    """A fake process group of ``n`` ranks (this process is rank 0)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _peak_tracker():
    """``MemTracker`` keeping its device totals only. Its per-module
    statistics take a layer's second call outside a backward for a second
    iteration, and the step calls each layer once a microbatch."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class PeakTracker(MemTracker):
        def _pre_fw_hook(self, module, inputs) -> None:
            pass

        def _post_fw_hook(self, module, inputs, outputs) -> None:
            pass

        def _pre_bw_hook(self, module, args) -> None:
            pass

        def _post_bw_hook(self, module, args) -> None:
            pass

    return PeakTracker()


def run_cell(arch: str, shape: str, multi_pod: bool, opts: TrainOptions, out_dir: Path, verbose: bool = True,
             seq_shard: bool = True, tag_suffix: str = "", pure_dp: bool = False, dp_compress: str = "",
             sage_fused: bool = False) -> dict:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.sharding import Rules, use_rules
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import (H100_HBM_BYTES_PER_S, H100_NODE_LINK_BYTES_PER_S, H100_NVLINK_BYTES_PER_S,
                                         H100_PEAK_FLOPS_BF16, make_production_mesh)
    from repro_torch.launch.op_cost import OpCounter

    cfg = get_arch(arch)
    cell = get_shape(shape)
    out_dir.mkdir(parents=True, exist_ok=True)
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        rec = {"arch": arch, "shape": shape, "multi_pod": multi_pod, "status": "skipped",
               "reason": "full-attention arch; 500k decode needs sub-quadratic attention (DESIGN.md §4)"}
        (out_dir / _tag(arch, shape, multi_pod, tag_suffix)).write_text(json.dumps(rec, indent=1))
        return rec
    _world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    # SP (the activations' sequence over the model axis) only helps token-parallel steps
    sp = seq_shard and cell.kind in ("train", "prefill") and not pure_dp
    rules = Rules(mesh, data_axes=("pod", "data") if multi_pod else ("data",), seq_shard=sp, pure_dp=pure_dp)
    chips = mesh.size()
    t0 = time.time()
    counter = OpCounter()
    mem = _peak_tracker()
    with FakeTensorMode(), use_rules(rules):
        if sage_fused:
            fn, args = specs.build_sage_fused_case(cfg, cell, rules, opts, counter=counter)
        elif dp_compress:
            fn, args = specs.build_dp_compressed_case(cfg, cell, rules, opts, dp_compress)
        else:
            fn, args = specs.build_case(cfg, cell, rules, opts)
        t_build = time.time() - t0
        mem.track_external(*(a for a in args if isinstance(a, torch.nn.Module)),
                           *(t for a in args if not isinstance(a, torch.nn.Module)
                             for t in torch.utils._pytree.tree_leaves(a) if isinstance(t, torch.Tensor)))
        t1 = time.time()
        with mem, counter:
            fn(*args)
        t_trace = time.time() - t1
    peak = mem.get_tracker_snapshot("peak")
    peak_bytes = max(v["Total"] for v in peak.values()) if peak else 0
    cost = counter.cost
    flops_dev, bytes_dev, coll_bytes_dev = float(cost.flops), float(cost.bytes), float(cost.collective_bytes)
    inter_dev = float(cost.coll_internode)
    coll = {k: float(v) for k, v in cost.coll.items()}
    coll.update({f"n_{k}": float(v) for k, v in cost.coll_n.items()})
    mf = model_flops(cfg, cell)
    rec = {
        "arch": arch, "shape": shape, "multi_pod": multi_pod, "chips": chips, "status": "ok",
        "t_build_s": round(t_build, 2), "t_trace_s": round(t_trace, 2),
        "peak_hbm_gb": round(peak_bytes / 2**30, 3),
        "hlo_flops_dev": flops_dev,
        "hlo_bytes_dev": bytes_dev,
        "collective_bytes_dev": coll_bytes_dev,
        "collective_bytes_internode_dev": inter_dev,
        "collectives": coll,
        "t_compute": flops_dev / H100_PEAK_FLOPS_BF16,
        "t_memory": bytes_dev / H100_HBM_BYTES_PER_S,
        "t_collective": (coll_bytes_dev - inter_dev) / H100_NVLINK_BYTES_PER_S + inter_dev / H100_NODE_LINK_BYTES_PER_S,
        "model_flops_total": mf,
        "model_flops_dev": mf / chips,
        "useful_flops_frac": (mf / chips) / flops_dev if flops_dev else 0.0,
        "cost_source": COST_SOURCE,
    }
    terms = {"compute": rec["t_compute"], "memory": rec["t_memory"], "collective": rec["t_collective"]}
    rec["bottleneck"] = max(terms, key=terms.get)
    rec["roofline_frac"] = ((mf / chips) / H100_PEAK_FLOPS_BF16) / max(max(terms.values()), 1e-30)
    rec["seq_shard"] = sp
    rec["options"] = {"grad_compress": opts.grad_compress, "microbatch": opts.microbatch, "chunk": opts.chunk,
                      "remat_policy": opts.remat_policy, "pure_dp": pure_dp, "dp_compress": dp_compress,
                      "sage_fused": sage_fused}
    if verbose:
        print(f"[{arch} x {shape} x {'2pod' if multi_pod else '1pod'}] trace={t_trace:.1f}s "
              f"peak_hbm={rec['peak_hbm_gb']}GB flops/dev={flops_dev:.3g} bneck={rec['bottleneck']} "
              f"useful={rec['useful_flops_frac']:.2f}", flush=True)
    (out_dir / _tag(arch, shape, multi_pod, tag_suffix)).write_text(json.dumps(rec, indent=1))
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--compress", default=None, help="grad compression: bf16|int16_ef")
    ap.add_argument("--microbatch", type=int, default=4, help="grad-accumulation steps (train cells)")
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--no-seq-shard", action="store_true", help="disable SP (baseline ablation)")
    ap.add_argument("--remat-policy", default="nothing", choices=["nothing", "dots"])
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--pure-dp", action="store_true", help="fold the model axis into DP (small models)")
    ap.add_argument("--dp-compress", default="", help="the explicit compressed DP step: int16_ef|bf16")
    ap.add_argument("--sage-fused", action="store_true", help="the SAGe decode on the device in front of the step")
    args = ap.parse_args()

    opts = TrainOptions(grad_compress=args.compress, microbatch=args.microbatch, chunk=args.chunk,
                        remat_policy=args.remat_policy)
    out = Path(args.out)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")

    failures = []
    for arch, shape in cells:
        for mp in meshes:
            try:
                run_cell(arch, shape, mp, opts, out, seq_shard=not args.no_seq_shard, tag_suffix=args.tag,
                         pure_dp=args.pure_dp, dp_compress=args.dp_compress, sage_fused=args.sage_fused)
            except Exception as e:  # noqa: BLE001 — record the cell, go on with the sweep
                traceback.print_exc()
                failures.append((arch, shape, mp, str(e)))
                out.mkdir(parents=True, exist_ok=True)
                (out / _tag(arch, shape, mp, args.tag)).write_text(json.dumps({
                    "arch": arch, "shape": shape, "multi_pod": mp, "status": "failed", "error": str(e)[:2000],
                }, indent=1))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall cells OK")


if __name__ == "__main__":
    main()
