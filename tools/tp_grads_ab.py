"""Tensor parallelism's gradients against the plain step's on the card.

mamba2-370m at full width (and 2- and 8-layer cuts), f32 activations, one
(8, 512) batch of k-mer-like ids (uniform over the 4^7 ids a k = 7 stream
yields, seeded numpy), weights from a seeded generator: the loss and every
parameter's gradient of ``training.steps._grads`` (no optimizer) with the
parameters as DTensors on a (data 1, model 1) mesh of a world-size-1 NCCL
group under ``Rules(seq_shard=True)``, against the plain step's. Cases:
plain against plain (determinism), TP against plain with B6's kernels,
B6's plain version against its kernel (both plain), TP against plain with
B6's plain version on both sides. One JSON line a case: the loss, the
grad_norm's relative difference, the worst leaves as max error over
max|leaf|, each layer's worst, the embedding's worst rows with their
token counts.

    python3 tools/tp_grads_ab.py        # on a machine with one card, ~75 s
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main() -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    import chip_smoke as CS
    from repro_torch.distributed.sharding import Rules, distribute_model, is_dtensor, use_rules
    from repro_torch.kernels import cuda_lib
    from repro_torch.training import steps as TS
    from train_cases import f32_forward

    if not torch.cuda.is_available():
        sys.exit("tp_grads_ab: needs a CUDA device")
    print(CS.smi(), flush=True)
    cuda_lib.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    CS.WORK.mkdir(parents=True, exist_ok=True)
    (CS.WORK / "nccl_tp_grads").unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(CS.WORK / "nccl_tp_grads"), 1), rank=0, world_size=1)
    rules = Rules(init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model")), seq_shard=True)
    full = CS.get_arch("mamba2-370m")
    t = np.random.default_rng(3).integers(0, 4**7, (8, 513)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(t[:, :-1]).to(dev), "labels": torch.from_numpy(t[:, 1:]).to(dev)}
    opts = CS.TrainOptions(adamw=CS.AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=2))
    on_cpu = cuda_lib.on_cpu

    def grads(cfg, tp: bool, plain_b6: bool = False):
        model = CS.lm.init_params(torch.Generator(device=dev).manual_seed(21), cfg, device=dev)
        cuda_lib.on_cpu = (lambda *ts: True) if plain_b6 else on_cpu  # the plain versions, on the card
        try:
            with f32_forward():
                if tp:
                    distribute_model(model, rules)
                    with use_rules(rules):
                        bt = {k: distribute_tensor(v, rules.mesh, rules.spec("tokens"), src_data_rank=None)
                              for k, v in batch.items()}
                        loss, _m, g = TS._grads(model, cfg, bt, opts)
                else:
                    loss, _m, g = TS._grads(model, cfg, batch, opts)
        finally:
            cuda_lib.on_cpu = on_cpu
        g = {k: (v.full_tensor() if is_dtensor(v) else v).detach().clone() for k, v in g.items()}
        del model
        torch.cuda.empty_cache()
        return float(loss), g

    def compare(name, a, b) -> None:
        (la, ga), (lb, gb) = a, b
        rel, over, layer = {}, {}, {}
        for k in gb:
            top = float(gb[k].abs().max())
            err = (ga[k] - gb[k]).abs()
            rel[k] = float(err.max()) / max(top, 1e-30)
            over[k] = int((err > 1e-4 * top).sum())
            if k.startswith("layers."):
                i = int(k.split(".")[1])
                layer[i] = max(layer.get(i, 0.0), rel[k])
        gna, gnb = (float(torch.sqrt(sum((v.double() ** 2).sum() for v in g.values()))) for g in (ga, gb))
        e = (ga["embed"] - gb["embed"]).abs().amax(1)
        cnt = torch.bincount(batch["tokens"].reshape(-1).long(), minlength=gb["embed"].shape[0])
        print(json.dumps({
            "case": name, "loss": [la, lb], "loss_rel": abs(la - lb) / abs(lb), "grad_norm_rel": abs(gna - gnb) / gnb,
            "worst": sorted(rel.items(), key=lambda kv: -kv[1])[:8],
            "elements_over_1e-4": {k: n for k, n in over.items() if n},
            "layer_max_rel": [layer[i] for i in sorted(layer)],
            "embed_max": float(gb["embed"].abs().max()),
            "embed_rows": [{"row": i, "err": float(e[i]), "row_max": float(gb["embed"][i].abs().max()),
                            "count": int(cnt[i])} for i in torch.topk(e, 5).indices.tolist()]}), flush=True)

    t0 = time.perf_counter()
    try:
        plain = grads(full, False)
        compare("plain vs plain (determinism), 48 layers", grads(full, False), plain)
        compare("tp vs plain, 48 layers, B6 kernels", grads(full, True), plain)
        plain_b6 = grads(full, False, plain_b6=True)
        compare("plain B6-plain vs plain B6-kernel, 48 layers", plain_b6, plain)
        compare("tp vs plain, 48 layers, B6 plain on both", grads(full, True, plain_b6=True), plain_b6)
        del plain, plain_b6
        for n in (2, 8):
            cut = dataclasses.replace(full, n_layers=n)
            compare(f"tp vs plain, {n} layers, B6 kernels", grads(cut, True), grads(cut, False))
    finally:
        dist.destroy_process_group()
    print(f"seconds {time.perf_counter() - t0:.1f}", flush=True)


if __name__ == "__main__":
    main()
