"""Serving launcher: mixed SAGe traffic through the SageServer frontend (the
port of ``src/repro/launch/serve.py``), on the card unless asked for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --requests 16 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --requests 4 --max-new 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --requests 8 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b --smoke --device cpu --requests 4 --max-new 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small --device cpu --requests 4 --max-new 8

``--arch`` (default ``mamba2-370m``) takes any configuration of the
registry (mamba2-370m, qwen2-1.5b, yi-9b, yi-34b, minitron-8b,
deepseek-moe-16b, moonshot-v1-16b-a3b, zamba2-2.7b, whisper-small,
qwen2-vl-72b). The engine passes zero frames of (B, max_prompt, d_model)
to the encdec and vlm families, as the JAX package's does: whisper-small
serves, and qwen2-vl-72b's generate requests fail with ``ValueError``
(its max_prompt patches and max_prompt tokens do not fit a cache of
max_prompt + max_new + 1 slots), which the launcher raises, as the JAX
package's launcher does. ``--smoke`` serves the config's ``reduced()`` cut. Weights are drawn from a
``torch.Generator`` seeded with 0. ``--frontend`` (default) drives
the full scheduler + continuous-batching stack; ``--no-frontend`` keeps the
bare engine path (one padded batch of ``prompts_from_store`` prompts) for
A/B comparison.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.core.decode_torch import resolve_device
from repro_torch.genomics.synth import make_reference, sample_read_set
from repro_torch.models import lm
from repro_torch.serving import (
    SageServer,
    ServeConfig,
    ServingEngine,
    SessionPool,
    prompts_from_store,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--smoke", action="store_true", help="serve the config's reduced() cut")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-prompt", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--frontend", action=argparse.BooleanOptionalAction, default=True,
                    help="route through the SageServer scheduler/batcher")
    ap.add_argument("--policy", choices=("cache_aware", "fcfs"), default="cache_aware")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    eng = ServingEngine(cfg, model, ServeConfig(
        max_prompt=args.max_prompt, max_new=args.max_new, temperature=args.temperature))

    # prompts straight from SAGe-compressed storage (SAGe_Read -> KMER)
    ref = make_reference(40_000, seed=3)
    rs = sample_read_set(ref, "illumina", depth=1, seed=4, max_reads=args.requests * 2)
    pool = SessionPool(device=dev)
    pool.write("serve", rs, ref, token_target=8192)

    if not args.frontend:
        prompts = prompts_from_store(
            pool.session(), "serve", vocab=cfg.vocab, n_prompts=args.requests,
            max_prompt=args.max_prompt, kmer_k=3,
        )
        t0 = time.perf_counter()
        outs = eng.generate(prompts)
        dt = time.perf_counter() - t0
        n_tok = sum(o.size for o in outs)
        print(f"served {len(prompts)} requests / {n_tok} tokens in {dt:.2f}s (first call)")
        t0 = time.perf_counter()
        eng.generate(prompts)
        print(f"steady-state: {n_tok / (time.perf_counter() - t0):.0f} tok/s on {dev}")
        return

    srv = SageServer(pool, engine=eng, policy=args.policy)
    nb = pool.store.n_blocks("serve")
    t0 = time.perf_counter()
    gens = [
        srv.generate(dataset="serve", block_range=(i % nb, i % nb + 1),
                     max_prompt=args.max_prompt, kmer_k=3)
        for i in range(args.requests)
    ]
    reads = [srv.read("serve", (i % nb, i % nb + 1)) for i in range(args.requests)]
    srv.run_until_idle()
    dt = time.perf_counter() - t0
    n_tok = sum(g.result(timeout=0)["tokens"].size for g in gens)
    if any(r.result(timeout=0) is None for r in reads):
        raise RuntimeError("a read request was aborted")
    st = srv.stats()
    print(
        f"served {st['scheduler']['finished']} mixed requests "
        f"({len(gens)} generate / {n_tok} tokens, {len(reads)} reads) in "
        f"{dt:.2f}s incl. first calls; {st['batcher']['fused_reads']} fused "
        f"decodes, {st['batcher']['generate_batches']} LM batches"
    )
    t0 = time.perf_counter()
    for i in range(args.requests):
        srv.read("serve", (i % nb, i % nb + 1))
    srv.run_until_idle()  # each fused decode ends in its host copy
    print(f"steady-state reads: {args.requests / (time.perf_counter() - t0):.0f} req/s on {dev}")


if __name__ == "__main__":
    main()
