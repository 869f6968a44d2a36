"""Multi-tenant serving with the PyTorch port: mixed SAGe traffic through
the SageServer frontend on the card.

The paper's SAGe_Read/SAGe_ISP contract — decoded reads flow straight from
the store into the analysis system — served to many concurrent tenants:
ranged decodes, consensus windows, a streaming analysis feed, and genomic
LM continuations (``--arch``: mamba2-370m by default, or a dense, moe,
hybrid or encdec configuration such as qwen2-1.5b, deepseek-moe-16b,
zamba2-2.7b or whisper-small, which the engine gives zero frames; the vlm
family's default patches do not fit the cache and its generate requests
fail, as in the JAX package) all share one scheduler,
one continuous-batch loop, and one device-resident store.

  PYTHONPATH=src python examples/serve_genomic_lm_torch.py               # full width, on the card
  PYTHONPATH=src python examples/serve_genomic_lm_torch.py --device cpu  # reduced(), plain versions
  PYTHONPATH=src python examples/serve_genomic_lm_torch.py --arch zamba2-2.7b --device cpu
  PYTHONPATH=src python examples/serve_genomic_lm_torch.py --arch deepseek-moe-16b --device cpu
  PYTHONPATH=src python examples/serve_genomic_lm_torch.py --arch whisper-small --device cpu
"""

import argparse
import sys
import time

sys.path.insert(0, "src")

import torch

from repro_torch.configs import get_arch
from repro_torch.core.decode_torch import reset_trace_counts, trace_counts
from repro_torch.genomics.synth import make_reference, sample_read_set
from repro_torch.models import lm
from repro_torch.serving import SageServer, ServeConfig, ServingEngine, SessionPool


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--arch", default="mamba2-370m", help="an ssm, dense, moe, hybrid or encdec configuration")
    args = ap.parse_args()
    dev = torch.device(args.device)
    cfg = get_arch(args.arch)
    if dev.type == "cpu":
        cfg = cfg.reduced()  # full width is for the card
    model = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    eng = ServingEngine(cfg, model, ServeConfig(max_prompt=48, max_new=16))
    print(f"=== SageServer (PyTorch port, {args.device}): {cfg.name}, {cfg.n_layers} layers ===")

    ref = make_reference(30_000, seed=31)
    rs = sample_read_set(ref, "illumina", depth=1, seed=32, max_reads=64)
    pool = SessionPool(device=dev)
    pool.write("serve", rs, ref, token_target=8192)  # SAGe_Write
    srv = SageServer(pool, engine=eng)
    nb = pool.store.n_blocks("serve")

    # a mixed-tenant burst: decodes + consensus + a stream + 4 generations
    reset_trace_counts()
    t0 = time.time()
    reads = [srv.read("serve", (0, 2), fmt="kmer", kmer_k=4) for _ in range(4)]
    cons = srv.consensus("serve")
    isp = srv.stream("serve", blocks_per_fetch=1, max_fetches=min(3, nb))
    gens = [
        srv.generate(dataset="serve", block_range=(b % nb, b % nb + 1),
                     max_prompt=48, kmer_k=3)
        for b in range(4)
    ]
    srv.run_until_idle()
    dt = time.time() - t0

    n_new = sum(g.result(timeout=0)["tokens"].size for g in gens)
    n_chunks = sum(1 for _ in isp.chunks(timeout=0))
    assert all(r.result(timeout=0) is not None for r in reads)
    st = srv.stats()
    print(
        f"served {st['scheduler']['finished']} requests in {dt:.2f}s "
        f"(first calls included): {len(reads)} reads, 1 consensus "
        f"({cons.result(timeout=0)['windows'].shape[0]} windows), {n_chunks} stream "
        f"chunks, {len(gens)} generations / {n_new} new tokens"
    )
    print(
        f"fused {st['batcher']['fused_read_requests']} read requests into "
        f"{st['batcher']['fused_reads']} decodes; prepared-LRU "
        f"{st['pool']['cache']['total']}; launches {trace_counts()}"
    )
    assert n_new == len(gens) * eng.sc.max_new and n_chunks == min(3, nb)

    # steady state: the same burst again — everything is resident
    t0 = time.time()
    for _ in range(4):
        srv.read("serve", (0, 2), fmt="kmer", kmer_k=4)
    srv.stream("serve", blocks_per_fetch=1, max_fetches=min(3, nb))
    srv.run_until_idle()
    print(f"steady-state burst: {time.time() - t0:.3f}s")


if __name__ == "__main__":
    main()
