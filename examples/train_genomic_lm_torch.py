"""End-to-end example with the PyTorch port: train a genomic LM on
SAGe-prepared tokens, with checkpoints and resume (the torch twin of
examples/train_genomic_lm.py).

By default a reduced mamba2-370m (4 layers, d_model 256) trains on the card;
``--arch`` takes a dense, moe or hybrid configuration instead (qwen2-1.5b,
deepseek-moe-16b, moonshot-v1-16b-a3b, zamba2-2.7b, ...), ``--full`` the
full architecture, ``--device cpu`` the
plain torch versions on the CPU. A second run with the same ``--ckpt-dir`` resumes from
the newest checkpoint (parameters, AdamW state and the data cursor).

  PYTHONPATH=src python examples/train_genomic_lm_torch.py --steps 300
  PYTHONPATH=src python examples/train_genomic_lm_torch.py --device cpu --steps 60 --seq 128
  PYTHONPATH=src python examples/train_genomic_lm_torch.py --arch qwen2-1.5b --device cpu --steps 60 --seq 128
  PYTHONPATH=src python examples/train_genomic_lm_torch.py --arch deepseek-moe-16b --device cpu --steps 60 --seq 128
"""

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile

sys.path.insert(0, "src")

import torch

from repro_torch.configs import get_arch
from repro_torch.core import SageStore
from repro_torch.core.decode_torch import reset_trace_counts, resolve_device, trace_counts
from repro_torch.data import SageTokenPipeline
from repro_torch.genomics.synth import make_reference, sample_read_set
from repro_torch.launch.train import PrefetchedBatches
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.steps import TrainOptions, init_train_state
from repro_torch.training.trainer import Trainer, TrainerConfig


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--arch", default="mamba2-370m", help="an ssm, dense, moe or hybrid configuration")
    ap.add_argument("--full", action="store_true", help="the full architecture")
    ap.add_argument("--dmodel", type=int, default=256, help="reduced width")
    ap.add_argument("--layers", type=int, default=4, help="reduced depth")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "genomic_lm_torch_ckpt"))
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = dataclasses.replace(cfg.reduced(), n_layers=args.layers, d_model=args.dmodel,
                                  d_inner=2 * args.dmodel, vocab=4**4 + 3)
    opts = TrainOptions(chunk=min(512, args.seq),
                        adamw=AdamWConfig(lr=1e-3, total_steps=args.steps, warmup_steps=20))
    model, opt = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg, opts, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"training {cfg.name} ({dev}): {n_params/1e6:.1f}M params on SAGe-prepared genomic tokens")

    # small genome + deep coverage => the LM sees each locus many times per
    # epoch and measurably learns it; the reads go through SAGe_Write (the
    # batched encoder on the device) into a v2 block-extent container, and
    # the pipeline streams block groups from it through a fused session
    ref = make_reference(24_000, seed=1)
    rs = sample_read_set(ref, "illumina", depth=10, seed=2)
    store = SageStore(group_blocks=8, device=dev)
    v2_path = os.path.join(tempfile.mkdtemp(prefix="sage_lm_torch_"), "train.sage2")
    sf = store.write("train", rs, ref, token_target=16384, layout="v2", path=v2_path)
    pipe = SageTokenPipeline("train", cfg.vocab, args.batch, args.seq, store=store)
    ratio = rs.n_bases / sf.compressed_bytes(include_consensus=False)
    print(f"data: {rs.n_bases/1e6:.1f} Mbases, SAGe ratio {ratio:.1f}x, k={pipe.k}, container {v2_path}")

    tc = TrainerConfig(total_steps=args.steps, ckpt_every=max(args.steps // 3, 50),
                       log_every=20, ckpt_dir=args.ckpt_dir)
    feed = PrefetchedBatches(pipe)  # its checkpoints keep the cursor of the batches trained on
    trainer = Trainer(tc, cfg, opts, model, opt, feed)
    trainer.install_signal_handler()
    if trainer.maybe_resume(feed):
        print(f"resumed from step {trainer.step}")
    reset_trace_counts()
    hist = trainer.run(pipeline=feed)
    counts = trace_counts()
    l0, l1 = hist[0]["loss"], hist[-1]["loss"]
    print(f"loss {l0:.3f} -> {l1:.3f} over {trainer.step} steps")
    print("kernel calls: " + ", ".join(f"{k} {v}" for k, v in sorted(counts.items())))
    io = pipe.io_stats
    print(f"io_stats: {io['extent_reads']} ranged reads, {io['extent_bytes_read']/1e6:.2f} MB extents "
          f"read, host cache peak {io['cache_peak_bytes']/1e6:.2f} MB, whole-file loads: "
          f"{io['container_loads']}")
    shutil.rmtree(os.path.dirname(v2_path), ignore_errors=True)
    assert l1 < l0, "training must reduce loss"


if __name__ == "__main__":
    main()
