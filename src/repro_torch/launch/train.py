"""Training launcher: SAGe data pipeline -> LM -> fault-tolerant loop
(the port of ``src/repro/launch/train.py``), on the card unless asked for
the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m --steps 50 --batch 8 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 4 --batch 2 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b --smoke --device cpu --steps 4 --batch 2 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-moe-16b --smoke --device cpu --steps 4 --batch 2 --seq 64

``--arch`` (default ``mamba2-370m``) takes a configuration of the ssm,
dense, moe or hybrid family (mamba2-370m, qwen2-1.5b, yi-9b, yi-34b,
minitron-8b, deepseek-moe-16b, moonshot-v1-16b-a3b, zamba2-2.7b). The vlm
(qwen2-vl-72b) and encdec (whisper-small) families need image patches or
encoder frames beside the tokens, which the token pipeline does not make:
their first step raises ``ValueError`` naming the missing input (the JAX
package's launcher fails there too).
``--smoke`` trains the config's ``reduced()`` cut. Weights are drawn from a
``torch.Generator`` seeded with 0. The reads are encoded by the batched
``SageEncoder`` on ``--device`` into a ``SageTokenPipeline`` over a fused
session (k-mer tokens). ``--resume`` continues from the newest checkpoint
in ``--ckpt-dir``, which either package's trainer may have written. The
trainer draws its batches through :class:`PrefetchedBatches`, so a
checkpoint resumes at the first batch it did not train on.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_arch
from repro_torch.core import SageStore
from repro_torch.core.decode_torch import resolve_device
from repro_torch.core.encoder import SageEncoder
from repro_torch.data import SageTokenPipeline
from repro_torch.data.pipeline import prefetch_thread
from repro_torch.genomics.synth import make_reference, sample_read_set
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.steps import TrainOptions, init_train_state
from repro_torch.training.trainer import Trainer, TrainerConfig


def build_pipeline(vocab: int, batch: int, seq: int, ref_len: int = 80_000, depth: float = 4.0,
                   seed: int = 0, device="cuda") -> SageTokenPipeline:
    """Illumina reads over a synthetic reference, encoded on ``device`` and
    streamed as (tokens, labels) batches from a store on ``device``."""
    dev = resolve_device(device)
    ref = make_reference(ref_len, seed=seed)
    rs = sample_read_set(ref, "illumina", depth=depth, seed=seed + 1)
    sf = SageEncoder(ref, token_target=16384, device=dev).encode(rs)
    return SageTokenPipeline(sf, vocab, batch, seq, store=SageStore(device=dev))


class PrefetchedBatches:
    """A pipeline's batches, prefetched, with the cursor the trainer has reached.

    Iterating prefetches like ``pipe.prefetched()``, through the same
    :func:`~repro_torch.data.pipeline.prefetch_thread`, ``pipe.prefetch``
    batches deep from ``pipe.batches()``. The worker keeps with each batch
    the pipeline's state right after making it, and :meth:`state` returns
    the state of the last batch handed out, so a checkpoint that saves it
    resumes at the next batch the trainer has not seen. ``pipe.state()``
    alone is the cursor of the batches made so far, up to ``prefetch`` + 1
    ahead of the trainer. :meth:`restore` forwards to the pipeline and must
    come before the first batch is drawn.

    Pass it to ``Trainer`` as the data iterator and as ``pipeline=``."""

    def __init__(self, pipe) -> None:
        self.pipe = pipe
        self._stream = None
        self._state = None

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._stream is None:
            self._stream = self._prefetch()
        batch, self._state = next(self._stream)
        return batch

    def _prefetch(self):
        def with_state():
            for b in self.pipe.batches():
                yield b, self.pipe.state()
        return prefetch_thread(with_state(), self.pipe.prefetch)

    def state(self) -> dict:
        return self.pipe.state() if self._state is None else self._state

    def restore(self, state: dict) -> None:
        if self._stream is not None:
            raise RuntimeError("PrefetchedBatches.restore: batches were already drawn")
        self.pipe.restore(state)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--smoke", action="store_true", help="train the config's reduced() cut")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--compress", default=None)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    opts = TrainOptions(
        chunk=min(1024, args.seq),
        microbatch=args.microbatch,
        grad_compress=args.compress,
        adamw=AdamWConfig(lr=args.lr, total_steps=args.steps),
    )
    model, opt = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg, opts, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M vocab={cfg.vocab} device={dev}")

    pipe = build_pipeline(cfg.vocab, args.batch, args.seq, device=dev)
    tc = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir)
    feed = PrefetchedBatches(pipe)
    trainer = Trainer(tc, cfg, opts, model, opt, feed)
    trainer.install_signal_handler()
    if args.resume and trainer.maybe_resume(feed):
        print(f"resumed at step {trainer.step}")
    hist = trainer.run(pipeline=feed)
    if hist:
        print(f"final loss {hist[-1]['loss']:.4f} after {trainer.step} steps "
              f"(straggler anomalies: {trainer.monitor.anomalies})")


if __name__ == "__main__":
    main()
