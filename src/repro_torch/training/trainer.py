"""Fault-tolerant training loop (the port of ``src/repro/training/trainer.py``).

Atomic, async checkpoints with resume (parameters, AdamW state and the data
pipeline's cursor, saved in the JAX package's layout, so either package
resumes the other's run), SIGTERM/SIGINT -> final checkpoint -> clean exit,
a straggler monitor on the step time, and a NaN-loss circuit breaker
(skip and count, within a budget, rather than corrupt the run).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.convert import train_state_from_reference, train_state_to_reference
from repro_torch.training.steps import TrainOptions, make_train_step


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker; flags anomalously slow steps.

    On a real cluster the hook triggers mitigation (re-route data fetch,
    mark host suspect, pre-emptively checkpoint); here it logs + counts."""

    alpha: float = 0.1
    threshold: float = 2.5
    warmup: int = 5
    _ewma: float = 0.0
    _n: int = 0
    anomalies: int = 0
    hook: Optional[Callable[[int, float, float], None]] = None

    def observe(self, step: int, dt: float) -> bool:
        self._n += 1
        if self._n <= self.warmup:
            self._ewma = dt if self._ewma == 0 else (1 - self.alpha) * self._ewma + self.alpha * dt
            return False
        slow = dt > self.threshold * self._ewma
        if slow:
            self.anomalies += 1
            if self.hook:
                self.hook(step, dt, self._ewma)
        else:
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * dt
        return slow


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: str = "checkpoints"
    keep_last: int = 3
    max_nan_skips: int = 5


class Trainer:
    """Runs ``make_train_step(arch_cfg, opts)`` over ``data_iter`` (dicts
    of host arrays) on the model's device."""

    def __init__(self, cfg: TrainerConfig, arch_cfg, opts: TrainOptions, model, opt: dict, data_iter,
                 ckpt: Optional[CheckpointManager] = None):
        self.cfg = cfg
        self.arch = arch_cfg
        self.step_fn = make_train_step(arch_cfg, opts)
        self.model, self.opt = model, opt
        self.device = next(model.parameters()).device
        self.data = data_iter
        self.ckpt = ckpt or CheckpointManager(cfg.ckpt_dir, keep_last=cfg.keep_last)
        self.monitor = StragglerMonitor()
        self.step = 0
        self.history: list[dict] = []
        self._stop = False
        self._nan_skips = 0

    # ------------------------------------------------------------ lifecycle
    def install_signal_handler(self) -> None:
        def handler(signum, frame):  # pragma: no cover
            self._stop = True

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    def maybe_resume(self, pipeline=None) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        like = train_state_to_reference(self.arch, self.model, self.opt, shapes_only=True)
        restored, extra, step = self.ckpt.restore(like)
        sd, opt = train_state_from_reference(self.arch, restored["params"], restored["opt"])
        self.model.load_state_dict(sd)
        self.opt = {k: ({n: t.to(self.device) for n, t in v.items()} if isinstance(v, dict) else v.to(self.device))
                    for k, v in opt.items()}
        self.step = step
        if pipeline is not None and "pipeline" in extra:
            pipeline.restore(extra["pipeline"])
        return True

    # ------------------------------------------------------------------ run
    def run(self, pipeline=None) -> list[dict]:
        while self.step < self.cfg.total_steps and not self._stop:
            batch = next(self.data)
            t0 = time.time()
            batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
            self.model, self.opt, metrics = self.step_fn(self.model, self.opt, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if not np.isfinite(loss):  # the step applied nothing
                self._nan_skips += 1
                if self._nan_skips > self.cfg.max_nan_skips:
                    raise FloatingPointError(f"loss non-finite {self._nan_skips}x — aborting")
                continue
            self.step += 1
            self.monitor.observe(self.step, dt)
            if self.step % self.cfg.log_every == 0 or self.step == 1:
                rec = {"step": self.step, "loss": loss, "dt": dt,
                       "grad_norm": float(metrics.get("grad_norm", 0.0))}
                self.history.append(rec)
                print(f"step {self.step:5d}  loss {loss:.4f}  {dt*1000:.0f} ms")
            if self.step % self.cfg.ckpt_every == 0:
                self._save(pipeline)
        self._save(pipeline, block=True)  # final / preemption checkpoint
        return self.history

    def _save(self, pipeline, block: bool = False) -> None:
        extra = {"history": self.history[-5:]}
        if pipeline is not None:
            extra["pipeline"] = pipeline.state()
        state = train_state_to_reference(self.arch, self.model, self.opt)
        self.ckpt.save(self.step, state, extra=extra, block=block)
