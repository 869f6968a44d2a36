"""Serving entry point: the SAGe production frontend + the LM engine (the
port of ``src/repro/serving/engine.py``).

:func:`prompts_from_store` turns decoded reads of a stored dataset into
k-mer token prompts. :class:`ServingEngine` runs padded-slot prefill and a
decode loop over one model (greedy or temperature sampling) on the device
of the model's parameters.

:class:`SageServer` is the multi-tenant front door, wiring the serving
subsystem together::

        submit()            Scheduler (serving/scheduler.py)
    client ──────> waiting queue ──admit──> running set
                                             │ continuous batches
                                             v
                   ContinuousBatcher (serving/batching.py)
                     fused bucketed SAGe_Read / consensus / ISP chunks
                     + padded-batch LM generation
                                             │
                   SessionPool (serving/session_pool.py)
                     one shared SageStore: block-granular device LRU,
                     host extent cache, per-decode-path sessions
                                             │
    client <──── ResponseHandle.chunks() ────┘  (streaming, abortable,
                                                 backpressured)

Every decoded chunk flows to its requesting tenant as soon as its fused
batch lands (the paper's "send each read to the analysis system as soon
as it is decoded", §5.1, made multi-tenant), and hot datasets stay
resident on the device across all of them.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.api import get_format, pick_k
from repro_torch.core.store import SageStore
from repro_torch.models import lm
from repro_torch.serving.batching import ContinuousBatcher
from repro_torch.serving.scheduler import (
    Request,
    RequestState,
    ResponseHandle,
    Scheduler,
)
from repro_torch.serving.session_pool import SessionPool


def prompts_from_store(
    session,
    name: str,
    *,
    vocab: int,
    n_prompts: int = 8,
    max_prompt: int = 64,
    kmer_k: Optional[int] = None,
    block_range=None,
) -> list[np.ndarray]:
    """SAGe_Read -> serving prompt feed: decoded reads of a stored dataset as
    k-mer token prompts (the paper's "send each read to the analysis system
    as soon as it is decoded" contract, §5.1).

    Walks the requested block range in order and emits one prompt per read
    (its k-mer token prefix, folded into ``vocab``) until ``n_prompts``.
    Fewer than ``n_prompts`` reads yields fewer prompts; reads shorter than
    one k-mer are skipped (a range of only those yields ``[]``); prompts
    truncate to their first ``max_prompt`` k-mers — the same prefix
    :meth:`ServingEngine.generate` keeps when a prompt overflows its slot."""
    k = kmer_k if kmer_k is not None else pick_k(vocab)
    out = session.read(name, block_range, fmt="kmer", kmer_k=k)
    km = out["kmer"]  # stays on the device
    starts, lens = out["read_start"].cpu().numpy(), out["read_len"].cpu().numpy()
    n_reads = out["n_reads"].cpu().numpy()
    # one indexed gather over (read_start, read_len): enumerate real reads in
    # (block, read) order, apply the n_prompts cutoff, and pull every
    # prompt's k-mer span out of the device tensor at once; the only large
    # host copy is the gathered prompt tokens themselves
    n_r = np.minimum(n_reads, starts.shape[1])
    keep = np.arange(starts.shape[1])[None, :] < n_r[:, None]
    keep &= lens // k > 0  # zero-k-mer reads are skipped, not emitted
    bi, ri = np.nonzero(keep)  # row-major == (block, read) order
    bi, ri = bi[:n_prompts], ri[:n_prompts]
    if bi.size == 0:
        return []
    starts_k = starts[bi, ri] // k
    spans = np.minimum(lens[bi, ri] // k, max_prompt)
    ends = np.cumsum(spans)
    offs = ends - spans
    row = np.repeat(bi, spans)
    col = starts_k.repeat(spans) + np.arange(ends[-1]) - offs.repeat(spans)
    idx = [torch.as_tensor(a, dtype=torch.int64, device=km.device) for a in (row, col)]
    flat = (km[idx[0], idx[1]] % vocab).to(torch.int32).cpu().numpy()
    return [flat[o:e] for o, e in zip(offs, ends)]


@dataclasses.dataclass
class ServeConfig:
    max_prompt: int = 512
    max_new: int = 64
    temperature: float = 0.0  # 0 => greedy
    seed: int = 0


class ServingEngine:
    """Padded-slot prefill + decode loop over one model of any family
    (``lm.init_params``: ssm, dense, vlm, moe, hybrid or encdec; it builds
    on ``cuda`` unless asked for the CPU), on the device of its
    parameters. The prompts are left-padded into their slots; the pad
    positions are valid attention keys, as in the JAX package.

    Each engine owns its own :class:`ServeConfig` (``sc=None`` constructs a
    per-instance default — a shared default instance would alias sampling
    state across every engine in the process). Sampling draws from a
    ``torch.Generator`` seeded with ``sc.seed``; its bits differ from
    ``jax.random``'s, greedy decoding does not depend on them."""

    def __init__(self, cfg, model: torch.nn.Module, sc: Optional[ServeConfig] = None) -> None:
        self.cfg = cfg
        self.model = model
        self.sc = sc if sc is not None else ServeConfig()
        self.device = model.embed.device

    def _sample(self, lg: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        """Next-token selection — the ONE temperature guard both prefill
        sampling and the decode loop share (greedy at 0; the 1e-6 floor
        keeps a denormal temperature from blowing up the logit scale)."""
        if self.sc.temperature > 0:
            probs = torch.softmax(lg / max(self.sc.temperature, 1e-6), dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            nxt = torch.argmax(lg, dim=-1)
        return nxt.to(torch.int32)

    @torch.no_grad()
    def generate(self, prompts: list[np.ndarray], frames=None) -> list[np.ndarray]:
        """prompts: list of int32 token arrays (longer than ``max_prompt``
        keeps the first ``max_prompt`` tokens — prefix truncation, matching
        ``prompts_from_store``). Returns ``max_new`` tokens per prompt,
        copied to the host once at the end.

        ``frames`` (B, T, d_model; host array or tensor) are the encdec
        family's encoder input and the vlm family's patch embeddings; by
        default zeros of (B, max_prompt, d_model) in f32, as in the JAX
        package. The cache holds ``max_prompt + max_new + 1`` slots, so a
        vlm prefill of T patches and ``max_prompt`` tokens must fit it, and
        the encdec family's T frames too (else ``ValueError``). Decode
        steps go on at position ``max_prompt + t`` whatever the prefix
        held, as the JAX package's loop does."""
        B = len(prompts)
        if B == 0:
            return []
        P = self.sc.max_prompt
        toks = np.zeros((B, P), np.int32)
        for i, p in enumerate(prompts):
            p = p[:P]
            toks[i, -len(p):] = p  # left-pad (keeps last token at P-1)
        max_len = P + self.sc.max_new + 1
        kw = {}
        if self.cfg.family in ("encdec", "vlm"):
            if frames is None:
                frames = torch.zeros((B, P, self.cfg.d_model), dtype=torch.float32, device=self.device)
            key = "frames" if self.cfg.family == "encdec" else "patch_embeds"
            kw[key] = torch.as_tensor(frames, device=self.device)
        tok = torch.as_tensor(toks, dtype=torch.int64, device=self.device)
        logits, cache = lm.prefill(self.model, self.cfg, tok, max_len, **kw)
        gen = torch.Generator(device=self.device).manual_seed(self.sc.seed)
        cur = self._sample(logits[:, -1].float(), gen)[:, None]
        outs = [cur]
        for t in range(self.sc.max_new - 1):
            logits, cache = lm.decode_step(self.model, self.cfg, cur.long(), cache, P + t)
            cur = self._sample(logits[:, -1].float(), gen)[:, None]
            outs.append(cur)
        gen_toks = torch.cat(outs, dim=1).cpu().numpy()
        return [gen_toks[i] for i in range(B)]


class SageServer:
    """The serving frontend: ingestion + scheduling + continuous batching
    over one shared SageStore.

    ``policy`` picks admission order (``"cache_aware"`` default,
    ``"fcfs"``); ``max_waiting`` bounds the ingestion queue (backpressure);
    ``max_batch_requests``/``max_batch_bytes``/``max_union_blocks`` shape
    the batcher's rounds. Reads decode through the pool's two-step session
    on the store's device (``cuda`` unless the store was built for the
    CPU); served chunks are host arrays. Drive it synchronously (``step`` /
    ``run_until_idle`` — deterministic, what the tests and benches use) or
    in the background (``start``/``stop`` or a ``with`` block) so clients
    block only on their own handles."""

    def __init__(
        self,
        pool: Optional[SessionPool] = None,
        *,
        store: Optional[SageStore] = None,
        engine: Optional[ServingEngine] = None,
        policy: str = "cache_aware",
        max_waiting: int = 64,
        max_batch_requests: int = 16,
        max_batch_bytes: int = 64 << 20,
        max_union_blocks: int = 64,
    ) -> None:
        if pool is not None and store is not None:
            raise ValueError("pass pool= or store=, not both")
        self.pool = pool if pool is not None else SessionPool(store=store)
        self.engine = engine
        self.scheduler = Scheduler(
            policy=policy, max_waiting=max_waiting,
            residency=self.pool.request_residency,
        )
        self.batcher = ContinuousBatcher(
            self.pool, self.scheduler, engine=engine,
            max_batch_requests=max_batch_requests,
            max_batch_bytes=max_batch_bytes,
            max_union_blocks=max_union_blocks,
        )
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- ingestion
    def submit(
        self, request: Union[Request, dict], *, timeout: Optional[float] = None
    ) -> ResponseHandle:
        """Validate + enqueue a request; returns its streaming handle.

        Validation is submission-time so a bad request fails its OWN
        caller: unknown dataset, unknown/k-less format, or a generate
        request on an engine-less server all raise here, never inside the
        batch loop."""
        if isinstance(request, dict):
            request = Request(**request)
        req = request
        if req.kind == "generate":
            if self.engine is None:
                raise ValueError("this server has no ServingEngine; generate unavailable")
            if req.prompt is None and not req.dataset:
                raise ValueError("generate needs prompt= or dataset=")
        if req.dataset:
            if req.dataset not in self.pool.store.names():
                raise KeyError(
                    f"dataset {req.dataset!r} not registered; have {self.pool.store.names()}"
                )
        if req.kind in ("read", "isp"):
            spec = get_format(req.fmt)
            if spec.requires_k and req.kmer_k is None:
                raise ValueError(f"format {spec.name!r} needs kmer_k=")
        return self.scheduler.submit(req, timeout=timeout)

    # convenience constructors -------------------------------------------------
    def read(self, dataset: str, block_range=None, fmt="2bit", *,
             kmer_k: Optional[int] = None, priority: int = 0, **kw) -> ResponseHandle:
        return self.submit(Request(
            kind="read", dataset=dataset, block_range=block_range, fmt=fmt,
            kmer_k=kmer_k, priority=priority), **kw)

    def consensus(self, dataset: str, block_range=None, *, priority: int = 0,
                  **kw) -> ResponseHandle:
        return self.submit(Request(
            kind="consensus", dataset=dataset, block_range=block_range,
            priority=priority), **kw)

    def stream(self, dataset: str, block_range=None, fmt="2bit", *,
               kmer_k: Optional[int] = None, blocks_per_fetch: int = 4,
               max_fetches: Optional[int] = None, priority: int = 0,
               stream_buffer: Optional[int] = None, **kw) -> ResponseHandle:
        return self.submit(Request(
            kind="isp", dataset=dataset, block_range=block_range, fmt=fmt,
            kmer_k=kmer_k, blocks_per_fetch=blocks_per_fetch,
            max_fetches=max_fetches, priority=priority,
            stream_buffer=stream_buffer), **kw)

    def generate(self, prompt: Optional[np.ndarray] = None, *, dataset: str = "",
                 block_range=None, max_prompt: int = 64, kmer_k: Optional[int] = None,
                 priority: int = 0, **kw) -> ResponseHandle:
        return self.submit(Request(
            kind="generate", prompt=prompt, dataset=dataset,
            block_range=block_range, max_prompt=max_prompt, kmer_k=kmer_k,
            priority=priority), **kw)

    # -------------------------------------------------------------- execution
    def step(self) -> int:
        """One synchronous admission + fused-batch round."""
        return self.batcher.step()

    def run_until_idle(self, **kw) -> int:
        return self.batcher.run_until_idle(**kw)

    def start(self) -> "SageServer":
        """Serve in a background thread until :meth:`stop`."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop() -> None:
            while not self._stop.is_set():
                if self.batcher.step() == 0:
                    time.sleep(0.002)

        self._thread = threading.Thread(target=loop, daemon=True, name="sage-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        self.batcher.close()  # ISP host-prefetch worker, if one was started
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

    def __enter__(self) -> "SageServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---------------------------------------------------------- observability
    def stats(self) -> dict:
        return {
            "scheduler": dict(self.scheduler.stats),
            "batcher": dict(self.batcher.stats),
            "pool": self.pool.stats(),
            "waiting": len(self.scheduler.waiting),
            "running": len(self.scheduler.running),
        }

    def health(self, dataset: Optional[str] = None) -> dict:
        """Integrity health of the backing store (see ``SageStore.health``):
        which datasets have quarantined block groups. A quarantined group
        fails only the requests touching it — this is the operator's view
        of what degraded and what a repair + ``clear_quarantine`` (or
        re-register) would restore."""
        return self.pool.store.health(dataset)


__all__ = [
    "prompts_from_store",
    "ServeConfig",
    "ServingEngine",
    "SageServer",
    "Request",
    "RequestState",
    "ResponseHandle",
]
