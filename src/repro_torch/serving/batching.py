"""Continuous batching: fuse admitted requests into bucketed decodes (the
port of ``src/repro/serving/batching.py``).

The batcher is the serving loop's execution half (the scheduler owns
lifecycle). Each ``step()`` is one admission + execution round:

  1. admit waiting requests into the running set (policy order, capped by
     ``max_batch_requests``)
  2. collect every running request's next unit of work — a read's whole
     range, a streaming (ISP) request's next ``blocks_per_fetch`` chunk —
     skipping streams whose consumers lag their ``stream_buffer``
  3. fuse work items per (dataset, fmt, kmer_k) into ONE deduplicated
     ranged decode each, memory-aware: a round's resident-block bytes stay
     under ``max_batch_bytes`` (items that don't fit wait for the next
     round, in arrival order — no starvation)
  4. run each fused group through the pool's two-step ``session.read`` —
     the power-of-two bucketed hot path, so continuous batches of ANY
     composition decode at a bucket shape, never a per-request-mix one —
     copy its outputs to the host once, and scatter per-request slices
     back through the response channels
  5. batch generate requests into the ServingEngine at power-of-two padded
     batch sizes

One-shot requests finish in the round they execute; streaming requests
stay running across rounds, sharing every round's fused decodes with
whatever one-shot traffic is in flight — that is the continuous-batching
contract: long streams never block short reads, short reads ride along in
the stream's bucket.
"""

from __future__ import annotations

import numpy as np

import torch

from repro_torch.core.blocks import bucket_size
from repro_torch.core.errors import SageIOError
from repro_torch.serving.scheduler import RequestState, Scheduler, _Entry
from repro_torch.serving.session_pool import SessionPool


def _to_host(v: torch.Tensor):
    """One device->host copy of a decode output: a numpy array, except a
    bf16 plane (``onehot``), which stays a host torch tensor — numpy has no
    bfloat16, and widening it would change what a tenant receives."""
    v = v.cpu()
    return v if v.dtype == torch.bfloat16 else v.numpy()


def _slice_chunk(out: dict, pos: np.ndarray) -> dict:
    """Per-request slice of a fused block-major decode. ``out`` must hold
    host arrays (one transfer per fused decode, not per request) — N tenant
    slices of a shared decode are then host gathers, no device work."""
    return {k: v[pos] for k, v in out.items()}


class ContinuousBatcher:
    """Executes the scheduler's running set against a shared session pool.

    ``max_batch_bytes`` bounds the prepared-layout bytes a single round may
    make device-resident (``store.block_nbytes`` per dataset x the round's
    deduplicated block count); ``max_union_blocks`` additionally caps any
    one fused decode so its power-of-two bucket stays in the warmed set.
    A single request larger than either cap runs alone in its own round —
    oversized work degrades to serial, it is never starved."""

    def __init__(
        self,
        pool: SessionPool,
        scheduler: Scheduler,
        *,
        engine=None,
        max_batch_requests: int = 16,
        max_batch_bytes: int = 64 << 20,
        max_union_blocks: int = 64,
        prefetch_isp: bool = True,
    ) -> None:
        if max_batch_requests < 1:
            raise ValueError("max_batch_requests must be >= 1")
        if max_union_blocks < 1:
            raise ValueError("max_union_blocks must be >= 1")
        self.pool = pool
        self.scheduler = scheduler
        self.engine = engine
        self.max_batch_requests = max_batch_requests
        self.max_batch_bytes = max_batch_bytes
        self.max_union_blocks = max_union_blocks
        self.prefetch_isp = prefetch_isp
        self.stats = {
            "rounds": 0, "fused_reads": 0, "fused_read_requests": 0,
            "fused_blocks": 0, "consensus_calls": 0, "generate_batches": 0,
            "deferred": 0, "skipped_backpressure": 0, "isolated_failures": 0,
            "repair_attempts": 0, "auto_repairs": 0,
            "isp_prefetched_groups": 0, "isp_prefetch_errors": 0,
        }
        self._repair_attempted: set[tuple] = set()
        self._prefetcher = None  # lazy HostPrefetcher; first ISP delivery starts it

    # ------------------------------------------------------------------ step
    def session(self):
        return self.pool.session()

    def _resolve(self, e: _Entry) -> np.ndarray:
        """Resolve (once) and cache the request's global block ids."""
        if e.ids is None:
            e.ids = self.session().resolve_blocks(e.request.dataset, e.request.block_range)
        return e.ids

    def _isp_chunk_ids(self, e: _Entry) -> np.ndarray:
        ids = self._resolve(e)
        return ids[e.cursor : e.cursor + e.request.blocks_per_fetch]

    def _isp_done(self, e: _Entry) -> bool:
        r = e.request
        return e.cursor >= self._resolve(e).size or (
            r.max_fetches is not None and e.fetches >= r.max_fetches
        )

    def _prefetch_next_chunk(self, e: _Entry) -> None:
        """Stage the NEXT chunk's block groups disk -> host cache in the
        background: the moment a chunk is delivered its successor is known,
        so the following round's fused ``read`` finds the extents already
        host-resident (the batcher's analogue of the pipelined stream's I/O
        stage). Errors never surface here — the store quarantines a corrupt
        group internally and the request's own next read fails fast with
        the same typed error it would have hit synchronously."""
        store = self.pool.store
        if store._reader(e.request.dataset) is None:
            return  # eager dataset: nothing on disk to stage
        if self._prefetcher is None:
            from repro_torch.core.streaming import HostPrefetcher

            self._prefetcher = HostPrefetcher(store)
        for b in self._isp_chunk_ids(e):
            self._prefetcher.enqueue(e.request.dataset, int(b) // store.group_blocks)

    def _sync_prefetch_stats(self) -> None:
        if self._prefetcher is not None:
            self.stats["isp_prefetched_groups"] = self._prefetcher.stats["prefetched_groups"]
            self.stats["isp_prefetch_errors"] = self._prefetcher.stats["prefetch_errors"]

    def close(self) -> None:
        """Stop the background prefetch worker (idempotent). The batcher
        itself is stateless between rounds and stays usable."""
        if self._prefetcher is not None:
            self._sync_prefetch_stats()
            self._prefetcher.close()
            self._prefetcher = None

    def _maybe_repair(self, err: SageIOError) -> bool:
        """Targeted self-healing: before failing a fused batch's tenants on
        a group-scoped storage error, try ONE ``store.repair`` of exactly
        the damaged group (scrub-and-repair on demand). True means the
        group re-verified clean — the caller retries the fused read instead
        of failing anyone. Each (dataset, group) gets a single attempt per
        batcher lifetime, so an un-healable group degrades to the fail-fast
        path instead of a repair loop; the background scrubber owns
        anything beyond that."""
        name = getattr(err, "dataset", None)
        gi = getattr(err, "block_group", None)
        if name is None or gi is None:
            return False
        key = (name, gi)
        if key in self._repair_attempted:
            return False
        self._repair_attempted.add(key)
        self.stats["repair_attempts"] += 1
        try:
            self.pool.store.repair(name, group=gi)
        except (SageIOError, ValueError):
            return False  # unrecoverable (or not repairable): quarantined
        self.stats["auto_repairs"] += 1
        return True

    def _fail_touched(self, items: list, err: SageIOError) -> list:
        """Graceful degradation: finish ONLY the requests whose block sets
        touch the failed block group (``err.block_group``), with the typed
        error; return the survivors for a re-fused retry. A failure that
        names no group — or one no item maps to — fails the whole fused
        batch (the guard against retrying a read that can never change)."""
        sched = self.scheduler
        gi = getattr(err, "block_group", None)
        gb = self.pool.store.group_blocks
        touched = items
        if gi is not None:
            hit = [
                it for it in items
                if np.any(np.asarray(it[1], dtype=np.int64) // gb == gi)
            ]
            if hit:
                touched = hit
        for e, _ in touched:
            sched.finish(e, err)
        self.stats["isolated_failures"] += len(touched)
        survivors = [it for it in items if not any(it is t for t in touched)]
        return survivors

    @staticmethod
    def _refuse_union(items: list) -> np.ndarray:
        return np.array(
            sorted({int(b) for _, ids in items for b in ids}), dtype=np.int64
        )

    def step(self) -> int:
        """One admission + fused-execution round; returns chunks delivered."""
        sched = self.scheduler
        sched.expire_deadlines()  # overdue WAITING/RUNNING -> ABORTED first
        sched.admit(sched.free_slots(self.max_batch_requests))
        running = [e for e in sched.running if e.state is RequestState.RUNNING]
        if not running:
            return 0
        self.stats["rounds"] += 1

        # ---- collect work items, memory-aware ----------------------------
        read_groups: dict[tuple, dict] = {}  # key -> {union ids set, items}
        cons_groups: dict[str, dict] = {}
        gen_items: list[_Entry] = []
        budget = self.max_batch_bytes
        for e in running:
            req = e.request
            if req.kind == "generate":
                gen_items.append(e)
                continue
            try:
                if req.kind == "isp":
                    if self._isp_done(e):
                        sched.finish(e)
                        continue
                    if sched.has_backpressure(e):
                        self.stats["skipped_backpressure"] += 1
                        continue
                    ids = self._isp_chunk_ids(e)
                else:
                    ids = self._resolve(e)
                bnb = self.pool.store.block_nbytes(req.dataset)
            except Exception as err:
                sched.finish(e, err)
                continue
            groups = cons_groups if req.kind == "consensus" else read_groups
            key = (
                req.dataset
                if req.kind == "consensus"
                else (req.dataset, req.fmt, req.kmer_k)
            )
            g = groups.setdefault(key, {"ids": set(), "items": [], "bytes": 0})
            new = [int(b) for b in ids if int(b) not in g["ids"]]
            cost = len(new) * bnb
            over_union = (
                req.kind != "consensus"
                and len(g["ids"]) + len(new) > self.max_union_blocks
            )
            if g["items"] and (cost > budget or over_union):
                self.stats["deferred"] += 1  # runs next round, arrival order
                continue
            g["ids"].update(new)
            g["items"].append((e, ids))
            g["bytes"] += cost
            budget -= cost

        delivered = 0

        # ---- fused ranged decodes ----------------------------------------
        sess = self.session()
        for (name, fmt, k), g in read_groups.items():
            union = np.array(sorted(g["ids"]), dtype=np.int64)
            items = list(g["items"])
            out = None
            while items:
                try:
                    out = sess.read(name, union, fmt, kmer_k=k)
                    break
                except SageIOError as err:
                    # first choice: heal the damaged group in place and
                    # retry the whole fused read — nobody fails
                    if self._maybe_repair(err):
                        continue
                    # otherwise a quarantined/corrupt/unreadable block group
                    # fails only the tenants touching it; the rest of the
                    # fused batch re-fuses (minus the damaged blocks) and runs
                    items = self._fail_touched(items, err)
                    union = self._refuse_union(items)
                except Exception as err:
                    for e, _ in items:
                        sched.finish(e, err)
                    items = []
            if not items or out is None:
                continue
            # one device->host copy per FUSED decode; per-request slicing
            # below is then a host gather, not a device gather each
            out = {key: _to_host(v) for key, v in out.items() if key != "block_ids"}
            self.stats["fused_reads"] += 1
            self.stats["fused_read_requests"] += len(items)
            self.stats["fused_blocks"] += int(union.size)
            for e, ids in items:
                pos = np.searchsorted(union, ids)
                chunk = {
                    "kind": e.request.kind,
                    "block_ids": ids,
                    "data": _slice_chunk(out, pos),
                }
                if e.request.kind == "isp":
                    chunk["fetch"] = e.fetches
                    e.cursor += ids.size
                    e.fetches += 1
                    if sched.deliver(e, chunk):
                        delivered += 1
                    if self._isp_done(e):
                        sched.finish(e)
                    elif self.prefetch_isp:
                        self._prefetch_next_chunk(e)
                else:
                    if sched.deliver(e, chunk):
                        delivered += 1
                    sched.finish(e)

        # ---- fused consensus-window gathers ------------------------------
        store = self.pool.store
        for name, g in cons_groups.items():
            union = np.array(sorted(g["ids"]), dtype=np.int64)
            items = list(g["items"])
            wins = starts = None
            while items:
                try:
                    wins, starts = store.consensus_windows(name, union)
                    break
                except SageIOError as err:
                    if self._maybe_repair(err):
                        continue
                    items = self._fail_touched(items, err)
                    union = self._refuse_union(items)
                except Exception as err:
                    for e, _ in items:
                        sched.finish(e, err)
                    items = []
            if not items or wins is None:
                continue
            self.stats["consensus_calls"] += 1
            for e, ids in items:
                pos = np.searchsorted(union, ids)
                if sched.deliver(e, {
                    "kind": "consensus", "block_ids": ids,
                    "windows": wins[pos], "starts": starts[pos],
                }):
                    delivered += 1
                sched.finish(e)

        # ---- batched LM generation ---------------------------------------
        if gen_items:
            delivered += self._run_generate(gen_items)
        self._sync_prefetch_stats()
        return delivered

    def _run_generate(self, items: list[_Entry]) -> int:
        """One padded-batch ServingEngine round for every running generate
        request: prompts resolve (from the request or the k-mer prompt
        feed), the batch pads to its power-of-two bucket with dummy
        prompts, and each request gets its own row back."""
        sched = self.scheduler
        if self.engine is None:
            err = RuntimeError("server has no ServingEngine; generate unavailable")
            for e in items:
                sched.finish(e, err)
            return 0
        from repro_torch.serving.engine import prompts_from_store  # cycle-free at runtime

        live: list[tuple[_Entry, np.ndarray]] = []
        for e in items:
            req = e.request
            try:
                if req.prompt is not None:
                    p = np.asarray(req.prompt, dtype=np.int32)
                else:
                    vocab = req.vocab or self.engine.cfg.vocab
                    ps = prompts_from_store(
                        self.session(), req.dataset, vocab=vocab, n_prompts=1,
                        max_prompt=req.max_prompt, kmer_k=req.kmer_k,
                        block_range=req.block_range,
                    )
                    if not ps:
                        raise ValueError(
                            f"dataset {req.dataset!r} range {req.block_range!r} "
                            f"yields no prompts"
                        )
                    p = ps[0]
                live.append((e, p))
            except Exception as err:
                sched.finish(e, err)
        if not live:
            return 0
        prompts = [p for _, p in live]
        pad = bucket_size(len(prompts)) - len(prompts)
        prompts += [np.zeros(1, np.int32)] * pad  # bucket the batch dim too
        try:
            outs = self.engine.generate(prompts)
        except Exception as err:
            for e, _ in live:
                sched.finish(e, err)
            return 0
        self.stats["generate_batches"] += 1
        delivered = 0
        for (e, _), tokens in zip(live, outs):
            if sched.deliver(e, {"kind": "generate", "tokens": tokens}):
                delivered += 1
            sched.finish(e)
        return delivered

    # ------------------------------------------------------------- draining
    def run_until_idle(self, *, max_rounds: int = 10_000) -> int:
        """Step until every submitted request is terminal; returns total
        chunks delivered. A round that can make no progress (every running
        stream backpressured and nothing waiting) raises rather than spins —
        drain the handles (or run the server in the background) first."""
        total, stuck = 0, 0
        while self.scheduler.has_work():
            n = self.step()
            total += n
            if n == 0 and not self.scheduler.has_work():
                break
            stuck = stuck + 1 if n == 0 else 0
            if stuck >= 3:
                raise RuntimeError(
                    "serving loop stalled: running streams are backpressured "
                    "and nothing else is schedulable; drain response handles "
                    "or serve in the background"
                )
            max_rounds -= 1
            if max_rounds <= 0:
                raise RuntimeError("run_until_idle exceeded max_rounds")
        return total
