"""SAGe-backed training data pipeline — a consumer of the SageStore stream
(the port of ``src/repro/data/pipeline.py``).

The paper's end-to-end pipeline (I/O ∥ decompress ∥ analysis, §3/§7) maps
onto: ``SageReadSession.read_stream`` (SAGe_ISP) -> k-mer reformat -> token
batches, with double-buffered prefetch so data preparation overlaps the
train step (batch#i prepares while batch#i-1 trains).

The fetch path never waits for the device: SAGe_ISP runs pipelined (or in
dispatch mode) on a fused session, so the decode of fetch #i+k is enqueued
while fetch #i is consumed; the per-block PAD trim is one fixed-shape
gather on the device (the k-mer format guarantees exactly ``n_tokens // k``
real leading groups per block — pad ids only in the tail), and fetched
chunks accumulate in a carry buffer on the device. The only host transfer
is one copy per *batch* at the (tokens, labels) boundary —
``transfer_stats`` counts fetches against host transfers.

Determinism & fault tolerance: the cursor is (epoch, block index, consumed
tokens) — restarting from a checkpoint replays the exact stream (the block
directory is the unit of restart). The k-mer token stream is blocks in
cyclic order with PAD groups dropped, so it is invariant to
``blocks_per_fetch`` and to the stream mode.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.core.api import kmer_special_ids, pick_k
from repro_torch.core.format import D, SageFile
from repro_torch.core.store import SageReadSession, SageStore


def prefetch_thread(items: Iterator, depth: int, owner=None) -> Iterator:
    """``items``, made up to ``depth`` ahead by a worker thread.

    The worker uses a timeout put that checks a stop flag, so abandoning
    the iterator mid-stream — even with a full queue — terminates the
    thread instead of leaking it blocked on ``q.put``. An exception in the
    worker is raised in the consumer. ``owner``, when given, gets the
    thread as ``_prefetch_thread`` (so tests can assert termination)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put_or_stop(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in items:
                if not put_or_stop(item):
                    return
        except Exception as e:  # delivered to the consumer thread
            put_or_stop(e)

    t = threading.Thread(target=worker, daemon=True)
    if owner is not None:
        owner._prefetch_thread = t
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()


@dataclasses.dataclass
class Cursor:
    epoch: int = 0
    block: int = 0  # next block to decode
    consumed: int = 0  # k-mer tokens consumed from the global stream

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d) -> "Cursor":
        return cls(**d)


class SageTokenPipeline:
    """Streams (tokens, labels) LM batches from a SAGe-compressed read set.

    ``source`` is either a :class:`SageFile` (registered into ``store``, or
    into a private ``SageStore()`` on the card) or the name of a dataset
    already registered in ``store``. By default the pipeline reads through
    a fused session of the store (one gather+decode+k-mer kernel a fetch).

    ``mesh`` / ``shards`` shard the private store's residency over a block
    mesh (its session then takes the two-step path); with a shared
    ``store`` they belong on the store and raise here. The token stream is
    the same for every shard count."""

    def __init__(
        self,
        source: Union[SageFile, str],
        vocab_size: int,
        batch: int,
        seq_len: int,
        *,
        name: str = "train",
        store: Optional[SageStore] = None,
        session: Optional[SageReadSession] = None,
        blocks_per_fetch: int = 4,
        prefetch: int = 2,
        dispatch: int = 2,
        stream_mode: str = "pipelined",
        cursor: Optional[Cursor] = None,
        seed: int = 0,
        mesh=None,
        shards: Optional[int] = None,
    ) -> None:
        if session is not None:
            # fetch-path reuse: a shared session carries its store and its
            # device residency instead of opening a second store
            if store is not None and session.store is not store:
                raise ValueError("session= belongs to a different store than store=")
            store = session.store
        if store is not None and (mesh is not None or shards is not None):
            raise ValueError(
                "pass mesh/shards on the shared SageStore, not the pipeline — "
                "residency sharding is store-level state"
            )
        if isinstance(source, SageFile):
            if store is not None and name in store.names() and store.source(name) is not source:
                raise ValueError(
                    f"dataset {name!r} already registered in the store with a different "
                    f"source; pass a unique name= to avoid clobbering it"
                )
            self.store = store or SageStore(device=mesh.devices[0] if mesh is not None else "cuda",
                                            mesh=mesh, shards=shards)
            self.name = name
            self.store.register(self.name, source)
        else:
            if store is None:
                raise ValueError("named dataset source requires a store")
            self.store, self.name = store, source
        if stream_mode not in ("dispatch", "pipelined"):
            raise ValueError(
                f"stream_mode must be 'dispatch' or 'pipelined', got {stream_mode!r}"
            )
        self.stream_mode = stream_mode
        self.session: SageReadSession = (
            session if session is not None else self.store.session(fused=True)
        )
        # header-only metadata access: an out-of-core (v2) source must never
        # be materialized whole just to size the cursor math
        directory = self.store.directory(self.name)
        self.k = pick_k(vocab_size)
        self.sp = kmer_special_ids(self.k)
        self.batch = batch
        self.seq_len = seq_len
        self.blocks_per_fetch = blocks_per_fetch
        self.prefetch = prefetch
        self.dispatch = dispatch
        self.cursor = cursor or Cursor()
        self._parts: list[torch.Tensor] = []  # device-side k-mer carry buffer
        self._buffered = 0  # tokens buffered across self._parts (host-known)
        self._skip = 0  # tokens to drop after a cursor restore
        self._stream = None  # lazy SAGe_ISP iterator, recreated on restore
        self._stream_epoch0 = self.cursor.epoch  # epoch base of the open stream
        self._gidx: dict[tuple, torch.Tensor] = {}  # block-id group -> PAD-trim gather index
        self._prefetch_thread: Optional[threading.Thread] = None
        self.transfer_stats = {"fetches": 0, "host_transfers": 0}
        # deterministic k-mer count per block: the k-mer format maps every
        # group at/past n_tokens to the pad id and nothing before it, so
        # exactly n_tokens // k leading groups per block are real
        self._kpb = (np.asarray(directory[:, D["n_tokens"]]) // self.k).astype(np.int64)
        self._kmer_width = self.store.meta(self.name).caps.tokens // self.k

    @property
    def io_stats(self) -> dict:
        """Container-I/O counters of the backing store (disk bytes, ranged
        reads, extent-cache traffic)."""
        return self.store.io_stats

    @property
    def stream_stats(self) -> dict:
        """Per-stage wall time and overlap accounting of the *open* pipelined
        ISP stream (empty in ``dispatch`` mode / before the first fetch).
        Closed streams fold the same numbers into ``io_stats['stream_*']``."""
        from repro_torch.core.streaming import PipelinedStream

        if isinstance(self._stream, PipelinedStream):
            return self._stream.stats.to_dict()
        return {}

    def close(self) -> None:
        """Release the open ISP stream (stops its background I/O thread and
        folds its stage timings into the store's ``io_stats`` and this
        pipeline's ``transfer_stats`` under ``stream_*`` keys). Idempotent;
        the pipeline stays usable — the next fetch reopens at the cursor."""
        stream, self._stream = self._stream, None
        if stream is None or not hasattr(stream, "close"):
            return
        stream.close()
        if hasattr(stream, "stats"):
            ts = self.transfer_stats
            for k, v in stream.stats.to_dict().items():
                if k == "overlap_fraction":
                    continue  # a ratio; per-stream value lives in stream_stats
                key = f"stream_{k}"
                if k.endswith("hwm"):
                    ts[key] = max(ts.get(key, 0), v)
                else:
                    ts[key] = ts.get(key, 0) + v

    # ------------------------------------------------------------------
    def _gather_index(self, ids: tuple) -> torch.Tensor:
        """Flat indices into a fetch's (len(ids), C // k) k-mer plane that
        select each block row's real k-mer prefix (the fixed-shape PAD
        trim) — cached per block-id group, so steady-state fetches reuse one
        uploaded index."""
        cached = self._gidx.get(ids)
        if cached is None:
            counts = self._kpb[list(ids)]
            total = int(counts.sum())
            row = np.repeat(np.arange(len(ids), dtype=np.int64), counts)
            off = np.cumsum(counts) - counts
            col = np.arange(total, dtype=np.int64) - np.repeat(off, counts)
            (cached,) = self.store.uploader(row * self._kmer_width + col)
            self._gidx[ids] = cached
        return cached

    def _fetch_tokens(self) -> torch.Tensor:
        """Pull the next block group off the SAGe_ISP stream as flat k-mers,
        on the store's device: the stream delivers device tensors with
        `dispatch` groups in flight, and the PAD trim is one gather."""
        if self._stream is None:
            self._stream_epoch0 = self.cursor.epoch
            self._stream = self.session.read_stream(
                self.name,
                fmt="kmer",
                kmer_k=self.k,
                start_block=self.cursor.block,
                blocks_per_fetch=self.blocks_per_fetch,
                prefetch=0,  # batch-level prefetch lives in prefetched()
                dispatch=self.dispatch,
                wrap=True,
                mode=self.stream_mode,
            )
        sb = next(self._stream)
        # the stream is the single source of truth for cyclic-advance state
        self.cursor.block = sb.next_block
        self.cursor.epoch = self._stream_epoch0 + sb.next_epoch
        self.transfer_stats["fetches"] += 1
        idx = self._gather_index(tuple(int(b) for b in np.asarray(sb.block_ids)))
        out = sb.data["kmer"].reshape(-1).index_select(0, idx)  # (sum kpb[ids],) int32
        if self._skip:
            take = min(self._skip, int(out.shape[0]))
            out = out[take:]
            self._skip -= take
        return out

    def _batches_from_buffer(self) -> Iterator[dict[str, np.ndarray]]:
        need = self.batch * (self.seq_len + 1)
        while self._buffered >= need:
            buf = self._parts[0] if len(self._parts) == 1 else torch.cat(self._parts)
            head, rest = buf[:need], buf[need:]
            self._parts = [rest]
            self._buffered = int(rest.shape[0])
            # the single host transfer: one materialized (tokens, labels) batch
            chunk = head.cpu().numpy().reshape(self.batch, self.seq_len + 1)
            self.transfer_stats["host_transfers"] += 1
            self.cursor.consumed += need
            yield {
                "tokens": chunk[:, :-1].copy(),
                "labels": chunk[:, 1:].copy(),
            }

    def batches(self) -> Iterator[dict[str, np.ndarray]]:
        """Infinite deterministic batch stream (single-threaded)."""
        need = self.batch * (self.seq_len + 1)
        while True:
            while self._buffered < need:
                c = self._fetch_tokens()
                self._parts.append(c)
                self._buffered += int(c.shape[0])
            yield from self._batches_from_buffer()

    def prefetched(self) -> Iterator[dict[str, np.ndarray]]:
        """Double-buffered: decode of fetch#i overlaps training on #i-1
        (:func:`prefetch_thread` over :meth:`batches`, ``prefetch`` deep)."""
        yield from prefetch_thread(self.batches(), self.prefetch, self)

    # ------------------------------------------------------- fault tolerance
    def state(self) -> dict:
        return {"cursor": self.cursor.to_json()}

    def restore(self, state: dict) -> None:
        """Deterministic fast-forward: map the consumed-token count back to
        (epoch, block, within-block offset) via the block directory."""
        consumed = int(Cursor.from_json(state["cursor"]).consumed)
        total = int(self._kpb.sum())
        epoch, rem = divmod(consumed, total)
        cum = np.cumsum(self._kpb)
        block = int(np.searchsorted(cum, rem, side="right"))
        within = rem - (int(cum[block - 1]) if block else 0)
        self.cursor = Cursor(epoch=epoch, block=block, consumed=consumed)
        self._parts = []
        self._buffered = 0
        self._skip = within
        self.close()  # re-open the ISP stream at the restored block
