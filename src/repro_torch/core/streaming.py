"""Pipelined streaming: the disk → host → device → decode scan pipeline
(the port of ``src/repro/core/streaming.py``).

The paper's hardware hides data preparation behind compute via lightweight
streaming accesses; this module is the software analogue for SAGe_ISP.
Block groups form a scan sequence (the `scan` recurrence idiom): while
fetch *i*'s decode runs on device, fetch *i+1* uploads and fetch *i+2* is
ranged-read from disk by a background I/O stage.

Stages and who runs them:

  io       one daemon worker thread, the sole puller of the fetch-descriptor
           generator; per fetch it pulls the covering block groups' extents
           disk → host cache via ``store.prefetch_group_host`` (the same
           CRC/retry path as synchronous reads — a corrupt group
           quarantines here and surfaces as the identical typed
           ``SageIOError`` when its fetch is decoded). The thread stays on
           the host: it makes no CUDA call and hands no tensor over
  upload   consumer thread: ``store.prepared_for`` (host cache hit → a
           pinned, non-blocking copy on the store's copy stream and the
           unpack kernel, no disk)
  dispatch consumer thread: the session decode+format call — kernels are
           only enqueued on the CUDA stream, so it costs launch time, not
           compute time
  consume  the consumer's own time between ``__next__`` calls (this is
           where device compute actually completes, hidden behind the
           consumer for device-side pipelines)

Device residency is double-buffered: each fetch's covering groups occupy a
slot in a ring of ``max(2, dispatch)`` slots; before a new fetch uploads,
the oldest retired slot's groups are released (``store.release_group`` —
host cache keeps the bytes), so steady-state streaming holds a bounded
group set and never churns the store's shared LRU.

Accounting: per-stage wall seconds, fetch counts, in-flight high-water
marks, and ``overlap_fraction = 1 - wall / sum(stage)`` — 0 when the
pipeline degenerates to sequential, approaching ``1 - 1/n_stages`` when
every stage hides behind the slowest. Stats fold into ``store.io_stats``
(``stream_*`` keys) on close/exhaustion.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Iterator, Optional

from repro_torch.core.store import SageReadSession, StreamBatch

_PUT_TIMEOUT = 0.1  # bounded queue puts poll the stop flag at this period


class StreamStats:
    """Per-stream overlap accounting (see module docstring for the stage
    definitions). ``overlap_fraction`` is the proof the phases overlap."""

    _FIELDS = (
        "io_seconds", "upload_seconds", "dispatch_seconds", "consume_seconds",
        "wall_seconds", "fetches", "io_groups", "inflight_hwm", "slot_hwm",
        "slot_releases",
    )

    def __init__(self) -> None:
        self.io_seconds = 0.0
        self.upload_seconds = 0.0
        self.dispatch_seconds = 0.0
        self.consume_seconds = 0.0
        self.wall_seconds = 0.0
        self.fetches = 0
        self.io_groups = 0
        self.inflight_hwm = 0
        self.slot_hwm = 0
        self.slot_releases = 0
        self._lock = threading.Lock()  # io thread and consumer both write

    @property
    def overlap_fraction(self) -> float:
        stage = (
            self.io_seconds + self.upload_seconds
            + self.dispatch_seconds + self.consume_seconds
        )
        return 1.0 - self.wall_seconds / stage if stage > 0 else 0.0

    def to_dict(self) -> dict:
        d = {k: getattr(self, k) for k in self._FIELDS}
        d["overlap_fraction"] = self.overlap_fraction
        return d


class _StreamState:
    """Everything the I/O worker touches. Deliberately NOT the
    PipelinedStream itself: the worker holding only this object keeps the
    stream garbage-collectable mid-iteration, and ``__del__``-driven
    teardown can always reach the stop flag."""

    def __init__(self, store, name: str, groups, lazy: bool, group_blocks: int,
                 maxsize: int, stats: StreamStats) -> None:
        self.store = store
        self.name = name
        self.groups = groups  # fetch-descriptor generator (worker-owned)
        self.lazy = lazy
        self.group_blocks = group_blocks
        self.stats = stats
        self.stop = threading.Event()
        # ("item", desc, err) | ("done", None, None) | ("err", None, exc)
        self.ready: "queue.Queue[tuple]" = queue.Queue(maxsize=maxsize)

    def put(self, item: tuple) -> bool:
        """Bounded put that polls the stop flag — an abandoned consumer
        must not strand the worker on a full queue."""
        while not self.stop.is_set():
            try:
                self.ready.put(item, timeout=_PUT_TIMEOUT)
                return True
            except queue.Full:
                continue
        return False

    def covering_groups(self, ids) -> list[int]:
        if not self.lazy:
            return []
        return sorted({int(b) // self.group_blocks for b in ids})


def _io_worker(st: _StreamState) -> None:
    """The background I/O stage: pull fetch descriptors in stream order,
    stage each one's covering groups into the host extent cache, and hand
    the descriptor (plus any I/O error, still in order) to the consumer."""
    try:
        for desc in st.groups:
            if st.stop.is_set():
                return
            err: Optional[BaseException] = None
            gis = st.covering_groups(desc[1])
            t0 = time.perf_counter()
            for gi in gis:
                if st.stop.is_set():
                    return
                try:
                    st.store.prefetch_group_host(st.name, gi)
                except BaseException as e:  # surfaces at this fetch's decode slot
                    err = e
                    break
            dt = time.perf_counter() - t0
            with st.stats._lock:
                st.stats.io_seconds += dt
                st.stats.io_groups += len(gis)
            if not st.put(("item", desc, err)):
                return
            if err is not None:
                return  # stream order past a failed fetch is undefined
        st.put(("done", None, None))
    except BaseException as e:  # generator itself failed; forward, in order
        st.put(("err", None, e))


class PipelinedStream:
    """Iterator of :class:`StreamBatch` driven by the 3-deep pipeline.

    Iterate it like any stream; ``close()`` (or ``with``-exit, garbage
    collection, or exhaustion) stops the I/O worker, joins it, and folds
    the stats into ``store.io_stats``. Errors raised by the background
    stage surface on ``__next__`` at the exact fetch position they belong
    to — every earlier batch is still delivered first."""

    def __init__(
        self,
        session: SageReadSession,
        name: str,
        *,
        fmt="2bit",
        kmer_k: Optional[int] = None,
        start_block: int = 0,
        blocks_per_fetch: int = 4,
        wrap: bool = False,
        max_fetches: Optional[int] = None,
        dispatch: int = 2,
        readahead: int = 2,
    ) -> None:
        if dispatch < 1:
            raise ValueError(f"pipelined dispatch depth must be >= 1, got {dispatch}")
        store = session.store
        self.session = session
        self.name = name
        self.fmt = fmt
        self.kmer_k = kmer_k
        self.dispatch = dispatch
        self.slots = max(2, dispatch)
        self.stats = StreamStats()
        self._closed = False
        self._folded = False
        nb = store.n_blocks(name)
        groups = session._group_ids(
            nb, start_block, blocks_per_fetch, wrap, max_fetches
        )
        lazy = store._reader(name) is not None
        self._state = _StreamState(
            store, name, groups, lazy, store.group_blocks,
            maxsize=dispatch + max(1, readahead), stats=self.stats,
        )
        self._thread = threading.Thread(
            target=_io_worker, args=(self._state,),
            name=f"sage-stream-io-{name}", daemon=True,
        )
        self._thread.start()
        self._gen = self._run()

    # ------------------------------------------------------------- iteration
    def __iter__(self) -> Iterator[StreamBatch]:
        return self

    def __next__(self) -> StreamBatch:
        return next(self._gen)

    def _next_ready(self) -> tuple:
        """Take the next descriptor from the I/O stage, guarding against a
        silently-dead worker (can't happen through normal control flow —
        the worker forwards every exception — but a hang here would be
        strictly worse than a loud error)."""
        st = self._state
        while True:
            try:
                return st.ready.get(timeout=0.2)
            except queue.Empty:
                if not self._thread.is_alive() and st.ready.empty():
                    raise RuntimeError(
                        f"pipelined stream on {self.name!r}: I/O worker died "
                        f"without reporting"
                    ) from None

    def _run(self) -> Iterator[StreamBatch]:
        st = self._state
        stats = self.stats
        store = st.store
        sess = self.session
        # pending: ("batch", StreamBatch, set[gi]) | ("raise", exc, None)
        pending: deque = deque()
        ring: "deque[set]" = deque()  # device slots: covering groups per live fetch
        exhausted = False

        def recycle(next_gis: set) -> None:
            # release the oldest retired fetch's device groups before the
            # next upload: steady state runs in `slots` double-buffered
            # slots; groups shared with a live slot (or the incoming fetch:
            # sequential streams overlap at group boundaries) stay resident
            while len(ring) >= self.slots:
                old = ring.popleft()
                live = set().union(*ring) if ring else set()
                for gi in old - live - next_gis:
                    if store.release_group(st.name, gi):
                        stats.slot_releases += 1

        def pump() -> None:
            nonlocal exhausted
            while not exhausted and len(pending) < self.dispatch:
                kind, desc, err = self._next_ready()
                if kind == "done":
                    exhausted = True
                    return
                if kind == "err" or err is not None:
                    pending.append(("raise", err, None))
                    exhausted = True
                    return
                epoch, ids, nxt_b, nxt_epoch = desc
                gis = set(st.covering_groups(ids))
                if st.lazy:
                    recycle(gis)
                t0 = time.perf_counter()
                try:
                    db, local = store.prepared_for(st.name, ids)
                    t1 = time.perf_counter()
                    data = sess._decode_prepared(st.name, db, local, self.fmt, self.kmer_k)
                    data["block_ids"] = ids  # the read() contract
                except BaseException as e:
                    stats.upload_seconds += time.perf_counter() - t0
                    pending.append(("raise", e, None))
                    exhausted = True
                    return
                t2 = time.perf_counter()
                with stats._lock:
                    stats.upload_seconds += t1 - t0
                    stats.dispatch_seconds += t2 - t1
                    stats.fetches += 1
                ring.append(gis)
                live = set().union(*ring) if ring else set()
                stats.slot_hwm = max(stats.slot_hwm, len(live))
                stats.inflight_hwm = max(
                    stats.inflight_hwm, len(pending) + 1 + st.ready.qsize()
                )
                pending.append((
                    "batch",
                    StreamBatch(name=st.name, epoch=epoch, block_ids=ids,
                                data=data, next_block=nxt_b, next_epoch=nxt_epoch),
                    None,
                ))

        t_start = time.perf_counter()
        try:
            pump()
            while pending:
                kind, payload, _ = pending.popleft()
                if kind == "raise":
                    raise payload
                t_y = time.perf_counter()
                yield payload
                with stats._lock:
                    stats.consume_seconds += time.perf_counter() - t_y
                pump()
        finally:
            with stats._lock:
                stats.wall_seconds += time.perf_counter() - t_start
            self.close()

    # -------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Stop and join the I/O worker, then fold the stream's stats into
        ``store.io_stats`` (idempotent; called automatically on exhaustion,
        ``with``-exit, and garbage collection)."""
        if self._closed:
            return
        self._closed = True
        self._state.stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        try:
            # run the generator's finally (it accumulates wall_seconds)
            # BEFORE folding; a ValueError means close() was called from
            # inside the generator's own finally — wall is already counted
            self._gen.close()
        except ValueError:
            pass
        self._fold_stats()

    def _fold_stats(self) -> None:
        if self._folded:
            return
        self._folded = True
        s = self.stats
        store = self._state.store
        with store._lock:
            io = store._io
            io["stream_io_seconds"] += s.io_seconds
            io["stream_upload_seconds"] += s.upload_seconds
            io["stream_dispatch_seconds"] += s.dispatch_seconds
            io["stream_consume_seconds"] += s.consume_seconds
            io["stream_wall_seconds"] += s.wall_seconds
            io["stream_fetches"] += s.fetches
            io["stream_io_groups"] += s.io_groups
            io["stream_slot_releases"] += s.slot_releases
            io["stream_inflight_hwm"] = max(io["stream_inflight_hwm"], s.inflight_hwm)
            io["stream_slot_hwm"] = max(io["stream_slot_hwm"], s.slot_hwm)

    def __enter__(self) -> "PipelinedStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass  # interpreter teardown


class HostPrefetcher:
    """Fire-and-forget disk → host-cache prefetch for upcoming reads.

    The serving batcher's ISP streams can't run a PipelinedStream (the
    batcher multiplexes many requests through one fused read per round),
    but their NEXT chunk is known the moment a chunk is delivered — this
    worker pulls those groups' extents into the host cache in the
    background so the next round's ``prepared_for`` skips disk. Errors are
    swallowed and counted: the store quarantines corrupt groups internally,
    so the request's own next read fails fast with the same typed error it
    would have hit synchronously (no error ever surfaces from a prefetch
    that the consumer didn't ask for yet). Host only: the worker reads
    disk into the host extent cache and makes no CUDA call."""

    def __init__(self, store) -> None:
        self.store = store
        self.stats = {"prefetched_groups": 0, "prefetch_errors": 0}
        self._queue: "queue.Queue" = queue.Queue()
        self._queued: set = set()  # dedup: at most one pending job per group
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="sage-host-prefetch", daemon=True
        )
        self._thread.start()

    def enqueue(self, name: str, gi: int) -> bool:
        key = (name, int(gi))
        with self._lock:
            if self._stop.is_set() or key in self._queued:
                return False
            self._queued.add(key)
        self._queue.put(key)
        return True

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                key = self._queue.get(timeout=_PUT_TIMEOUT)
            except queue.Empty:
                continue
            try:
                if self.store.prefetch_group_host(*key):
                    self.stats["prefetched_groups"] += 1
            except Exception:
                self.stats["prefetch_errors"] += 1
            finally:
                with self._lock:
                    self._queued.discard(key)

    def close(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass
