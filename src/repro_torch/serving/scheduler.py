"""Request scheduler: the lifecycle state machine of the serving frontend
(the port of ``src/repro/serving/scheduler.py``: standard library and numpy
only, so a copy).

This is the sglang-style ingestion/scheduling layer (SNIPPETS.md Snippet 3)
mapped onto SAGe: every request — ranged decode (SAGe_Read), consensus
windows, streaming analysis (SAGe_ISP), or LM continuation (generate) —
enters a bounded **waiting** queue and moves through

    WAITING ──admit──> RUNNING ──deliver──> FINISHED
        │                  │
        └────── abort ─────┴──────────────> ABORTED

Admission is policy-driven:

  ``fcfs``         (priority, arrival) order — strict fairness
  ``cache_aware``  (priority, -device residency, arrival) — requests whose
                   covering block groups are already in the store's
                   block-granular LRU admit first, so hot datasets are
                   drained before cold ones evict them (the scheduler-level
                   analogue of matching access granularity to analysis
                   granularity across the stack)

The scheduler owns *state*, never *execution*: the continuous batcher
(serving/batching.py) pulls admitted requests, fuses their block ranges
into bucketed decodes, and pushes response chunks through each request's
:class:`ResponseHandle` — a streaming, abortable, optionally backpressured
per-request channel.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    ABORTED = "aborted"

    @property
    def terminal(self) -> bool:
        return self in (RequestState.FINISHED, RequestState.ABORTED)


#: request kinds the frontend accepts (the paper's command set + generate)
KINDS = ("read", "consensus", "isp", "generate")


class QueueFullError(RuntimeError):
    """Raised by ``submit`` when the waiting queue stays full past the
    caller's timeout — the ingestion-side backpressure signal."""


class DeadlineExceededError(TimeoutError):
    """A request's ``deadline_s`` elapsed before it finished; the scheduler
    moved it to ABORTED (from WAITING or RUNNING) and this error is what
    its response stream raises."""


@dataclasses.dataclass
class Request:
    """One unit of client work against a named SageStore dataset.

    ``kind`` selects the execution path:

      read       one ranged decode of ``block_range`` to ``fmt``
      consensus  per-block consensus windows of ``block_range``
      isp        streaming decode: ``blocks_per_fetch`` blocks per chunk,
                 ``max_fetches`` chunks (None = to the end of the range)
      generate   LM continuation of ``prompt`` (or, with ``prompt=None``,
                 of the first read of ``block_range`` via the k-mer prompt
                 feed) — needs the server to hold a ServingEngine

    ``priority`` sorts before everything else (smaller = sooner).
    ``stream_buffer`` bounds the response channel: a streaming request
    whose consumer lags ``stream_buffer`` undelivered chunks simply stops
    contributing work to batches until drained (backpressure without
    stalling the batch loop); None = unbounded."""

    kind: str
    dataset: str = ""
    block_range: object = None
    fmt: str = "2bit"
    kmer_k: Optional[int] = None
    # isp
    blocks_per_fetch: int = 4
    max_fetches: Optional[int] = None
    # generate
    prompt: Optional[np.ndarray] = None
    max_prompt: int = 64
    vocab: Optional[int] = None
    # scheduling
    priority: int = 0
    stream_buffer: Optional[int] = None
    #: wall-clock budget from submit; an overdue request is moved to
    #: ABORTED (DeadlineExceededError) from WAITING or RUNNING. None = no
    #: deadline. Enforced by ``Scheduler.expire_deadlines`` — the batcher
    #: calls it at the top of every step, so a stuck or backlogged loop
    #: can delay (never skip) expiry.
    deadline_s: Optional[float] = None

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown request kind {self.kind!r}; one of {KINDS}")
        if self.kind != "generate" and not self.dataset:
            raise ValueError(f"{self.kind!r} request needs dataset=")
        if self.kind == "isp" and self.blocks_per_fetch < 1:
            raise ValueError("blocks_per_fetch must be >= 1")
        if self.stream_buffer is not None and self.stream_buffer < 1:
            raise ValueError("stream_buffer must be >= 1 or None")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0 or None")


class _End:
    """Queue sentinel closing a response channel (carries final state)."""

    __slots__ = ("state",)

    def __init__(self, state: RequestState) -> None:
        self.state = state


@dataclasses.dataclass
class _Entry:
    """Scheduler-internal record of one submitted request."""

    rid: int
    seq: int
    request: Request
    state: RequestState = RequestState.WAITING
    chan: queue.Queue = dataclasses.field(default_factory=queue.Queue)
    error: Optional[BaseException] = None
    submit_t: float = 0.0
    admit_t: float = 0.0
    finish_t: float = 0.0
    chunks_out: int = 0
    # execution state owned by the batcher
    ids: Optional[np.ndarray] = None  # resolved block ids (dataset kinds)
    cursor: int = 0  # isp: offset into ids of the next chunk
    fetches: int = 0  # isp: chunks already produced


class ResponseHandle:
    """The client's view of one request: streaming results + abort.

    ``chunks()`` yields response dicts until the request reaches a terminal
    state (raising the execution error, if any); ``result()`` is the
    convenience for one-shot kinds. ``abort()`` works from WAITING (the
    request never runs) and from RUNNING (no further chunks are produced;
    already-queued chunks still drain)."""

    def __init__(self, scheduler: "Scheduler", entry: _Entry) -> None:
        self._sched = scheduler
        self._entry = entry

    @property
    def id(self) -> int:
        return self._entry.rid

    @property
    def state(self) -> RequestState:
        return self._entry.state

    @property
    def request(self) -> Request:
        return self._entry.request

    def abort(self) -> bool:
        """Abort the request; True if it was still live."""
        return self._sched.abort(self._entry.rid)

    def chunks(self, timeout: Optional[float] = None) -> Iterator[dict]:
        """Yield response chunks until the stream closes.

        ``timeout`` bounds the wait for EACH chunk (``queue.Empty`` on
        expiry) — None blocks, which is safe with a background server but
        will deadlock a synchronous caller that forgot to ``step()``."""
        while True:
            item = self._entry.chan.get(timeout=timeout)
            if isinstance(item, _End):
                if self._entry.error is not None:
                    raise self._entry.error
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Drain the stream; returns the single chunk of a one-shot request
        (None when it aborted before producing one)."""
        out = None
        for c in self.chunks(timeout=timeout):
            out = c if out is None else out
        return out

    @property
    def latency(self) -> Optional[float]:
        """submit -> terminal seconds (None while live)."""
        if not self._entry.state.terminal:
            return None
        return self._entry.finish_t - self._entry.submit_t

    @property
    def queue_depth(self) -> int:
        """Undelivered response chunks (the backpressure signal)."""
        return self._entry.chan.qsize()


#: admission policies -> sort key functions (smaller sorts first)
POLICIES = ("fcfs", "cache_aware")


class Scheduler:
    """Bounded waiting queue + lifecycle bookkeeping for the serving loop.

    ``residency`` is the cache-aware admission signal: a callable mapping a
    :class:`Request` to the fraction of its blocks already device-resident
    (the server wires it to ``SageStore.resident_fraction``); it is only
    consulted under ``policy="cache_aware"``."""

    def __init__(
        self,
        *,
        policy: str = "cache_aware",
        max_waiting: int = 64,
        residency: Optional[Callable[[Request], float]] = None,
    ) -> None:
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        if max_waiting < 1:
            raise ValueError("max_waiting must be >= 1")
        self.policy = policy
        self.max_waiting = max_waiting
        self.residency = residency or (lambda req: 0.0)
        self._lock = threading.Condition(threading.RLock())
        self._waiting: list[_Entry] = []
        self._running: list[_Entry] = []
        self._entries: dict[int, _Entry] = {}
        self._ids = itertools.count()
        self.stats = {
            "submitted": 0, "admitted": 0, "finished": 0, "aborted": 0,
            "rejected": 0, "chunks": 0, "deadline_expired": 0,
        }

    # ------------------------------------------------------------- ingestion
    def submit(self, request: Request, *, timeout: Optional[float] = None) -> ResponseHandle:
        """Enqueue a request (WAITING). When the waiting queue is full,
        blocks up to ``timeout`` seconds for space (``timeout=0`` never
        blocks); raises :class:`QueueFullError` if none frees up."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._lock:
            while len(self._waiting) >= self.max_waiting:
                wait = None if deadline is None else deadline - time.perf_counter()
                if wait is not None and wait <= 0:
                    self.stats["rejected"] += 1
                    raise QueueFullError(
                        f"waiting queue full ({self.max_waiting} requests)"
                    )
                self._lock.wait(wait)
            e = _Entry(
                rid=next(self._ids), seq=self.stats["submitted"], request=request,
                submit_t=time.perf_counter(),
            )
            if request.stream_buffer is None:
                e.chan = queue.Queue()
            else:
                # +1 keeps room for the _End sentinel under full backpressure
                e.chan = queue.Queue(maxsize=request.stream_buffer + 1)
            self._entries[e.rid] = e
            self._waiting.append(e)
            self.stats["submitted"] += 1
            return ResponseHandle(self, e)

    # ------------------------------------------------------------- lifecycle
    def abort(self, rid: int) -> bool:
        """WAITING/RUNNING -> ABORTED. Idempotent; False once terminal."""
        with self._lock:
            e = self._entries.get(rid)
            if e is None or e.state.terminal:
                return False
            if e.state is RequestState.WAITING:
                self._waiting.remove(e)
                self._lock.notify_all()  # a waiting slot freed up
            else:
                self._running.remove(e)
            self._close(e, RequestState.ABORTED)
            return True

    def expire_deadlines(self, now: Optional[float] = None) -> int:
        """Move every overdue request (``deadline_s`` elapsed since submit)
        to ABORTED with :class:`DeadlineExceededError`; returns how many.

        Runs entirely under the scheduler lock, so it serializes against
        ``abort``/``finish``/``deliver`` — a request racing its deadline
        against a concurrent abort or final chunk still closes exactly
        once, through :meth:`_close`."""
        if now is None:
            now = time.perf_counter()
        expired = 0
        with self._lock:
            for e in list(self._waiting) + list(self._running):
                d = e.request.deadline_s
                if d is None or now - e.submit_t < d or e.state.terminal:
                    continue
                if e.state is RequestState.WAITING:
                    self._waiting.remove(e)
                    self._lock.notify_all()
                else:
                    self._running.remove(e)
                e.error = DeadlineExceededError(
                    f"request {e.rid} exceeded deadline_s={d} "
                    f"({now - e.submit_t:.3f}s since submit, state={e.state.value})"
                )
                self._close(e, RequestState.ABORTED)
                self.stats["deadline_expired"] += 1
                expired += 1
        return expired

    def admit(self, max_new: int) -> list[_Entry]:
        """Move up to ``max_new`` requests WAITING -> RUNNING in policy
        order. Cache-aware scoring happens HERE, per admission round, so a
        request whose groups became resident since submission jumps ahead
        (and one whose groups were evicted falls back)."""
        with self._lock:
            if max_new <= 0 or not self._waiting:
                return []
            if self.policy == "cache_aware":
                scored = sorted(
                    self._waiting,
                    key=lambda e: (
                        e.request.priority, -self.residency(e.request), e.seq
                    ),
                )
            else:
                scored = sorted(
                    self._waiting, key=lambda e: (e.request.priority, e.seq)
                )
            picked = scored[:max_new]
            now = time.perf_counter()
            for e in picked:
                self._waiting.remove(e)
                e.state = RequestState.RUNNING
                e.admit_t = now
                self._running.append(e)
            self.stats["admitted"] += len(picked)
            self._lock.notify_all()  # waiting slots freed up
            return picked

    def deliver(self, e: _Entry, chunk: dict) -> bool:
        """Push one response chunk; False (chunk dropped) once terminal.

        The channel is sized ``stream_buffer + 1`` and the batcher stops
        producing at ``stream_buffer`` undelivered chunks, so the only way
        to find it full is a chunk racing an abort — those are dropped, the
        consumer already saw the closing sentinel."""
        with self._lock:
            if e.state.terminal:
                return False
            self.stats["chunks"] += 1
            e.chunks_out += 1
        try:
            e.chan.put_nowait(chunk)
        except queue.Full:  # lost the race with abort(); drop
            return False
        return True

    def has_backpressure(self, e: _Entry) -> bool:
        """True when the consumer lags ``stream_buffer`` chunks — the
        batcher skips this request's work until the client drains."""
        sb = e.request.stream_buffer
        return sb is not None and e.chan.qsize() >= sb

    def finish(self, e: _Entry, error: Optional[BaseException] = None) -> None:
        """RUNNING -> FINISHED (or ABORTED with ``error`` recorded)."""
        with self._lock:
            if e.state.terminal:
                return
            if e in self._running:
                self._running.remove(e)
            elif e in self._waiting:  # defensive: direct finish from waiting
                self._waiting.remove(e)
                self._lock.notify_all()
            e.error = error
            self._close(
                e, RequestState.FINISHED if error is None else RequestState.ABORTED
            )

    def _close(self, e: _Entry, state: RequestState) -> None:
        e.state = state
        e.finish_t = time.perf_counter()
        self.stats["finished" if state is RequestState.FINISHED else "aborted"] += 1
        e.chan.put(_End(state))

    # -------------------------------------------------------------- queries
    @property
    def waiting(self) -> tuple[_Entry, ...]:
        with self._lock:
            return tuple(self._waiting)

    @property
    def running(self) -> tuple[_Entry, ...]:
        with self._lock:
            return tuple(self._running)

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._waiting or self._running)

    def free_slots(self, max_running: int) -> int:
        with self._lock:
            return max(0, max_running - len(self._running))
