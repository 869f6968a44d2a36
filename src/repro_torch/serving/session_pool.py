"""Multi-tenant SageStore session pool (the port of
``src/repro/serving/session_pool.py``).

Concurrent serving requests must NOT each open their own store: device
residency (the block-granular prepared LRU), the host extent cache and
the codec dictionaries on the device are all store-level state, and N
per-request stores would hold N copies of every hot block group —
thrashing exactly the memory the LRU exists to protect.

The pool owns ONE :class:`SageStore` (on ``cuda`` unless ``device="cpu"``
is passed through) and hands out shared :class:`SageReadSession` views
keyed by the decode path, ``fused`` (two-step by default) — sessions are
stateless views (store + flag), so any number of tenants can hold the
same one. Hot datasets therefore stay resident
once across every request that touches them, and the pool is the single
place the serving frontend asks about residency (cache-aware admission),
per-block memory cost (batch formation), and cache/IO counters
(observability).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from repro_torch.core.errors import SageIOError
from repro_torch.core.store import SageReadSession, SageStore


class SessionPool:
    """Shared store + per-decode-path session reuse for the serving loop.

    Pass an existing ``store`` to serve datasets other components already
    registered (the training pipeline, a migration CLI, ...), or let the
    pool build one from ``store_kwargs`` (``device``, ``shards``, ``mesh``, ``max_prepared``,
    ``group_blocks``, ``cache_budget``, ...)."""

    def __init__(self, store: Optional[SageStore] = None, **store_kwargs) -> None:
        if store is not None and store_kwargs:
            raise ValueError(
                f"pass store= or store kwargs {sorted(store_kwargs)}, not both"
            )
        self.store = store if store is not None else SageStore(**store_kwargs)
        self._sessions: dict[bool, SageReadSession] = {}
        self._lock = threading.Lock()
        self.residency_score_errors = 0  # scoring failures, no longer silent

    # ------------------------------------------------------------- sessions
    def session(self, *, fused: bool = False) -> SageReadSession:
        """The shared session for a decode path (created once per path):
        two-step by default, ``fused=True`` for gather+decode+format in one
        kernel."""
        with self._lock:
            s = self._sessions.get(fused)
            if s is None:
                s = self.store.session(fused=fused)
                self._sessions[fused] = s
            return s

    @property
    def n_sessions(self) -> int:
        with self._lock:
            return len(self._sessions)

    # ------------------------------------------------- dataset registration
    def register(self, name: str, src) -> None:
        self.store.register(name, src)

    def write(self, name: str, read_set, consensus, **kwargs):
        return self.store.write(name, read_set, consensus, **kwargs)

    def names(self) -> tuple[str, ...]:
        return self.store.names()

    # ------------------------------------------------- scheduling interface
    def resident_fraction(self, name: str, ids=None) -> float:
        return self.store.resident_fraction(name, ids)

    def block_nbytes(self, name: str) -> int:
        return self.store.block_nbytes(name)

    def request_residency(self, request) -> float:
        """Cache-aware admission score for a serving request: the resident
        fraction of the blocks its NEXT unit of work touches (a stream
        scores its next chunk, not its whole range). Unresolvable requests
        score 0.0 — admission ranking must never raise for a request that
        will fail with its own typed error at execution anyway, but only
        the errors that legitimately mean "can't score this request" are
        swallowed (storage failures, bad ranges); anything else is a real
        bug and propagates. ``residency_score_errors`` counts the
        swallowed ones so scoring failures stay visible."""
        req = request
        if not req.dataset or req.dataset not in self.store.names():
            return 0.0
        try:
            ids = self.session().resolve_blocks(req.dataset, req.block_range)
            if req.kind == "isp":
                ids = ids[: req.blocks_per_fetch]
            return self.store.resident_fraction(req.dataset, ids)
        except (SageIOError, ValueError, IndexError, KeyError):
            with self._lock:
                self.residency_score_errors += 1
            return 0.0

    # -------------------------------------------------------- consumer glue
    def pipeline(self, name: str, vocab_size: int, batch: int, seq_len: int, **kwargs):
        """A :class:`SageTokenPipeline` over a pooled dataset that SHARES
        this pool's store and session — training-side streaming reuses the
        serving fetch path (one residency, one set of codec dictionaries)
        instead of opening a second store."""
        from repro_torch.data.pipeline import SageTokenPipeline

        kwargs.setdefault("session", self.session())
        return SageTokenPipeline(
            name, vocab_size, batch, seq_len, store=self.store, **kwargs
        )

    # --------------------------------------------------------- observability
    def stats(self) -> dict:
        """One snapshot across the pool's store: prepared-LRU counters,
        container I/O, and residency keys (for dashboards/tests)."""
        return {
            "cache": self.store.cache_stats(),
            "io": dict(self.store.io_stats),
            "prepared_keys": [list(k) for k in self.store.prepared_keys],
            "sessions": self.n_sessions,
            "residency_score_errors": self.residency_score_errors,
        }


def resolve_ids(session: SageReadSession, name: str, block_range) -> np.ndarray:
    """Convenience re-export of the session's range normalization (used by
    benches that plan traffic without submitting it)."""
    return session.resolve_blocks(name, block_range)
