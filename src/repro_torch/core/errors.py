"""Typed I/O error taxonomy for the SAGe storage/serving path.

The storage container *is* the accelerator's input format (DESIGN.md §2/§7)
— a flipped bit or torn write in a v2 extent would otherwise be silently
decoded into wrong genomes. Every disk-facing failure in the repo therefore
raises one of these types, so callers at any layer (lazy reader, store,
continuous batcher, checkpoint restore) can catch ONE hierarchy and react
per failure class:

    SageIOError (OSError)
      ├── IntegrityError     checksum mismatch — data is provably corrupt
      ├── TornWriteError     truncated container / missing commit footer /
      │                      persistent short read — an incomplete write
      ├── TransientIOError   a retryable read (EIO, short read) that stayed
      │                      failed after the bounded retry policy
      └── StaleDatasetError  the dataset was re-registered mid-read; the
                             lazy state the read planned against is gone

Subclassing ``OSError`` keeps every pre-existing ``except IOError`` /
``except OSError`` call site working while the typed classes carry the
context graceful degradation needs: the ``path`` and ``section`` that
failed, and (when a store-level read is involved) the ``dataset`` and
``block_group``, so the serving frontend can fail exactly the requests
whose block unions touch the damage and keep everything else flowing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


class SageIOError(OSError):
    """Base of every typed SAGe storage failure.

    ``section`` names the on-disk region involved (``"directory"``,
    ``"extent 17"``, ``"commit footer"``, ...); ``dataset``/``block_group``
    are annotated by the store layer so the serving frontend can isolate
    the failure to the requests that touch it."""

    def __init__(
        self,
        message: str,
        *,
        path: Optional[str] = None,
        section: Optional[str] = None,
        dataset: Optional[str] = None,
        block_group: Optional[int] = None,
        blocks: tuple[int, ...] = (),
    ) -> None:
        super().__init__(message)
        self.path = path
        self.section = section
        self.dataset = dataset
        self.block_group = block_group
        self.blocks = tuple(int(b) for b in blocks)


class IntegrityError(SageIOError):
    """A checksum disagreed with the bytes read — provable corruption."""


class TornWriteError(SageIOError):
    """The container is incomplete: a section came up short, or the commit
    footer of a checksummed container is missing/invalid (crashed writer)."""


class TransientIOError(SageIOError):
    """A retryable read failure (EIO, short read) that persisted through
    the bounded :class:`RetryPolicy` — the device may recover later."""


class StaleDatasetError(SageIOError):
    """The dataset was re-registered while a lazy read was in flight; the
    read's planning state (reader handle, extent table) no longer matches
    the registered source. The store retries once internally; seeing this
    means the race repeated."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry-with-exponential-backoff for ranged container reads.

    ``attempts`` counts total tries (1 = no retry). Between tries the
    reader sleeps ``backoff_s * mult**i`` capped at ``max_backoff_s`` and
    re-opens the file (an EIO can poison the descriptor). Defaults are
    tuned for tests/CI; production stores pass their own."""

    attempts: int = 3
    backoff_s: float = 0.002
    mult: float = 4.0
    max_backoff_s: float = 0.25

    def __post_init__(self) -> None:
        if self.attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts}")
        if self.backoff_s < 0 or self.max_backoff_s < 0 or self.mult < 1:
            raise ValueError("backoff_s/max_backoff_s must be >= 0 and mult >= 1")

    def delay(self, retry_index: int) -> float:
        """Sleep before the ``retry_index``-th retry (0-based)."""
        return min(self.backoff_s * self.mult**retry_index, self.max_backoff_s)


DEFAULT_RETRY = RetryPolicy()

__all__ = [
    "SageIOError",
    "IntegrityError",
    "TornWriteError",
    "TransientIOError",
    "StaleDatasetError",
    "RetryPolicy",
    "DEFAULT_RETRY",
]
