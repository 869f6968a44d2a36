"""Background scrubber: rate-limited incremental CRC sweeps + auto-repair
(the port of ``src/repro/core/scrub.py``; host only, it makes no CUDA call).

Latent at-rest corruption is only caught by the checksum layer when a
read happens to touch the damaged extent — cold blocks can rot silently
until the day they are needed, by which time collateral damage may exceed
the parity budget. Production storage closes that window with proactive
*scrubbing*: a low-priority sweep that touches every byte on a schedule.
:class:`Scrubber` is that sweep for a :class:`repro_torch.core.store.SageStore`:

- **incremental**: a per-dataset cursor advances ``chunk_blocks`` extents
  at a time, so a sweep can be paused/resumed/stopped at chunk
  granularity and a partial pass picks up where it left off;
- **rate-limited**: ``rate_bps`` bounds the sweep's disk-read bandwidth
  (cumulative pacing over the pass), so scrubbing never starves serving;
- **self-healing**: a damaged extent triggers ``store.repair`` on its
  covering store block group — parity-fixable damage is rewritten and
  re-verified in place, unrecoverable damage is quarantined with the
  typed error (exactly the degraded/quarantined split of DESIGN.md §10);
- **observable**: attaching the scrubber makes ``store.health()`` report
  per-dataset sweep progress and the latest findings.

Sweeps run either synchronously (:meth:`run_once`, the deterministic path
tests and the CLI use) or on a daemon worker thread
(:meth:`start`/:meth:`pause`/:meth:`resume`/:meth:`stop`) that re-sweeps
every ``interval_s`` seconds.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from repro_torch.core.errors import SageIOError


class Scrubber:
    """Incremental CRC sweep over a store's registered v2 containers.

    Constructing a scrubber ATTACHES it to the store (one per store):
    ``store.health()`` starts reporting scrub state immediately. Eager
    sources (in-memory SageFiles, v1 archives) and pre-checksum
    containers are skipped — there is nothing verifiable to sweep."""

    def __init__(
        self,
        store,
        *,
        rate_bps: Optional[float] = None,
        chunk_blocks: int = 64,
        interval_s: float = 30.0,
        auto_repair: bool = True,
    ) -> None:
        if rate_bps is not None and rate_bps <= 0:
            raise ValueError(f"rate_bps must be > 0 or None, got {rate_bps}")
        if chunk_blocks < 1:
            raise ValueError(f"chunk_blocks must be >= 1, got {chunk_blocks}")
        if interval_s < 0:
            raise ValueError(f"interval_s must be >= 0, got {interval_s}")
        self.store = store
        self.rate_bps = rate_bps
        self.chunk_blocks = chunk_blocks
        self.interval_s = interval_s
        self.auto_repair = auto_repair
        self._cursors: dict[str, int] = {}
        self._cur_findings: list[dict] = []  # accumulating, this sweep
        self._last_findings: list[dict] = []  # last COMPLETED sweep
        self._sweeps = 0
        self._blocks_scanned = 0
        self._bytes_scanned = 0
        self._sweep_errors = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._resume = threading.Event()
        self._resume.set()
        self._lock = threading.RLock()
        store._scrubber = self

    # -------------------------------------------------------------- sweeping
    def run_once(
        self, name: Optional[str] = None, max_blocks: Optional[int] = None
    ) -> dict:
        """One synchronous sweep pass from the current cursors.

        Scans ``name`` (or every registered dataset) forward by at most
        ``max_blocks`` extents total (``None`` = to the end), CRC-checking
        each and repairing/quarantining damage as configured. Returns the
        pass summary; ``complete`` is True when every swept dataset's
        cursor wrapped (which also publishes the sweep's findings to
        ``store.health``)."""
        names = [name] if name is not None else list(self.store.names())
        budget = max_blocks
        findings: list[dict] = []
        blocks = nbytes = 0
        t0 = time.monotonic()
        complete = True
        for n in names:
            try:
                r = self.store._reader(n)
            except (KeyError, ValueError, OSError):
                if name is not None:
                    raise  # explicit dataset: surface the problem
                continue  # racing unregister/re-register: skip this pass
            if r is None or r._extent_crcs is None:
                continue  # eager or pre-checksum source: nothing to verify
            nb = r.meta.n_blocks
            cur = self._cursors.get(n, 0)
            if cur >= nb:
                cur = 0
            while cur < nb:
                if self._stop.is_set():
                    complete = False
                    break
                self._resume.wait()
                if budget is not None and budget <= 0:
                    complete = False
                    break
                hi = min(cur + self.chunk_blocks, nb)
                if budget is not None:
                    hi = min(hi, cur + budget)
                ids = np.arange(cur, hi, dtype=np.int64)
                bad = r.verify_blocks(ids)
                blocks += ids.size
                # pace on STORED bytes (per-extent, variable under the
                # codec) — the scan's actual disk traffic, not the padded
                # slot stride
                step_nbytes = int(r.extents[ids, 1].sum())
                nbytes += step_nbytes
                if budget is not None:
                    budget -= int(ids.size)
                findings.extend(self._handle_damage(n, bad))
                cur = hi
                with self._lock:
                    self._cursors[n] = cur % nb if nb else 0
                    self._blocks_scanned += int(ids.size)
                    self._bytes_scanned += step_nbytes
                if self.rate_bps is not None:
                    # cumulative pacing: sleep until the pass-average read
                    # rate drops back under the budget
                    lag = nbytes / self.rate_bps - (time.monotonic() - t0)
                    if lag > 0:
                        time.sleep(lag)
            else:
                continue
            break  # inner loop stopped early -> stop the pass
        elapsed = time.monotonic() - t0
        with self._lock:
            self._cur_findings.extend(findings)
            if complete:
                self._sweeps += 1
                self._last_findings = list(self._cur_findings)
                self._cur_findings = []
        return {
            "complete": complete,
            "blocks_scanned": blocks,
            "bytes_scanned": nbytes,
            "elapsed_s": elapsed,
            "effective_bps": (nbytes / elapsed) if elapsed > 0 else 0.0,
            "findings": findings,
        }

    def _handle_damage(self, name: str, bad: list[int]) -> list[dict]:
        """Route damaged blocks to repair (or quarantine): one
        ``store.repair`` per covering store block group."""
        if not bad:
            return []
        findings = []
        gb = self.store.group_blocks
        for gi in sorted({int(b) // gb for b in bad}):
            blocks = tuple(b for b in bad if b // gb == gi)
            f = {"dataset": name, "group": gi, "blocks": blocks}
            if not self.auto_repair:
                f["action"] = "found"
                self.store.quarantine(name, gi)
            else:
                try:
                    r = self.store.repair(name, group=gi)
                    f["action"] = "repaired"
                    f["repaired_blocks"] = tuple(r["repaired_blocks"])
                except SageIOError as e:
                    # repair already quarantined the group; keep sweeping
                    f["action"] = "quarantined"
                    f["error"] = type(e).__name__
            findings.append(f)
        return findings

    # -------------------------------------------------------- worker thread
    def start(self) -> None:
        """Run sweeps on a daemon thread, one pass every ``interval_s``."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                raise RuntimeError("scrubber is already running")
            self._stop.clear()
            self._resume.set()
            self._thread = threading.Thread(
                target=self._loop, name="sage-scrub", daemon=True
            )
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._resume.wait()
            if self._stop.is_set():
                return
            try:
                self.run_once()
            except (SageIOError, ValueError, KeyError, IndexError, OSError):
                # a single bad pass (racing re-register, vanished file)
                # must not kill the scrub thread; the next interval retries
                with self._lock:
                    self._sweep_errors += 1
            self._stop.wait(self.interval_s)

    def pause(self) -> None:
        """Suspend sweeping at the next chunk boundary (cursor kept)."""
        self._resume.clear()

    def resume(self) -> None:
        self._resume.set()

    def stop(self, join: bool = True, timeout: float = 10.0) -> None:
        """Stop the worker thread (idempotent; also unblocks a pause)."""
        self._stop.set()
        self._resume.set()
        t = self._thread
        if join and t is not None and t.is_alive():
            t.join(timeout)

    # -------------------------------------------------------- observability
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def paused(self) -> bool:
        return not self._resume.is_set()

    def status(self) -> dict:
        with self._lock:
            return {
                "running": self.running,
                "paused": self.paused,
                "rate_bps": self.rate_bps,
                "auto_repair": self.auto_repair,
                "sweeps_completed": self._sweeps,
                "blocks_scanned": self._blocks_scanned,
                "bytes_scanned": self._bytes_scanned,
                "sweep_errors": self._sweep_errors,
                "pending_findings": len(self._cur_findings),
                "last_findings": list(self._last_findings),
            }

    def status_for(self, name: str) -> dict:
        """Per-dataset slice of scrub state (what ``store.health`` embeds):
        sweep cursor/progress plus this dataset's findings from the last
        completed sweep (and any pending from the in-flight one)."""
        with self._lock:
            cursor = self._cursors.get(name, 0)
            try:
                nb = self.store.n_blocks(name)
            except (KeyError, ValueError, OSError):
                nb = 0
            mine = [
                f for f in self._last_findings + self._cur_findings
                if f["dataset"] == name
            ]
            return {
                "cursor": cursor,
                "n_blocks": nb,
                "progress": (cursor / nb) if nb else 0.0,
                "sweeps_completed": self._sweeps,
                "findings": mine,
            }


__all__ = ["Scrubber"]
