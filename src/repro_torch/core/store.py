"""`SageStore`: the session-based streaming access layer over SAGe containers.

The single surface every consumer goes through. It maps the paper's
three-command contract (§5.3) onto:

  SAGe_Write  ``store.write(name, read_set, consensus)`` — compress + register
  SAGe_Read   ``session.read(name, block_range, fmt, kmer_k=...)`` — ranged,
              batched decode of any registered dataset to any FormatSpec
  SAGe_ISP    ``session.read_stream(name, consumer, ...)`` — hands each decoded
              block group to an analysis-side consumer as soon as it is ready

A store registers many datasets by name (``SageFile`` objects or lazy paths)
and keeps an LRU of prepared :class:`DeviceBlocks` so hot datasets stay
resident on the store's device (``device="cuda"`` by default; ``"cpu"`` runs
the plain torch versions of the kernels). On a codec container the hot path
is: ranged extent read (host) -> pinned, non-blocking upload -> codec
unpack kernel -> on-device block gather -> block decode kernel -> reformat
kernel, with no host round trip between the device stages; a fused session
(``session(fused=True)``) runs gather, decode and format as one kernel.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import weakref
from collections import OrderedDict, deque
from pathlib import Path
from typing import Callable, Iterator, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.api import apply_format, available_formats, get_format
from repro_torch.core.bitio import unpack_2bit_batch
from repro_torch.core.blocks import block_row_widths, localize_directory
from repro_torch.core.decode_torch import (
    DeviceBlocks,
    Uploader,
    decode_blocks_bucketed,
    fused_decode_blocks_bucketed,
    fused_format_supported,
    prepare_device_blocks,
    resolve_device,
    unpack_block_rows,
)
from repro_torch.core.encoder import SageEncoder
from repro_torch.core.errors import (
    IntegrityError,
    SageIOError,
    StaleDatasetError,
    TornWriteError,
)
from repro_torch.core.format import D, SageFile, SageMeta
from repro_torch.core.layout import (
    HostExtentCache,
    SageContainerV2,
    container_version,
    new_io_stats,
    write_v2,
)

BlockRange = Union[None, int, tuple, Sequence[int]]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def slice_device_blocks(db: DeviceBlocks, ids: np.ndarray) -> DeviceBlocks:
    """A DeviceBlocks view holding only the selected blocks (block-major
    gather; blocks decode independently, so any subset is decodable)."""
    if db.on_device:
        idx = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=db.device)
        arrays = {k: v.index_select(0, idx) for k, v in db.arrays.items()}
    else:
        arrays = {k: v[ids] for k, v in db.arrays.items()}
    return dataclasses.replace(db, arrays=arrays, n_blocks=len(ids))


@dataclasses.dataclass
class StreamBatch:
    """One SAGe_ISP delivery: a decoded (and formatted) group of blocks.

    ``data`` holds tensors on the store's device — nothing is copied to the
    host; consumers that want numpy call ``.cpu().numpy()`` themselves."""

    name: str
    epoch: int
    block_ids: np.ndarray  # global block indices in stream order
    data: dict[str, torch.Tensor]  # decode result (+ the format's out_key)
    next_block: int = 0  # stream cursor after this fetch (consumers resume here)
    next_epoch: int = 0  # epochs completed after this fetch, relative to stream start


class SageStore:
    """Registry of SAGe datasets with LRU-cached device preparation.

    ``device`` is where prepared blocks live and decode runs: ``"cuda"``
    (default; raises ``RuntimeError`` when no card is present) runs the
    CUDA kernels, ``"cpu"`` their plain torch versions. ``uploader`` moves
    every host array of the store to the device (pinned memory, one copy
    stream of the store's own, see :class:`Uploader`).

    Residency is **block-granular** for out-of-core (v2 block-extent)
    datasets: the device LRU keys on ``(dataset, block_group)`` — groups of
    ``group_blocks`` blocks — and a byte-budget host extent cache
    (``cache_budget``) sits beneath it, so a ranged read touches only the
    requested blocks' bytes end-to-end: disk -> host cache -> device.
    Eager sources (in-memory SageFiles, v1 ``.npz`` paths) keep whole-file
    residency under the same LRU (key ``(dataset, None)``). ``io_stats``
    counts every container byte moved."""

    def __init__(
        self,
        max_prepared: int = 4,
        *,
        device="cuda",
        group_blocks: int = 32,
        cache_budget: Optional[int] = 256 * 2**20,
        mesh=None,
        shards: Optional[int] = None,
    ) -> None:
        if mesh is not None or shards is not None:
            raise _not_ported("SageStore(mesh=/shards=)", "Queue A, slice 7: multi-GPU")
        if max_prepared < 1:
            raise ValueError("max_prepared must be >= 1")
        if group_blocks < 1:
            raise ValueError("group_blocks must be >= 1")
        self.device = resolve_device(device)
        self.max_prepared = max_prepared
        self.group_blocks = group_blocks
        self.last_write_stats: dict = {}
        self._sources: dict[str, Union[SageFile, str]] = {}
        self._files: dict[str, SageFile] = {}
        self._readers: dict[str, SageContainerV2] = {}
        self._not_v2: set[str] = set()  # cached sniff verdicts for eager sources
        self._prepared: "OrderedDict[tuple, DeviceBlocks]" = OrderedDict()
        self._io = new_io_stats()
        self._io["group_uploads"] = 0
        self._io["stale_retries"] = 0
        for k in (
            "stream_fetches", "stream_io_groups", "stream_slot_releases",
            "stream_inflight_hwm", "stream_slot_hwm",
        ):
            self._io[k] = 0
        for k in (
            "stream_io_seconds", "stream_upload_seconds",
            "stream_dispatch_seconds", "stream_consume_seconds",
            "stream_wall_seconds",
        ):
            self._io[k] = 0.0
        self.uploader = Uploader(self.device)
        # codec dictionaries on the device, uploaded once per reader
        self._device_dicts: "weakref.WeakKeyDictionary[SageContainerV2, torch.Tensor]" = (
            weakref.WeakKeyDictionary()
        )
        self._extent_cache = HostExtentCache(cache_budget)
        self._cache_stats: dict[str, dict[str, int]] = {}
        self._quarantine: dict[str, set[int]] = {}
        self._scrubber = None  # set by repro_torch.core.scrub.Scrubber
        self._lock = threading.RLock()
        # serializes container disk access only, so a prefetching reader of
        # one group never holds the lock a consumer needs to decode another
        self._disk_lock = threading.Lock()

    # ---------------------------------------------------------- registration
    def register(self, name: str, src: Union[SageFile, str, Path]) -> None:
        """Register a dataset: an in-memory SageFile or a container path.

        Paths are validated eagerly — the file must exist and carry a
        recognizable container magic — so a typo fails here, naming the
        dataset, instead of at the first read. v2 block-extent paths stay
        lazy (header-only open on first access); v1 ``.npz`` paths load
        whole-file on first access."""
        if not isinstance(src, SageFile):
            src = str(src)
            if not Path(src).is_file():
                raise FileNotFoundError(
                    f"dataset {name!r}: container path {src!r} does not exist"
                )
            try:
                container_version(src)
            except ValueError as e:
                raise ValueError(f"dataset {name!r}: {e}") from None
        with self._lock:
            self._sources[name] = src
            self._files.pop(name, None)
            self._readers.pop(name, None)
            self._not_v2.discard(name)
            self._extent_cache.drop(name)
            self._quarantine.pop(name, None)  # a fresh source is healthy
            for key in [k for k in self._prepared if k[0] == name]:
                self._prepared.pop(key)

    def source(self, name: str) -> Union[SageFile, str, None]:
        """The raw registered source for ``name`` (None when unregistered)."""
        with self._lock:
            return self._sources.get(name)

    def write(
        self,
        name: str,
        read_set,
        consensus: np.ndarray,
        token_target: int = 65536,
        batched: bool = True,
        verify: bool = True,
        layout: str = "memory",
        path: Union[str, Path, None] = None,
        align: int = 4096,
        **enc_kwargs,
    ) -> SageFile:
        """SAGe_Write: compress ``read_set`` against ``consensus`` and register
        the result under ``name``.

        ``batched`` (default) selects the vectorized ingest pipeline
        (batched seeding, the banded-DP kernel, columnar stream packing) and
        ``verify`` its decode-round-trip losslessness check (the block-decode
        kernel), both on the store's device; ``batched=False`` runs the
        sequential reference encoder on the host (the same SageFile, much
        slower). Encoder statistics and phase timings land in
        ``self.last_write_stats``.

        ``layout`` picks the registered form: ``"memory"`` (default)
        registers the in-memory SageFile; ``"v1"`` saves the monolithic
        ``.npz`` archive at ``path``; ``"v2"`` writes the out-of-core
        block-extent container at ``path`` (alignment ``align``) and
        registers the lazy path, so subsequent reads are ranged."""
        if layout not in ("memory", "v1", "v2"):
            raise ValueError(f"layout must be 'memory', 'v1', or 'v2', got {layout!r}")
        if layout != "memory" and path is None:
            raise ValueError(f"store.write(layout={layout!r}) needs path=")
        enc = SageEncoder(
            consensus, token_target=token_target, batched=batched,
            verify=verify, device=self.device, **enc_kwargs,
        )
        sf = enc.encode(read_set)
        self.last_write_stats = dict(enc.stats)
        if layout == "v2":
            self.last_write_stats["container"] = write_v2(sf, path, align=align)
            self.register(name, path)
        elif layout == "v1":
            sf.save(path)
            self.register(name, path)
        else:
            self.register(name, sf)
        return sf

    def names(self) -> tuple[str, ...]:
        return tuple(self._sources)

    def evict(self, name: Optional[str] = None) -> None:
        """Drop prepared device state (all datasets when ``name`` is None).
        Block-group residencies of ``name`` are dropped along with any
        whole-file residency; the host extent cache is left intact (use
        ``register`` to invalidate it)."""
        with self._lock:
            if name is None:
                self._prepared.clear()
            else:
                for key in [k for k in self._prepared if k[0] == name]:
                    self._prepared.pop(key)

    @property
    def prepared_names(self) -> tuple[str, ...]:
        """Datasets with whole-file device residency, LRU order (oldest
        first). Block-granular residencies are listed by ``prepared_keys``."""
        return tuple(k[0] for k in self._prepared if k[1] is None)

    @property
    def prepared_keys(self) -> tuple[tuple, ...]:
        """Every device residency key, LRU order: ``(name, None)`` for
        whole-file entries, ``(name, group_index)`` for block groups."""
        return tuple(self._prepared)

    # ------------------------------------------------------ cache observability
    def _bump_cache(self, name: str, event: str) -> None:
        """Count a prepared-LRU event (``hits``/``misses``/``evictions``)
        against ``name``'s per-dataset counters (lock held by callers)."""
        d = self._cache_stats.setdefault(
            name, {"hits": 0, "misses": 0, "evictions": 0}
        )
        d[event] += 1

    def cache_stats(self, name: Optional[str] = None) -> dict:
        """Prepared-LRU counters: device-residency hits, misses (prepare +
        upload events), and evictions, per dataset.

        ``name`` selects one dataset's counters (zeros if it never hit the
        LRU); ``None`` returns ``{"per_dataset": {...}, "total": {...}}``.
        The storage-level mirror sits in ``io_stats``; these counters are
        what cache-aware admission (serving/scheduler.py) keys on."""
        with self._lock:
            if name is not None:
                return dict(
                    self._cache_stats.get(
                        name, {"hits": 0, "misses": 0, "evictions": 0}
                    )
                )
            total = {"hits": 0, "misses": 0, "evictions": 0}
            per = {}
            for n, d in self._cache_stats.items():
                per[n] = dict(d)
                for k in total:
                    total[k] += d[k]
            return {"per_dataset": per, "total": total}

    def reset_cache_stats(self) -> None:
        """Zero the prepared-LRU counters (residency itself is untouched)."""
        with self._lock:
            self._cache_stats.clear()

    def resident_fraction(self, name: str, ids=None) -> float:
        """Fraction of the requested blocks already device-resident.

        For lazy (v2) sources: the fraction of ``ids`` whose covering block
        group currently sits in the device LRU (``ids=None`` = all blocks).
        For eager sources residency is whole-file, so the answer is 1.0 or
        0.0. This is the admission signal for cache-aware scheduling —
        requests scoring high here decode without any disk or upload work.
        Unregistered datasets score 0.0 (submission-time validation belongs
        to the caller)."""
        with self._lock:
            if name not in self._sources:
                return 0.0
            try:
                r = self._reader(name)
            except (OSError, ValueError):
                return 0.0
            if r is None:
                return 1.0 if (name, None) in self._prepared else 0.0
            if ids is None:
                gids = np.arange(
                    -(-r.meta.n_blocks // self.group_blocks), dtype=np.int64
                )
            else:
                gids = np.asarray(ids, dtype=np.int64) // self.group_blocks
            if gids.size == 0:
                return 1.0
            resident = np.fromiter(
                ((name, int(g)) in self._prepared for g in gids),
                dtype=bool, count=gids.size,
            )
            return float(resident.mean())

    # ---------------------------------------------------------------- health
    def health(self, name: Optional[str] = None) -> dict:
        """Per-dataset integrity health.

        One dataset: ``{"ok", "quarantined_groups"}`` — ``ok`` is False
        while any block group is quarantined (a confirmed
        ``IntegrityError``/``TornWriteError`` on its bytes). All datasets
        (``name=None``): ``{dataset: {...}}`` for every registered name.
        Quarantined groups fail fast with the original typed error on
        re-access instead of re-reading known-bad bytes; healthy groups of
        the same dataset keep serving (the serving frontend keys its
        failure isolation on exactly this granularity).

        With a :class:`repro_torch.core.scrub.Scrubber` attached, every
        dataset dict additionally carries ``"scrub"`` — sweep progress and
        the last sweep's findings for that dataset.

        Asking about an unregistered dataset raises ``ValueError`` naming
        it (consistent with ``register``'s eager validation) — a typo'd
        monitoring probe must not read as a clean bill of health."""
        with self._lock:
            if name is not None:
                if name not in self._sources:
                    raise ValueError(
                        f"dataset {name!r} is not registered; have {self.names()}"
                    )
                q = tuple(sorted(self._quarantine.get(name, ())))
                out = {"ok": not q, "quarantined_groups": q}
                if self._scrubber is not None:
                    out["scrub"] = self._scrubber.status_for(name)
                return out
            report = {
                n: {
                    "ok": not self._quarantine.get(n),
                    "quarantined_groups": tuple(sorted(self._quarantine.get(n, ()))),
                }
                for n in self._sources
            }
            if self._scrubber is not None:
                for n in report:
                    report[n]["scrub"] = self._scrubber.status_for(n)
            return report

    def clear_quarantine(self, name: str, group: Optional[int] = None) -> None:
        """Lift quarantine after repair (``group=None`` clears the dataset).

        Also drops the cached reader handle and the affected host-cache
        entries, so the next access re-opens the container (picking up
        rewritten bytes and their checksums) instead of trusting state
        planned against the damaged file."""
        with self._lock:
            q = self._quarantine.get(name)
            if q is None:
                return
            groups = tuple(q) if group is None else (group,)
            if group is None:
                self._quarantine.pop(name, None)
            else:
                q.discard(group)
                if not q:
                    self._quarantine.pop(name, None)
            self._readers.pop(name, None)
            for gi in groups:
                self._extent_cache.drop(name, gi)
                self._prepared.pop((name, gi), None)

    def _quarantine_group(self, name: str, gi: int, err: SageIOError) -> None:
        """Record a confirmed-corrupt group and purge every cached form of
        it (host extent cache + device LRU) — nothing downstream can keep
        serving bytes the checksum layer just proved wrong. Lock held."""
        if isinstance(err, (IntegrityError, TornWriteError)):
            self._quarantine.setdefault(name, set()).add(gi)
        # transient failures purge caches too (the read never completed)
        # but do NOT quarantine: the device may recover on the next access
        self._extent_cache.drop(name, gi)
        self._prepared.pop((name, gi), None)

    def quarantine(
        self, name: str, group: int, error: Optional[SageIOError] = None
    ) -> None:
        """Quarantine a block group explicitly — the scrubber's path for
        damage parity cannot fix (the internal path quarantines on the
        original read error). Re-access fails fast until ``repair`` (or
        ``clear_quarantine``) lifts it."""
        with self._lock:
            if name not in self._sources:
                raise ValueError(
                    f"dataset {name!r} is not registered; have {self.names()}"
                )
            err = error if error is not None else IntegrityError(
                f"dataset {name!r} block group {group} quarantined",
                dataset=name, block_group=group,
            )
            self._quarantine_group(name, group, err)

    def repair(self, name: str, group: Optional[int] = None) -> dict:
        """Scan, reconstruct, and durably rewrite damaged extents of a v2
        dataset; quarantine lifts only after a fresh-handle re-verify.

        Scope: ``group`` repairs one store block group; ``None`` repairs
        every currently-quarantined group, or — with nothing quarantined —
        scans the whole container (the scrubber's full-sweep path). The
        sequence per scope: CRC-scan the extents, rebuild the damaged ones
        from parity + survivors (:meth:`SageContainerV2.reconstruct_blocks`),
        atomically rewrite them (tmp + fsync + ``os.replace``), then scan +
        rebuild + rewrite damaged parity shards from the now-clean data,
        re-open the container fresh and re-verify before clearing the
        quarantine. Damage exceeding the parity budget (or a container
        without parity) quarantines the affected groups and re-raises the
        typed :class:`IntegrityError`. Returns a summary dict."""
        with self._lock:
            if name not in self._sources:
                raise ValueError(
                    f"dataset {name!r} is not registered; have {self.names()}"
                )
            r = self._reader(name)
            if r is None:
                raise ValueError(
                    f"dataset {name!r} is not a v2 block-extent container — "
                    f"repair applies to lazy (v2) sources only"
                )
            nb = r.meta.n_blocks
            gb = self.group_blocks
            n_groups = -(-nb // gb)
            if group is not None:
                if not 0 <= group < n_groups:
                    raise ValueError(
                        f"dataset {name!r} has {n_groups} block groups; "
                        f"group {group} out of range"
                    )
                scope = {int(group)}
            elif self._quarantine.get(name):
                scope = set(self._quarantine[name])
            else:
                scope = None  # full sweep
            if scope is None:
                ids = None
                scanned = nb
            else:
                ids = np.concatenate([
                    np.arange(g * gb, min((g + 1) * gb, nb), dtype=np.int64)
                    for g in sorted(scope)
                ])
                scanned = int(ids.size)
            bad = r.verify_blocks(ids)
            repaired: dict = {}
            if bad:
                try:
                    repaired = r.reconstruct_blocks(bad)
                except IntegrityError as e:
                    e.dataset = name
                    for b in e.blocks or bad:
                        self._quarantine_group(name, int(b) // gb, e)
                    raise
                r.rewrite_extents(repaired)
            # parity shards are rebuilt AFTER the data rewrite — their
            # recompute reads group members from the (now clean) medium
            pgroups = None
            if r.parity is not None and ids is not None:
                pg = int(r.parity["group_blocks"])
                pgroups = sorted({int(b) // pg for b in ids})
            bad_parity = r.verify_parity(pgroups)
            parity_fixed: dict = {}
            if bad_parity:
                parity_fixed = r.rebuild_parity(bad_parity)
                r.rewrite_extents({}, parity_fixed)
            # fresh handle: re-verify the repaired bytes end-to-end before
            # any quarantine lifts (the old handle may hold stale state);
            # the codec dictionaries on the device were keyed by the old
            # handle, and re-upload from the fresh one on the next miss
            self._readers.pop(name, None)
            self._device_dicts.pop(r, None)
            fresh = self._reader(name)
            still_bad = fresh.verify_blocks(ids)
            if still_bad:
                err = IntegrityError(
                    f"dataset {name!r}: repair re-verify failed for "
                    f"block(s) {still_bad} — quarantine stands",
                    dataset=name, path=str(fresh.path),
                    blocks=tuple(still_bad),
                )
                for b in still_bad:
                    self._quarantine_group(name, int(b) // gb, err)
                raise err
            q = set(self._quarantine.get(name, ()))
            lifted = sorted(q if scope is None else (q & scope))
            for gi in lifted:
                self.clear_quarantine(name, gi)
            # repaired bytes equal the originally-committed bytes (CRC-
            # verified), so surviving cache entries (host extent cache and
            # device LRU) are already correct
            return {
                "dataset": name,
                "scanned_blocks": scanned,
                "damaged_blocks": sorted(int(b) for b in bad),
                "repaired_blocks": sorted(int(b) for b in repaired),
                "repaired_parity_shards": sorted(int(p) for p in parity_fixed),
                "lifted_groups": lifted,
            }

    def block_nbytes(self, name: str) -> int:
        """Per-block device payload bytes in the prepared block-major layout
        (streams + consensus window rows) — what one block of ``name`` costs
        in device residency; the unit of memory-aware batch formation."""
        return 4 * sum(block_row_widths(self.meta(name)).values())

    @property
    def io_stats(self) -> dict:
        """Container I/O counters (disk bytes, ranged reads, host extent
        cache traffic) — the storage-level mirror of the pipeline's
        ``transfer_stats``. Snapshot; mutate via ``reset_io_stats``."""
        d = dict(self._io)
        d.update(self._extent_cache.stats)
        stage = (
            d["stream_io_seconds"] + d["stream_upload_seconds"]
            + d["stream_dispatch_seconds"] + d["stream_consume_seconds"]
        )
        # overlap of the pipelined stream's stages: 1 - wall/sum(stages) is 0
        # for a fully serial pipeline and approaches 1 - 1/n_stages when
        # every stage hides behind the slowest one
        d["stream_overlap_fraction"] = (
            1.0 - d["stream_wall_seconds"] / stage if stage > 0 else 0.0
        )
        return d

    def reset_io_stats(self) -> None:
        """Zero the I/O counters (current cache residency bytes are kept —
        they describe state, not traffic — but the peak is rebased)."""
        with self._lock:
            for k in self._io:
                self._io[k] = 0
            st = self._extent_cache.stats
            for k in st:
                if k not in ("cache_bytes", "cache_peak_bytes"):
                    st[k] = 0
            st["cache_peak_bytes"] = st["cache_bytes"]

    # --------------------------------------------------------------- access
    def _reader(self, name: str) -> Optional[SageContainerV2]:
        """Lazy v2 container handle for ``name`` (None for eager sources).

        The sniff verdict is cached both ways: eager (v1/in-memory) sources
        never touch the path again once decided — a v1 file that vanishes
        after its one-time load keeps serving from the ``_files`` cache."""
        with self._lock:
            if name in self._readers:
                return self._readers[name]
            if name in self._not_v2:
                return None
            src = self._sources.get(name)
            if src is None:
                raise KeyError(f"dataset {name!r} not registered; have {self.names()}")
            if isinstance(src, SageFile) or container_version(src) != 2:
                self._not_v2.add(name)
                return None
            r = SageContainerV2.open(src, io_stats=self._io)
            self._readers[name] = r
            return r

    def file(self, name: str) -> SageFile:
        """The dataset as an in-memory SageFile.

        For v2 sources this MATERIALIZES the whole container (compat /
        migration path) — out-of-core consumers use ``meta``/``directory``
        and the ranged read path instead."""
        with self._lock:
            if name not in self._files:
                r = self._reader(name)
                if r is not None:
                    self._files[name] = r.to_sage_file()
                else:
                    src = self._sources[name]
                    if isinstance(src, SageFile):
                        self._files[name] = src
                    else:
                        self._files[name] = SageFile.load(src)
                        self._io["container_loads"] += 1
                        self._io["container_bytes_loaded"] += os.path.getsize(src)
            return self._files[name]

    def meta(self, name: str) -> SageMeta:
        """Dataset meta without materializing the container (header-only
        for v2 sources)."""
        r = self._reader(name)
        return r.meta if r is not None else self.file(name).meta

    def directory(self, name: str) -> np.ndarray:
        """The (n_blocks, NDIR) int64 block directory, header-only for v2."""
        r = self._reader(name)
        return r.directory if r is not None else self.file(name).directory

    def prepared(self, name: str) -> DeviceBlocks:
        """Whole-file device-resident DeviceBlocks for ``name`` (LRU-cached).

        Preparation (host gather) and upload happen once per LRU residency;
        every subsequent read gathers and decodes entirely on device.
        For v2 sources this materializes everything — the ranged hot path
        (``prepared_for``) keeps residency block-granular instead."""
        key = (name, None)
        with self._lock:
            if key in self._prepared:
                self._prepared.move_to_end(key)
                self._bump_cache(name, "hits")
                return self._prepared[key]
            self._bump_cache(name, "misses")
            db = prepare_device_blocks(self.file(name)).to(self.device, self.uploader)
            self._insert_prepared(key, db)
            return db

    def _insert_prepared(self, key: tuple, db: DeviceBlocks) -> None:
        self._prepared[key] = db
        while len(self._prepared) > self.max_prepared:
            evicted, _ = self._prepared.popitem(last=False)
            self._bump_cache(evicted[0], "evictions")

    def _prepared_group(self, name: str, gi: int) -> DeviceBlocks:
        """Device residency for block group ``gi`` of a lazy dataset.

        Miss path: ranged-read the group's extents (through the host extent
        cache), zero-pad the ragged tail group to the uniform stride, and
        upload once. The host cache keeps the
        padded arrays, so a device-evicted group re-uploads without disk.

        Locking: the store lock guards only cache bookkeeping; the actual
        disk gather runs under ``_disk_lock`` (see ``_host_group_raw``) so
        a prefetching reader and a consumer's decode of an already-cached
        group proceed concurrently."""
        key = (name, gi)
        with self._lock:
            self._check_quarantine(name, gi)
            if key in self._prepared:
                self._prepared.move_to_end(key)
                self._bump_cache(name, "hits")
                return self._prepared[key]
            self._bump_cache(name, "misses")
            r = self._require_reader(name, gi)
            stride = self.group_blocks
        if r.codec is not None:
            entry = self._host_group_codec(name, gi, r)
            db, decoded = self._decode_codec_entry(r, stride, entry)
        else:
            arrays = self._host_group_raw(name, gi, r, stride)
            db = DeviceBlocks(
                arrays=arrays,
                caps=r.meta.caps,
                classes=r.meta.classes,
                fixed_len=r.meta.fixed_read_len,
                n_blocks=stride,
            ).to(self.device, self.uploader)
            decoded = 0
        with self._lock:
            # re-check under the lock: a concurrent thread may have uploaded
            # the same group (keep its entry) or quarantined it (discard ours)
            self._check_quarantine(name, gi)
            if key in self._prepared:
                self._prepared.move_to_end(key)
                return self._prepared[key]
            self._io["extent_bytes_decoded"] += decoded
            self._io["group_uploads"] += 1
            self._insert_prepared(key, db)
            return db

    def _check_quarantine(self, name: str, gi: int) -> None:
        """Raise the fail-fast quarantine error for a known-bad group
        (lock held by callers)."""
        if gi in self._quarantine.get(name, ()):
            raise IntegrityError(
                f"dataset {name!r} block group {gi} is quarantined after "
                f"a confirmed integrity failure; re-register a repaired "
                f"container, or lift it with clear_quarantine",
                dataset=name, block_group=gi,
            )

    def _require_reader(self, name: str, gi: int) -> SageContainerV2:
        """The v2 reader for a lazy access already in flight (lock held).

        A ``None`` reader here means the dataset was re-registered onto an
        eager source between the caller's reader check and this lock
        acquisition; the old lazy state is gone — a clear error beats
        serving a mix."""
        r = self._reader(name)
        if r is None:
            raise StaleDatasetError(
                f"dataset {name!r} was re-registered while a lazy read "
                f"was in flight; retry the read",
                dataset=name, block_group=gi,
            )
        return r

    def _host_group_raw(
        self, name: str, gi: int, r: SageContainerV2, stride: int
    ) -> dict:
        """Block group ``gi``'s decoded-layout host arrays, through the host
        extent cache; the disk gather itself runs under ``_disk_lock``."""
        key = (name, gi)
        with self._lock:
            arrays = self._extent_cache.get(key)
        if arrays is not None:
            return arrays
        with self._disk_lock:
            with self._lock:
                arrays = self._extent_cache.get(key, record=False)
                if arrays is not None:
                    return arrays
            lo = gi * self.group_blocks
            hi = min(lo + self.group_blocks, r.meta.n_blocks)
            try:
                arrays = r.gather_block_arrays(
                    np.arange(lo, hi, dtype=np.int64)
                )
            except SageIOError as e:
                # annotate with store-level context, purge every cached
                # form of the group, and (for confirmed corruption)
                # quarantine it so re-access fails fast
                e.dataset = name
                e.block_group = gi
                with self._lock:
                    self._quarantine_group(name, gi, e)
                raise
            if hi - lo < stride:
                pad = stride - (hi - lo)
                arrays = {
                    k: np.concatenate(
                        [v, np.zeros((pad,) + v.shape[1:], dtype=v.dtype)]
                    )
                    for k, v in arrays.items()
                }
            # the gather returns column VIEWS into one stride-aligned read
            # buffer; caching those would pin the whole buffer (alignment
            # pad included) while the budget only counted the payload.
            # Copy each column so cached bytes == accounted bytes.
            arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
            with self._lock:
                self._extent_cache.put(
                    key, arrays, int(sum(v.nbytes for v in arrays.values()))
                )
        return arrays

    def _host_group_codec(self, name: str, gi: int, r: SageContainerV2) -> dict:
        """Codec-container host entry for group ``gi``: the STORED form —
        ragged verified compressed payload words plus (raw) consensus
        windows and localized directory — so the cache budget is spent in
        compressed bytes, matching the disk footprint rather than the
        ~10-40x larger decoded rows. Disk gathers run under ``_disk_lock``."""
        key = (name, gi)
        with self._lock:
            entry = self._extent_cache.get(key)
        if entry is not None:
            return entry
        with self._disk_lock:
            with self._lock:
                entry = self._extent_cache.get(key, record=False)
                if entry is not None:
                    return entry
            lo = gi * self.group_blocks
            hi = min(lo + self.group_blocks, r.meta.n_blocks)
            ids = np.arange(lo, hi, dtype=np.int64)
            try:
                packed = r.gather_packed(ids)
                cons = r.gather_consensus_windows(ids)
            except SageIOError as e:
                e.dataset = name
                e.block_group = gi
                with self._lock:
                    self._quarantine_group(name, gi, e)
                raise
            lens = ((r.extents[ids, 1] + 3) // 4).astype(np.int64)
            keep = np.arange(packed.shape[1])[None, :] < lens[:, None]
            entry = {
                "payload": np.ascontiguousarray(packed[keep]),
                "lens": lens,
                "cons": np.ascontiguousarray(cons),
                "dir": np.ascontiguousarray(localize_directory(r.directory, ids)),
            }
            with self._lock:
                self._extent_cache.put(
                    key, entry, int(sum(v.nbytes for v in entry.values()))
                )
        return entry

    def _decode_codec_entry(
        self, r: SageContainerV2, stride: int, entry: dict
    ) -> tuple[DeviceBlocks, int]:
        """Upload a codec host entry: re-pad the ragged payload to the
        container's uniform ``cap_words``, upload it, and undo the codec on
        the store's device (the unpack kernel on CUDA). Returns the device
        blocks plus the decoded-byte count for the caller to account."""
        lens = entry["lens"]
        n = int(lens.size)
        cap = r._cap_words
        buf = np.zeros((stride, cap), dtype=np.uint32)
        keep = np.arange(cap)[None, :] < lens[:, None]
        buf[:n][keep] = entry["payload"]
        cons = np.zeros((stride,) + entry["cons"].shape[1:], entry["cons"].dtype)
        cons[:n] = entry["cons"]
        dirr = np.zeros((stride,) + entry["dir"].shape[1:], entry["dir"].dtype)
        dirr[:n] = entry["dir"]
        with self._lock:
            dicts = self._device_dicts.get(r)
            if dicts is None:
                (dicts,) = self.uploader(np.asarray(r._codec_dicts, dtype=np.uint8))
                self._device_dicts[r] = dicts
        packed, cons_t, dir_t = self.uploader(buf, cons, dirr)
        arrays = dict(unpack_block_rows(packed, dicts, dict(r.layout.widths)))
        arrays["cons"] = cons_t
        arrays["dir"] = dir_t
        db = DeviceBlocks(
            arrays=arrays,
            caps=r.meta.caps,
            classes=r.meta.classes,
            fixed_len=r.meta.fixed_read_len,
            n_blocks=stride,
            device=self.device,
            uploader=self.uploader,
        )
        return db, n * r.layout.payload_nbytes

    def prefetch_group_host(self, name: str, gi: int) -> bool:
        """Pull block group ``gi``'s bytes disk → host extent cache, no
        device work.

        Reads flow through the same CRC/retry/reconstruction path as
        synchronous access (``SageContainerV2.gather_*`` under
        ``_disk_lock``), so a corrupt group quarantines *here* and the
        consumer's later decode of that fetch surfaces the identical typed
        :class:`SageIOError`. Returns True when host bytes are (now)
        cached; False when there is nothing to prefetch (eager source, or
        the group is already device-resident)."""
        key = (name, gi)
        with self._lock:
            self._check_quarantine(name, gi)
            if key in self._prepared:
                return False
            r = self._reader(name)
            if r is None:
                return False
            stride = self.group_blocks
        if r.codec is not None:
            self._host_group_codec(name, gi, r)
        else:
            self._host_group_raw(name, gi, r, stride)
        return True

    def release_group(self, name: str, gi: int) -> bool:
        """Drop one block group's device residency; the host extent cache
        keeps its bytes, so a re-read is an upload, not a disk seek.

        Deliberate recycling, not pressure — per-dataset eviction counters
        don't move. Returns True when a residency was dropped."""
        with self._lock:
            return self._prepared.pop((name, gi), None) is not None

    def prepared_for(self, name: str, ids) -> tuple[DeviceBlocks, np.ndarray]:
        """Device residency covering ``ids`` + local row indices into it.

        Eager sources return the whole-file residency with ``ids``
        unchanged. Lazy (v2) sources resolve the covering block groups and
        make each device-resident independently (``(name, group)`` LRU
        entries). A single covering group is returned as-is; a multi-group
        request gathers only the REQUESTED rows out of each resident group
        and concatenates those (device-side ops, O(len(ids)) rows copied —
        never whole groups; no host transfer). Only the covering groups'
        extent bytes ever leave disk.

        A concurrent ``register()`` can invalidate the reader this read
        planned against mid-flight; that race is retried ONCE here (the
        retry re-resolves the source, so it lands on the new registration)
        — ``io_stats["stale_retries"]`` counts them — before surfacing
        :class:`StaleDatasetError` to the caller."""
        try:
            return self._prepared_for(name, ids)
        except StaleDatasetError:
            with self._lock:
                self._io["stale_retries"] += 1
            return self._prepared_for(name, ids)

    def _prepared_for(self, name: str, ids) -> tuple[DeviceBlocks, np.ndarray]:
        ids = np.asarray(ids, dtype=np.int64)
        r = self._reader(name)
        if r is None:
            return self.prepared(name), ids
        nb = r.meta.n_blocks
        if ids.size and (ids.min() < 0 or ids.max() >= nb):
            raise IndexError(
                f"block ids out of bounds for dataset {name!r} ({nb} blocks)"
            )
        if ids.size == 0:
            return (
                DeviceBlocks(arrays={}, caps=r.meta.caps, classes=r.meta.classes,
                             fixed_len=r.meta.fixed_read_len, n_blocks=0,
                             device=self.device, uploader=self.uploader),
                ids,
            )
        g = self.group_blocks
        gids = ids // g
        gis = sorted(set(gids.tolist()))
        dbs = {gi: self._prepared_group(name, gi) for gi in gis}
        if len(gis) == 1:
            return dbs[gis[0]], ids % g
        # stable group-sort, gather each group's requested rows once, and
        # invert the permutation — all index math vectorized on host
        sidx = np.argsort(gids, kind="stable")
        sorted_ids, sorted_gids = ids[sidx], gids[sidx]
        rows = self.uploader(*(sorted_ids[sorted_gids == gi] % g for gi in gis))
        parts = [
            {k: v.index_select(0, rw) for k, v in dbs[gi].arrays.items()}
            for gi, rw in zip(gis, rows)
        ]
        arrays = {k: torch.cat([p[k] for p in parts], dim=0) for k in parts[0]}
        local = np.empty(ids.size, dtype=np.int64)
        local[sidx] = np.arange(ids.size, dtype=np.int64)
        first = dbs[gis[0]]
        db = DeviceBlocks(
            arrays=arrays, caps=first.caps, classes=first.classes,
            fixed_len=first.fixed_len, n_blocks=ids.size, device=self.device,
            uploader=self.uploader,
        )
        return db, local

    def n_blocks(self, name: str) -> int:
        return self.meta(name).n_blocks

    def consensus_windows(self, name: str, ids: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
        """Per-block consensus windows as base codes.

        Returns ``(windows, starts)``: windows is (len(ids), caps.window) int8;
        starts is the global consensus coordinate of each window's base 0
        (for localizing the decoder's global ``read_pos``). One batched
        unpack over the prepared ``cons`` rows — the only host transfer is
        the selected rows themselves (and for lazy datasets only the
        covering block groups are ever made resident)."""
        ids = np.asarray(ids, dtype=np.int64)
        nb = self.n_blocks(name)
        if ids.size and (ids.min() < 0 or ids.max() >= nb):
            # device arrays clamp out-of-bounds gathers; keep the host
            # numpy contract of refusing bad block ids
            raise IndexError(
                f"block ids {ids} out of bounds for dataset {name!r} "
                f"({nb} blocks)"
            )
        if ids.size == 0:
            caps = self.meta(name).caps
            return np.zeros((0, caps.window), np.int8), np.zeros((0,), np.int64)
        db, local = self.prepared_for(name, ids)
        idx = torch.as_tensor(local, device=db.device)
        rows = db.arrays["cons"].index_select(0, idx).cpu().numpy().view(np.uint32)
        wins = unpack_2bit_batch(rows, db.caps.window).astype(np.int8)
        starts = db.arrays["dir"][idx, D["cons_start"]].cpu().numpy().astype(np.int64)
        return wins, starts

    def session(
        self,
        *,
        fused: bool = False,
        mesh=None,
        shards: Optional[int] = None,
    ) -> "SageReadSession":
        """Open a read session on the store's device. Decode runs the
        two-step path (the block-decode kernel, then the format kernel), or
        with ``fused=True`` gather, decode and format as one kernel (B5) for
        every format with a registered fuser (bit-identical output; other
        formats take the two-step path). ``mesh``/``shards`` are not ported
        yet and raise."""
        if mesh is not None or shards is not None:
            raise _not_ported("session(mesh=/shards=)", "Queue A, slice 7: multi-GPU")
        return SageReadSession(self, fused=fused)


class SageReadSession:
    """One consumer's view of a store: the paper's command set, decoding on
    the store's device (CUDA kernels on ``cuda``, their plain torch
    versions on ``cpu``); ``fused`` sessions decode and format in one
    kernel."""

    def __init__(self, store: SageStore, *, fused: bool = False) -> None:
        self.store = store
        self.fused = fused

    # ------------------------------------------------------------ SAGe_Write
    def write(self, name: str, read_set, consensus, **kwargs) -> SageFile:
        return self.store.write(name, read_set, consensus, **kwargs)

    # ------------------------------------------------------------- SAGe_Read
    def resolve_blocks(self, name: str, block_range: BlockRange) -> np.ndarray:
        """Normalize a block range to an array of global block ids."""
        nb = self.store.n_blocks(name)
        if block_range is None:
            return np.arange(nb, dtype=np.int64)
        if isinstance(block_range, (int, np.integer)):
            block_range = (int(block_range), int(block_range) + 1)
        if isinstance(block_range, tuple) and len(block_range) == 2:
            lo, hi = int(block_range[0]), int(block_range[1])
            if not (0 <= lo < hi <= nb):
                raise ValueError(
                    f"block range ({lo}, {hi}) out of bounds for dataset {name!r} "
                    f"with {nb} blocks"
                )
            return np.arange(lo, hi, dtype=np.int64)
        ids = np.asarray(list(block_range), dtype=np.int64)
        if ids.size == 0 or ids.min() < 0 or ids.max() >= nb:
            raise ValueError(f"block ids {ids} out of bounds for dataset {name!r} ({nb} blocks)")
        return ids

    def read(
        self,
        name: str,
        block_range: BlockRange = None,
        fmt="2bit",
        *,
        kmer_k: Optional[int] = None,
    ) -> dict[str, torch.Tensor]:
        """SAGe_Read: decode a block range of ``name`` to ``fmt``.

        Returns the block-major decode dict (tokens, read_* metadata,
        n_reads/n_tokens) plus the format's output key and ``block_ids``.

        Hot-path shape: block ids are padded to their power-of-two bucket,
        gathered out of the resident arrays on the device, decoded and
        formatted at the bucket shape; padding lanes are masked through
        decode and sliced off at the end. Out-of-core (v2) datasets make
        only the block groups covering ``block_range`` resident."""
        ids = self.resolve_blocks(name, block_range)
        db, local = self.store.prepared_for(name, ids)
        out = self._decode_prepared(name, db, local, fmt, kmer_k)
        out["block_ids"] = ids
        return out

    def _decode_prepared(
        self, name: str, db: DeviceBlocks, local, fmt, kmer_k: Optional[int]
    ) -> dict[str, torch.Tensor]:
        """Decode + format already-resident blocks: the dispatch half of
        ``read`` (the pipelined stream calls it apart from residency, so
        upload and decode time out as distinct stages).

        ``fused`` sessions run gather+decode+format as one kernel when a
        fuser is registered for ``fmt``; other formats take the two-step
        path."""
        spec = get_format(fmt)
        if self.fused and fused_format_supported(spec.name):
            if spec.requires_k and kmer_k is None:
                # the same contract apply_format enforces on the 2-step path
                raise ValueError(
                    f"SAGe_Read({name!r}): format {spec.name!r} requires kmer_k "
                    f"(registered formats: {available_formats()})"
                )
            return fused_decode_blocks_bucketed(db, local, fmt_name=spec.name, kmer_k=kmer_k)
        return decode_blocks_bucketed(
            db, local,
            postprocess=lambda dec: apply_format(
                dec, fmt, kmer_k=kmer_k, context=f"SAGe_Read({name!r})",
            ),
        )

    # -------------------------------------------------------------- SAGe_ISP
    def read_stream(
        self,
        name: str,
        consumer: Optional[Callable[[StreamBatch], object]] = None,
        *,
        fmt="2bit",
        kmer_k: Optional[int] = None,
        start_block: int = 0,
        blocks_per_fetch: int = 4,
        prefetch: int = 2,
        wrap: bool = False,
        max_fetches: Optional[int] = None,
        dispatch: Optional[int] = None,
        mode: Optional[str] = None,
        readahead: int = 2,
    ):
        """SAGe_ISP: stream decoded block groups into an analysis consumer.

        With ``consumer`` set, drives the stream to completion and returns
        the list of consumer results; with ``consumer=None`` returns the
        :class:`StreamBatch` iterator for pull-based consumers.

        Modes: ``"sync"`` decodes on demand; ``"prefetch"`` decodes up to
        ``prefetch`` groups ahead on a worker thread; ``"dispatch"`` (or
        ``dispatch=N``) enqueues exactly N groups' kernels ahead on the
        device stream before yielding the first — the device decodes group
        i+k while the consumer holds group i, with no host synchronization.
        ``"pipelined"`` runs the disk→host→device→decode pipeline
        (:class:`repro_torch.core.streaming.PipelinedStream`): a background
        I/O thread ranged-reads fetch i+2's extents into the host cache
        while fetch i+1 uploads and fetch i decodes — dispatch depth
        ``dispatch`` (default 2), I/O readahead ``readahead`` fetches beyond
        that, double-buffered device slots, per-stage wall time and
        ``overlap_fraction`` folded into ``store.io_stats``. ``None`` infers
        from ``dispatch``/``prefetch``. ``wrap=True`` cycles block groups
        forever (epoch increments at each wraparound)."""
        nb = self.store.n_blocks(name)  # validate eagerly, not at first next()
        if not (0 <= start_block < nb):
            raise ValueError(f"start_block {start_block} out of bounds (0..{nb - 1})")
        if blocks_per_fetch < 1:
            raise ValueError(f"blocks_per_fetch must be >= 1, got {blocks_per_fetch}")
        if dispatch is not None and dispatch < 0:
            raise ValueError(f"dispatch depth must be >= 0, got {dispatch}")
        if mode not in (None, "sync", "prefetch", "dispatch", "pipelined"):
            raise ValueError(
                f"mode must be one of 'sync', 'prefetch', 'dispatch', "
                f"'pipelined' (or None to infer), got {mode!r}"
            )
        if readahead < 0:
            raise ValueError(f"readahead must be >= 0, got {readahead}")
        get_format(fmt)
        if mode == "pipelined":
            from repro_torch.core.streaming import PipelinedStream

            it = PipelinedStream(
                self, name, fmt=fmt, kmer_k=kmer_k, start_block=start_block,
                blocks_per_fetch=blocks_per_fetch, wrap=wrap,
                max_fetches=max_fetches,
                dispatch=max(1, dispatch if dispatch is not None else 2),
                readahead=readahead,
            )
        else:
            if mode == "sync":
                prefetch, dispatch = 0, None
            elif mode == "prefetch":
                prefetch = max(1, prefetch)
                dispatch = None
            elif mode == "dispatch" and dispatch is None:
                dispatch = 2
            it = self._stream_iter(
                name, fmt=fmt, kmer_k=kmer_k, start_block=start_block,
                blocks_per_fetch=blocks_per_fetch, prefetch=prefetch,
                wrap=wrap, max_fetches=max_fetches, dispatch=dispatch,
            )
        if consumer is None:
            return it
        if wrap and max_fetches is None:
            raise ValueError("read_stream(consumer=..., wrap=True) needs max_fetches")
        if mode == "pipelined":
            with it:
                return [consumer(batch) for batch in it]
        return [consumer(batch) for batch in it]

    def _group_ids(
        self, nb: int, start_block: int, blocks_per_fetch: int, wrap: bool,
        max_fetches: Optional[int],
    ) -> Iterator[tuple[int, np.ndarray, int, int]]:
        """Yield (epoch, block id group, next_block, next_epoch) in stream
        order — the single source of truth for cyclic-advance bookkeeping
        (bounds are validated eagerly in ``read_stream``)."""
        b, epoch, fetches = start_block, 0, 0
        while True:
            if max_fetches is not None and fetches >= max_fetches:
                return
            if wrap:
                ids = (b + np.arange(blocks_per_fetch, dtype=np.int64)) % nb
                nxt_epoch = epoch + (1 if b + blocks_per_fetch >= nb else 0)
                nxt_b = (b + blocks_per_fetch) % nb
                yield epoch, ids, nxt_b, nxt_epoch
                b, epoch = nxt_b, nxt_epoch
            else:
                if b >= nb:
                    return
                ids = np.arange(b, min(b + blocks_per_fetch, nb), dtype=np.int64)
                yield 0, ids, min(b + blocks_per_fetch, nb), 0
                b += blocks_per_fetch
            fetches += 1

    def _stream_iter(
        self, name: str, *, fmt, kmer_k, start_block, blocks_per_fetch,
        prefetch, wrap, max_fetches, dispatch=None,
    ) -> Iterator[StreamBatch]:
        nb = self.store.n_blocks(name)
        groups = self._group_ids(nb, start_block, blocks_per_fetch, wrap, max_fetches)

        def produce(epoch: int, ids: np.ndarray, nxt_b: int, nxt_epoch: int) -> StreamBatch:
            data = self.read(name, ids, fmt, kmer_k=kmer_k)
            return StreamBatch(name=name, epoch=epoch, block_ids=ids, data=data,
                               next_block=nxt_b, next_epoch=nxt_epoch)

        if dispatch is not None:
            # thread-free async pipelining: produce() only *enqueues* the
            # kernels on the device stream (tensors come back before the
            # device finishes), so running up to `dispatch` groups ahead
            # overlaps device decode with the consumer without a worker
            # thread.
            # Yield BEFORE dispatching once the window is full, so exactly
            # `dispatch` groups are ever in flight (dispatch=0 degenerates
            # to the synchronous path: dispatch, then yield immediately).
            pending: "deque[StreamBatch]" = deque()
            for g in groups:
                if pending and len(pending) >= dispatch:
                    yield pending.popleft()
                pending.append(produce(*g))
            while pending:
                yield pending.popleft()
            return

        if prefetch <= 0:  # synchronous: decode on demand, fully deterministic
            for g in groups:
                yield produce(*g)
            return

        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()
        done = object()

        def worker() -> None:
            try:
                for g in groups:
                    item: object = produce(*g)
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
                item = done
            except Exception as e:  # propagated to the consumer thread
                item = e
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
