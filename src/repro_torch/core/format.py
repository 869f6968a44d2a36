"""SAGe container format.

Layout (TPU adaptation of the paper's §5.1/§5.2.1/§5.4 co-design):

* All encoded information lives in 14 flat little-endian bitstreams
  (uint32-word packed). Stream placement differs from the paper's single
  interleaved MBTA, but the *bit cost is identical* (see DESIGN.md §2) — we
  re-home variable tails into separate streams so every field's offset is a
  prefix sum, which is what makes the decode data-parallel on a TPU.
* Reads are grouped into fixed-capacity BLOCKS (the analogue of the per-NAND-
  channel partitions): each block's slice of every stream is independently
  decodable given the 26-field directory row. Blocks are the unit of Pallas
  grid parallelism, device sharding, and checkpoint/restart cursors.
* The consensus is stored once, 2-bit packed; each block references a
  16-base-aligned window [cons_start, cons_start + cons_span).

Streams
-------
  mapg/mapa  match-position deltas (guide + values)      1 entry / segment
  leng/lena  segment lengths (guide + values; absent when fixed length)
  cntg/cnta  mismatch counts (guide + values)            1 entry / segment
  mpg/mpa    mismatch read-coordinate deltas             1 entry / mismatch
  mbb        2-bit base-or-indel-signal                  1 entry / mismatch
  idg        2-bit [type, multi] flags                   1 entry / indel
  idl        8-bit block length                          1 entry / multi-indel
  ibs        2-bit inserted bases                        L entries / insertion
  rfl        3-bit [rev, cont, corner] segment flags     1 entry / segment
  esc        3-bit escaped bases (corner reads)          L entries / corner read
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

STREAMS = (
    "mapg", "mapa", "leng", "lena", "cntg", "cnta",
    "mpg", "mpa", "mbb", "idg", "idl", "ibs", "rfl", "esc",
)
S = {name: i for i, name in enumerate(STREAMS)}

# directory fields (one int64 row per block)
DIR_FIELDS = (
    "n_segs", "n_reads", "n_mism", "n_indel", "n_multi", "n_insb",
    "n_corner", "n_escb", "n_tokens", "cons_start", "cons_span", "base_pos",
) + tuple(f"off_{s}" for s in STREAMS)
D = {name: i for i, name in enumerate(DIR_FIELDS)}
NDIR = len(DIR_FIELDS)

GUIDE_KINDS = ("map", "len", "cnt", "mp")  # streams with adaptive width classes


@dataclasses.dataclass
class BlockCaps:
    """Per-block capacities (fixed shapes for the JAX/Pallas decoders)."""

    segs: int  # max segments
    mism: int  # max mismatch records
    indel: int  # max indel records
    multi: int  # max multi-base indel records
    insb: int  # max inserted bases
    escb: int  # max escaped bases
    tokens: int  # max decoded bases
    window: int  # consensus window (bases, multiple of 16)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "BlockCaps":
        return cls(**d)


@dataclasses.dataclass
class SageMeta:
    version: int
    read_kind: str  # "short" | "long"
    n_reads: int
    n_segments: int
    n_blocks: int
    fixed_read_len: int  # 0 => variable (leng/lena streams present)
    cons_len: int
    caps: BlockCaps
    classes: dict[str, tuple[int, ...]]  # kind -> width per guide class
    stream_bits: dict[str, int]

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["caps"] = self.caps.to_json()
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "SageMeta":
        d = json.loads(s)
        d["caps"] = BlockCaps.from_json(d["caps"])
        d["classes"] = {k: tuple(v) for k, v in d["classes"].items()}
        return cls(**d)


@dataclasses.dataclass
class SageFile:
    meta: SageMeta
    consensus2b: np.ndarray  # uint32, 16 bases/word
    directory: np.ndarray  # int64 (n_blocks, NDIR)
    streams: dict[str, np.ndarray]  # uint32 words per stream

    def diff(self, other: "SageFile") -> list[str]:
        """Names of container sections that differ from ``other`` (empty =
        bit-identical). The single comparator behind the encoder parity
        tests and the encode benchmark's CI gate."""
        probs = []
        if self.meta.to_json() != other.meta.to_json():
            probs.append("meta")
        if not np.array_equal(self.directory, other.directory):
            probs.append("directory")
        if not np.array_equal(self.consensus2b, other.consensus2b):
            probs.append("consensus")
        probs += [
            f"stream:{s}" for s in STREAMS
            if not np.array_equal(self.streams[s], other.streams[s])
        ]
        return probs

    def compressed_bytes(self, include_consensus: bool = True) -> int:
        n = sum(int(v.nbytes) for v in self.streams.values())
        n += int(self.directory.nbytes)
        n += len(self.meta.to_json())
        if include_consensus:
            n += int(self.consensus2b.nbytes)
        return n

    def save(self, path: str | Path) -> None:
        """Serialize to ``.npz``. Absent streams are genuinely omitted from the
        archive: fixed-read-length files carry no ``leng``/``lena`` entries
        (see the stream table above), matching what :meth:`load` tolerates."""
        path = Path(path)
        np.savez_compressed(
            path,
            meta=np.frombuffer(self.meta.to_json().encode(), dtype=np.uint8),
            consensus2b=self.consensus2b,
            directory=self.directory,
            **{f"s_{k}": v for k, v in self.streams.items() if v.size > 0},
        )

    @classmethod
    def load(cls, path: str | Path) -> "SageFile":
        """Load a v1 container; streams missing from the archive (e.g.
        ``leng``/``lena`` for fixed-read-length files) come back as empty
        arrays, which every decoder treats as "no entries". The archive
        handle is closed before returning (every array is materialized
        inside the context), so loading many files never accumulates open
        descriptors."""
        with np.load(path) as z:
            meta = SageMeta.from_json(bytes(z["meta"]).decode())
            empty = np.zeros(0, dtype=np.uint32)
            streams = {k: (z[f"s_{k}"] if f"s_{k}" in z.files else empty) for k in STREAMS}
            return cls(meta=meta, consensus2b=z["consensus2b"], directory=z["directory"], streams=streams)

    @classmethod
    def open(cls, path: str | Path):
        """Open a container of either on-disk version.

        v2 block-extent paths return the lazy header-only
        :class:`repro_torch.core.layout.SageContainerV2` handle (ranged block I/O
        via ``gather_block_arrays``); v1 ``.npz`` paths fall back to the
        eager whole-file :meth:`load`."""
        from repro_torch.core.layout import open_container  # local: layout imports us

        return open_container(path)
