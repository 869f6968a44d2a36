"""SAGe block-extent container **v2**: the out-of-core on-disk layout.

The v1 container (``SageFile.save``, a monolithic ``np.savez_compressed``
archive) forces every ranged read to decompress the *entire* dataset into
host RAM — the data-preparation bottleneck the paper attacks, reintroduced
one layer down. v2 is the software analogue of the paper's per-NAND-channel
block partitions (§5.1/§5.4): each block's slice of all 14 streams plus its
consensus window is one contiguous, alignment-padded **extent**, and a small
header carries everything needed to plan a read, so opening a dataset costs
O(header) and reading k blocks costs O(k) extent bytes.

On-disk layout (all integers little-endian)::

    offset 0   magic        b"SAGE2EXT"                              8 B
           8   json_len     uint64                                   8 B
          16   header json  meta + align + extent column widths      json_len B
           +   directory    int64 (n_blocks, NDIR) raw               nb*NDIR*8 B
           +   extent table int64 (n_blocks, 2) = (offset, nbytes)   nb*2*8 B
           +   zero pad up to `align`
    ---------------- extents (one per block, stride-aligned) ----------------
          Ei   block i:  [mapg|mapa|...|esc|cons] uint32 rows, then pad
         E{i+1} = Ei + stride,   stride = align_up(payload_nbytes, align)

Each extent row is byte-identical to the corresponding row of
:func:`repro_torch.core.blocks.prepare_block_arrays` — a gathered group of
extents *is* the decoder's block-major layout, so lazy ranged I/O feeds the
device decoders with zero host re-packing, and v2 decode output is
bit-identical to the v1 whole-file path by construction. The directory stays
in the header (it is the read *planner*); the per-block ``dir`` rows handed
to the decoder are derived from it on gather.

``SageContainerV2.gather_block_arrays`` coalesces each run of adjacent
extents into one ranged ``seek``/``read`` (the streaming-access pattern of
§5.4) and counts every byte in ``io_stats`` so callers can assert read
amplification. ``HostExtentCache`` is the byte-budget host cache the
:class:`repro_torch.core.store.SageStore` puts between disk and device residency.

**Integrity (PR 7).** New containers carry end-to-end checksums: a CRC32C
per extent payload (its own header section), CRCs of the directory, extent
table, and consensus section in the header json, and a self-checksummed
commit footer at end-of-file binding a CRC of the whole header region —
so a flipped bit anywhere is *detected* (``IntegrityError``) instead of
silently decoded, and a torn write can never present as a valid container
(``TornWriteError`` on a missing/invalid footer). ``write_v2`` is atomic:
tmp file + fsync + rename, so a crashed writer leaves either the old
container or nothing. Ranged reads retry transient failures (EIO, short
reads) under a bounded exponential-backoff :class:`RetryPolicy`; a
checksum mismatch earns exactly one re-read before raising. Containers
written before this revision have no checksum section — they still open
and serve bit-identically, with verification skipped
(``container_version(path, detail=True)`` reports the capability).

**Self-healing (PR 8).** ``write_v2(parity=...)`` appends a parity section
after the data extents: every ``parity_group`` adjacent extents form a
parity group protected by one XOR shard (``parity="xor"``) or ``m``
Reed-Solomon-style shards over GF(256) (``parity="rs"``, see
:mod:`repro_torch.core.parity`). Parity shards are stride-aligned extents with
their own CRC32C array (appended to the checksum section, so the commit
footer binds them too). On a persistent extent checksum mismatch the
reader RECONSTRUCTS the damaged payload from the group's survivors +
parity, re-verifies the rebuilt bytes against the stored extent CRC, and
serves them (``io_stats["reconstructions"]``) — only damage exceeding the
group's parity budget still raises ``IntegrityError``
(``reconstruction_failures``). :meth:`SageContainerV2.rewrite_extents`
patches repaired extents back to disk atomically so
``SageStore.repair`` can make the healing durable. Parity is opt-in:
containers written without it are bit-identical to pre-PR-8 output.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
import zlib
from collections import OrderedDict
from pathlib import Path
from typing import Optional

import numpy as np

from repro_torch.core import codec as sagecodec
from repro_torch.core.blocks import (
    block_row_widths,
    localize_directory,
    prepare_block_arrays,
)
from repro_torch.core.errors import (
    DEFAULT_RETRY,
    IntegrityError,
    RetryPolicy,
    SageIOError,
    TornWriteError,
    TransientIOError,
)
from repro_torch.core.format import D, NDIR, STREAMS, SageFile, SageMeta
from repro_torch.core.parity import (
    MAX_GROUP,
    encode_parity,
    n_shards,
    recover_erasures,
)

MAGIC = b"SAGE2EXT"
FOOTER_MAGIC = b"SAGE2FIN"
FOOTER_NBYTES = 24  # magic(8) + body_nbytes u64 + header_crc u32 + self_crc u32
DEFAULT_ALIGN = 4096  # NAND-page-sized extent alignment (legacy raw extents)
CODEC_ALIGN = 64  # default slot alignment for compressed (codec) extents
_FIXED = len(MAGIC) + 8  # magic + uint64 json length

#: column order of the per-block extent payload (uint32 words)
EXTENT_KEYS = STREAMS + ("cons",)


def align_up(n: int, a: int) -> int:
    return -(-n // a) * a


def _open_read(path):
    """Every read-side file open of this module routes through here — the
    single seam ``repro.testing.faults`` patches to inject truncation,
    bit-flips, EIO, and slow reads without touching production code."""
    return open(path, "rb")


# --------------------------------------------------------------------------
# CRC32C (Castagnoli) — the checksum of the integrity format
# --------------------------------------------------------------------------

def _crc32c_table() -> list[int]:
    poly, table = 0x82F63B78, []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (poly if c & 1 else 0)
        table.append(c)
    return table


_PY_TABLE: Optional[list[int]] = None


def _crc32c_py(data) -> int:
    """Pure-python CRC32C — the dependency-free fallback (bit-identical to
    the C extension; crc32c(b"123456789") == 0xE3069283)."""
    global _PY_TABLE
    if _PY_TABLE is None:
        _PY_TABLE = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in bytes(data):
        crc = (crc >> 8) ^ _PY_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


try:  # google-crc32c is a C extension; fall back to the table implementation
    from google_crc32c import value as _crc32c_c

    def crc32c(data) -> int:
        """CRC32C of a bytes-like (numpy arrays pass their buffer)."""
        return int(_crc32c_c(bytes(memoryview(data).cast("B"))))

    def crc32c_many(bufs) -> list[int]:
        """CRC32C of each buffer of ``bufs``."""
        return [crc32c(b) for b in bufs]

except ImportError:  # pragma: no cover - exercised only without the extension
    def crc32c(data) -> int:
        """CRC32C of a bytes-like (pure-python fallback)."""
        return _crc32c_py(memoryview(data).cast("B"))

    def crc32c_many(bufs) -> list[int]:
        """CRC32C of each buffer of ``bufs``; without the C extension many
        buffers step through the table in lockstep (numpy), one byte
        position at a time, which is what makes container-sized writes and
        verifies affordable."""
        if len(bufs) < 32:  # lockstep pays once enough buffers share each step
            return [crc32c(b) for b in bufs]
        return [int(c) for c in _crc32c_lockstep(bufs)]


def _crc32c_lockstep(bufs) -> np.ndarray:
    """CRC32C of many buffers at once. Buffers are right-aligned in a
    (max_len, n) byte matrix; a buffer's register stays at the initial
    value until its first byte comes up, so every length is exact."""
    rows = [np.frombuffer(memoryview(b).cast("B"), np.uint8) for b in bufs]
    lens = np.array([r.size for r in rows], dtype=np.int64)
    L = int(lens.max())
    mat = np.zeros((L, len(rows)), np.uint8)
    for i, r in enumerate(rows):
        mat[L - r.size:, i] = r
    start = L - lens
    uniform = bool((start == 0).all())
    tab = np.asarray(_crc32c_table(), dtype=np.uint32)
    regs = np.full(len(rows), 0xFFFFFFFF, dtype=np.uint32)
    for j in range(L):
        upd = (regs >> np.uint32(8)) ^ tab[(regs ^ mat[j]) & np.uint32(0xFF)]
        regs = upd if uniform else np.where(start <= j, upd, regs)
    return regs ^ np.uint32(0xFFFFFFFF)


@dataclasses.dataclass(frozen=True)
class ExtentLayout:
    """Column layout of one block extent: per-key uint32 word widths in
    :data:`EXTENT_KEYS` order (persisted in the header, so readers never
    have to re-derive it from the meta)."""

    widths: tuple[tuple[str, int], ...]
    align: int

    @classmethod
    def from_meta(cls, meta: SageMeta, align: int = DEFAULT_ALIGN) -> "ExtentLayout":
        w = block_row_widths(meta)
        return cls(widths=tuple((k, int(w[k])) for k in EXTENT_KEYS), align=int(align))

    @property
    def payload_words(self) -> int:
        return sum(w for _, w in self.widths)

    @property
    def payload_nbytes(self) -> int:
        return 4 * self.payload_words

    @property
    def stride_nbytes(self) -> int:
        return align_up(self.payload_nbytes, self.align)

    def column_offsets(self) -> dict[str, int]:
        """Word offset of each key's column in the extent payload."""
        offs, col = {}, 0
        for k, w in self.widths:
            offs[k] = col
            col += w
        return offs


def new_io_stats() -> dict[str, int]:
    """Zeroed I/O counter set shared by v2 readers (and aggregated per
    store) — mirrors the pipeline's ``transfer_stats`` contract."""
    return {
        "opens": 0,
        "header_bytes": 0,
        "extent_reads": 0,  # ranged reads issued (coalesced runs)
        "extent_bytes_read": 0,
        "consensus_bytes_read": 0,
        "blocks_fetched": 0,
        "container_loads": 0,  # v1 whole-file materializations
        "container_bytes_loaded": 0,
        # integrity + fault tolerance (PR 7)
        "read_retries": 0,  # transient-failure retries that were attempted
        "read_failures": 0,  # ranged reads that exhausted the retry policy
        "checksum_retries": 0,  # mismatch -> one re-read attempts
        "checksum_failures": 0,  # mismatches that survived the re-read
        "blocks_verified": 0,  # extent payloads whose CRC was checked
        # per-extent codec (PR 9): stored (compressed) vs decoded bytes
        "extent_bytes_stored": 0,  # compressed payload bytes of gathered blocks
        "extent_bytes_decoded": 0,  # block-major decoder bytes produced
        # self-healing (PR 8)
        "parity_reads": 0,  # parity shard reads issued
        "parity_bytes_read": 0,
        "reconstructions": 0,  # damaged extents rebuilt from parity
        "reconstruction_failures": 0,  # damage exceeding the parity budget
    }


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------

def write_v2(
    sf: SageFile,
    path: str | Path,
    *,
    align: Optional[int] = None,
    chunk_blocks: int = 1024,
    integrity: bool = True,
    parity: Optional[str] = None,
    parity_group: int = 16,
    parity_shards: int = 2,
    codec: bool = True,
) -> dict:
    """Serialize ``sf`` as a v2 block-extent container; returns size stats.

    Extents are produced ``chunk_blocks`` at a time through
    :func:`prepare_block_arrays`, so writing never materializes more than a
    chunk of block-major rows regardless of dataset size.

    The write is ATOMIC: everything lands in ``<path>.tmp.<pid>``, is
    fsynced, and only then renamed over ``path`` — a crashed writer leaves
    the previous container (or nothing) intact, never a half-valid file.

    ``codec=True`` (default, PR 9) stores every extent COMPRESSED with the
    per-extent codec of :mod:`repro_torch.core.codec` (word truncation + nibble
    dictionaries), drops the consensus-window copy from each extent
    (windows are ranged-read from the shared consensus section against
    per-window CRCs), encodes the directory/extent tables as compact
    binary delta streams instead of raw int64 sections, packs extents into
    payload-sized slots at a small alignment (:data:`CODEC_ALIGN` unless
    ``align`` is given), and — when parity is off — dedups bit-identical
    payloads into shared extents. ``codec=False`` writes the legacy raw
    stride-aligned layout bit-identically to pre-PR-9 output.

    ``integrity=True`` (default) adds the checksum layer: a CRC32C per
    extent payload (the checksum section after the extent table), CRCs of
    the directory/extent-table/consensus in the header json, and the
    end-of-file commit footer binding a CRC of the whole header region.
    CRCs always cover the STORED (compressed) bytes — readers verify, then
    decode. ``integrity=False`` writes a checksum-free layout — kept for
    compatibility tests and for readers that predate the format.

    ``parity`` (opt-in) appends the self-healing section: ``"xor"`` adds
    one parity shard per ``parity_group`` adjacent extents, ``"rs"`` adds
    ``parity_shards`` GF(256) shards (tolerating that many damaged extents
    per group). Parity requires the integrity layer — the shards are only
    usable when corruption is detectable. With the codec, parity is
    computed over the stored compressed bytes (each group's members
    zero-padded to the group's longest payload), so reconstruction and
    :meth:`SageContainerV2.rewrite_extents` work unchanged."""
    if align is None:
        align = CODEC_ALIGN if codec else DEFAULT_ALIGN
    if align < 4 or align % 4:
        raise ValueError(f"align must be a positive multiple of 4, got {align}")
    m_par = 0
    if parity is not None:
        if not integrity:
            raise ValueError(
                "parity requires integrity=True (reconstruction needs the "
                "per-extent checksums to locate erasures)"
            )
        if not (1 <= parity_group <= MAX_GROUP):
            raise ValueError(
                f"parity_group must be in [1, {MAX_GROUP}], got {parity_group}"
            )
        m_par = n_shards(parity, parity_shards)  # validates the scheme too
        # parity groups must never straddle a write chunk
        chunk_blocks = align_up(max(chunk_blocks, parity_group), parity_group)
    writer = _write_v2_codec if codec else _write_v2_legacy
    return writer(
        sf, Path(path), align=align, chunk_blocks=chunk_blocks,
        integrity=integrity, parity=parity, parity_group=parity_group,
        m_par=m_par,
    )


def _write_v2_legacy(
    sf: SageFile,
    path: Path,
    *,
    align: int,
    chunk_blocks: int,
    integrity: bool,
    parity: Optional[str],
    parity_group: int,
    m_par: int,
) -> dict:
    """The raw (uncompressed) stride-aligned extent layout — bit-identical
    to pre-codec ``write_v2`` output, kept for old readers and as the
    bit-identity baseline in tests."""
    layout = ExtentLayout.from_meta(sf.meta, align)
    nb = sf.meta.n_blocks
    stride = layout.stride_nbytes
    cons = np.ascontiguousarray(sf.consensus2b, dtype=np.uint32)
    directory = np.ascontiguousarray(sf.directory, dtype=np.int64)
    header = {
        "meta": json.loads(sf.meta.to_json()),
        "align": layout.align,
        "widths": list(layout.widths),
        "payload_nbytes": layout.payload_nbytes,
        "stride_nbytes": stride,
        "n_blocks": nb,
        # the full 2-bit consensus lives in its own section: block extents
        # carry their decode windows, so ranged reads never touch it; only
        # whole-file materialization (to_sage_file) reads it back
        "cons_nbytes": int(cons.nbytes),
    }
    n_groups = -(-nb // parity_group) if parity is not None else 0
    n_par = n_groups * m_par if parity is not None else 0
    crc_nbytes = (nb + n_par) * 4 if integrity else 0
    extents = np.empty((nb, 2), dtype=np.int64)
    if integrity:
        header["integrity"] = {
            "algo": "crc32c",
            "dir_crc": crc32c(directory),
            "cons_crc": crc32c(cons),
            # extents_crc is appended below once offsets are known
            "extent_crc_section": True,
            "footer": True,
        }
    if parity is not None:
        header["parity"] = {
            "scheme": parity,
            "group_blocks": parity_group,
            "shards": m_par,
            "n_groups": n_groups,
        }

    def finish_header() -> tuple[bytes, int, int, int]:
        hjson = json.dumps(header).encode()
        header_nbytes = _FIXED + len(hjson) + nb * NDIR * 8 + nb * 2 * 8 + crc_nbytes
        cons_offset = align_up(header_nbytes, align)
        data_start = align_up(cons_offset + cons.nbytes, align)
        return hjson, header_nbytes, cons_offset, data_start

    hjson, header_nbytes, cons_offset, data_start = finish_header()
    extents[:, 0] = data_start + stride * np.arange(nb, dtype=np.int64)
    extents[:, 1] = layout.payload_nbytes
    if integrity:
        header["integrity"]["extents_crc"] = crc32c(extents)
        # adding the crc may change json length -> recompute until stable
        # (extent offsets depend on header size; one extra pass suffices
        # unless the length change crosses an alignment boundary)
        for _ in range(8):
            hjson, header_nbytes, cons_offset, new_start = finish_header()
            if new_start == data_start:
                break
            data_start = new_start
            extents[:, 0] = data_start + stride * np.arange(nb, dtype=np.int64)
            header["integrity"]["extents_crc"] = crc32c(extents)
        else:  # pragma: no cover - needs a pathological align/json interaction
            raise RuntimeError("write_v2: header layout failed to converge")
    offsets = layout.column_offsets()
    pw = layout.payload_words
    extent_crcs = np.zeros(nb, dtype=np.uint32)
    parity_crcs = np.zeros(n_par, dtype=np.uint32)
    # parity shards accumulate here (one stride-sized row each) and land
    # after the last data extent; groups never span chunks, so each chunk
    # fully determines its groups' shards
    parity_buf = np.zeros((n_par, stride), dtype=np.uint8)
    crc_section_at = _FIXED + len(hjson) + nb * NDIR * 8 + nb * 2 * 8
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    try:
        with open(tmp, "w+b") as f:  # + so the footer can CRC the header back
            f.write(MAGIC)
            f.write(np.uint64(len(hjson)).tobytes())
            f.write(hjson)
            f.write(directory.tobytes())
            f.write(extents.tobytes())
            if integrity:
                f.write(extent_crcs.tobytes())  # placeholder, patched below
                if parity is not None:
                    f.write(parity_crcs.tobytes())  # placeholder too
            f.write(b"\0" * (cons_offset - f.tell()))
            f.write(cons.tobytes())
            f.write(b"\0" * (data_start - f.tell()))
            for lo in range(0, nb, chunk_blocks):
                ids = np.arange(lo, min(lo + chunk_blocks, nb), dtype=np.int64)
                rows = prepare_block_arrays(sf, ids)
                buf = np.zeros((ids.size, stride // 4), dtype=np.uint32)
                for k, w in layout.widths:
                    buf[:, offsets[k] : offsets[k] + w] = rows[k]
                if integrity:
                    for bi in range(ids.size):
                        extent_crcs[lo + bi] = crc32c(buf[bi, :pw])
                if parity is not None:
                    for g0 in range(lo, lo + ids.size, parity_group):
                        g = g0 // parity_group
                        sl = slice(g0 - lo, min(g0 - lo + parity_group, ids.size))
                        data = np.ascontiguousarray(buf[sl, :pw]).view(np.uint8)
                        shards = encode_parity(data, m_par)
                        for j in range(m_par):
                            parity_buf[g * m_par + j, : 4 * pw] = shards[j]
                            parity_crcs[g * m_par + j] = crc32c(shards[j])
                f.write(buf.tobytes())
            if parity is not None:
                f.write(parity_buf.tobytes())  # data end is aligned: no gap
            file_nbytes = f.tell()
            if integrity:
                f.seek(crc_section_at)
                f.write(extent_crcs.tobytes())
                if parity is not None:
                    f.write(parity_crcs.tobytes())
                f.seek(0)
                header_crc = crc32c(f.read(header_nbytes))
                f.seek(file_nbytes)
                footer = (
                    FOOTER_MAGIC
                    + np.uint64(file_nbytes).tobytes()
                    + np.uint32(header_crc).tobytes()
                )
                f.write(footer + np.uint32(crc32c(footer)).tobytes())
                file_nbytes += FOOTER_NBYTES
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic publish
        try:  # persist the rename itself (best effort on exotic filesystems)
            dfd = os.open(path.parent, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    return {
        "n_blocks": nb,
        "payload_nbytes": layout.payload_nbytes,
        "stride_nbytes": stride,
        "header_nbytes": header_nbytes,
        "header_json_nbytes": len(hjson),
        "dir_enc_nbytes": nb * NDIR * 8,
        "ext_enc_nbytes": nb * 2 * 8,
        "cons_nbytes": int(cons.nbytes),
        "data_start": data_start,
        "file_nbytes": file_nbytes,
        "align": align,
        "integrity": integrity,
        "checksum_nbytes": crc_nbytes,
        "cons_win_crc_nbytes": 0,
        "footer_nbytes": FOOTER_NBYTES if integrity else 0,
        "parity": parity,
        "parity_group": parity_group if parity is not None else 0,
        "parity_shards": m_par if parity is not None else 0,
        "parity_nbytes": n_par * stride,
        "parity_overhead": (n_par * stride / (nb * stride)) if nb and parity else 0.0,
        "codec": False,
        "codec_version": 0,
        "stored_payload_nbytes": nb * layout.payload_nbytes,
        "dedup_blocks": 0,
    }


def _cons_window_rows(cons: np.ndarray, w0, width: int) -> np.ndarray:
    """(n, width) uint32 consensus windows at word offsets ``w0``, zero-
    filled past the section end — the exact gather semantics of
    :func:`repro_torch.core.blocks.prepare_block_arrays`, so writer-side
    window CRCs and reader-side window gathers agree bit-for-bit."""
    w0 = np.asarray(w0, dtype=np.int64)
    if cons.size == 0:
        return np.zeros((w0.size, width), dtype=np.uint32)
    idx = w0[:, None] + np.arange(width, dtype=np.int64)[None, :]
    valid = (idx >= 0) & (idx < cons.size)
    return np.where(
        valid, cons[np.clip(idx, 0, cons.size - 1)], np.uint32(0)
    ).astype(np.uint32)


def _write_v2_codec(
    sf: SageFile,
    path: Path,
    *,
    align: int,
    chunk_blocks: int,
    integrity: bool,
    parity: Optional[str],
    parity_group: int,
    m_par: int,
) -> dict:
    """Compressed-extent v2 writer (PR 9) — payload format in
    :mod:`repro_torch.core.codec`. Same atomic-commit and bounded-memory
    contract as the legacy writer, but TWO chunked encode passes: pass 1
    computes every stored payload's size, CRC, and dedup identity (so
    extent offsets are final before any data byte lands); pass 2 re-encodes
    and writes the unique payloads plus parity over the stored bytes."""
    layout = ExtentLayout.from_meta(sf.meta, align)
    nb = sf.meta.n_blocks
    cons = np.ascontiguousarray(sf.consensus2b, dtype=np.uint32)
    directory = np.ascontiguousarray(sf.directory, dtype=np.int64)
    widths = dict(layout.widths)
    dicts = sagecodec.build_stream_dicts(sf.streams)
    luts = sagecodec.nibble_luts(dicts)
    used = sagecodec.used_words(directory, sf.meta.stream_bits, widths)
    n_groups = -(-nb // parity_group) if parity is not None else 0
    n_par = n_groups * m_par
    # dedup'd (shared) extents would alias members of different parity
    # groups, so content dedup is only applied when parity is off
    dedup = parity is None

    def encode_chunk(lo: int, hi: int):
        ids = np.arange(lo, hi, dtype=np.int64)
        rows = prepare_block_arrays(sf, ids)
        return sagecodec.encode_blocks(rows, used[lo:hi], luts)

    # ---- pass 1: stored sizes, extent CRCs, dedup mapping --------------
    nbytes_arr = np.zeros(nb, dtype=np.int64)
    extent_crcs = np.zeros(nb, dtype=np.uint32)
    canon = np.arange(nb, dtype=np.int64)  # canonical block per payload
    seen: dict = {}
    cap_words = 1
    for lo in range(0, nb, chunk_blocks):
        hi = min(lo + chunk_blocks, nb)
        words, starts, nwords = encode_chunk(lo, hi)
        if nwords.size:
            cap_words = max(cap_words, int(nwords.max()))
        chunk_segs = [words[starts[bi] : starts[bi] + nwords[bi]] for bi in range(hi - lo)]
        chunk_crcs = crc32c_many(chunk_segs)
        for bi in range(hi - lo):
            b = lo + bi
            seg = chunk_segs[bi]
            crc = chunk_crcs[bi]
            extent_crcs[b] = crc
            nbytes_arr[b] = 4 * int(nwords[bi])
            if dedup:
                # two independent CRCs + length + end words: collisions on
                # all five at once are out of birthday range for any nb
                key = (crc, zlib.crc32(seg), int(nwords[bi]),
                       seg[:2].tobytes(), seg[-2:].tobytes())
                prev = seen.setdefault(key, b)
                if prev != b:
                    canon[b] = prev
    # ---- consensus windows: by reference, with per-window CRCs ---------
    cons_w = widths["cons"]
    w0 = directory[:, D["cons_start"]] // 16
    cons_win_crcs = np.zeros(nb, dtype=np.uint32)
    if integrity:
        for lo in range(0, nb, chunk_blocks):
            hi = min(lo + chunk_blocks, nb)
            win = _cons_window_rows(cons, w0[lo:hi], cons_w)
            cons_win_crcs[lo:hi] = crc32c_many(list(win))
    # ---- extent placement: tight slots, shared when dedup'd ------------
    slot = -(-nbytes_arr // align) * align
    is_canon = canon == np.arange(nb, dtype=np.int64)
    sizes = slot[is_canon]
    rel_c = np.zeros(sizes.size, dtype=np.int64)
    if sizes.size > 1:
        np.cumsum(sizes[:-1], out=rel_c[1:])
    rel = np.zeros(nb, dtype=np.int64)
    rel[is_canon] = rel_c
    rel = rel[canon]  # duplicates point at their canonical slot
    data_span = int(sizes.sum())
    extents = np.empty((nb, 2), dtype=np.int64)
    extents[:, 1] = nbytes_arr
    L_g = np.zeros(n_groups, dtype=np.int64)
    p_slot = np.zeros(n_groups, dtype=np.int64)
    p_rel = np.zeros(n_par, dtype=np.int64)
    parity_extents = np.zeros((n_par, 2), dtype=np.int64)
    if parity is not None:
        for g in range(n_groups):
            L_g[g] = int(nbytes_arr[g * parity_group : (g + 1) * parity_group].max())
        p_slot = -(-L_g // align) * align
        p_sizes = np.repeat(p_slot, m_par)
        if n_par > 1:
            np.cumsum(p_sizes[:-1], out=p_rel[1:])
        parity_extents[:, 1] = np.repeat(L_g, m_par)
    parity_span = int(np.repeat(p_slot, m_par).sum()) if parity is not None else 0
    stride = int(slot.max()) if nb else align  # largest stored extent slot
    dir_enc = sagecodec.encode_i64_table(directory)
    header = {
        "meta": json.loads(sf.meta.to_json()),
        "align": align,
        "widths": list(layout.widths),
        "payload_nbytes": layout.payload_nbytes,
        "stride_nbytes": stride,
        "n_blocks": nb,
        "cons_nbytes": int(cons.nbytes),
        "codec": {
            "version": sagecodec.CODEC_VERSION,
            "cap_words": cap_words,
            "dicts": dicts.tolist(),
            "dedup": bool(dedup),
            "dedup_blocks": int(nb - is_canon.sum()),
            "stored_payload_nbytes": int(nbytes_arr[is_canon].sum()),
            "dir_nbytes": len(dir_enc),
            "ext_nbytes": 0,  # patched in the convergence loop below
        },
    }
    if integrity:
        header["integrity"] = {
            "algo": "crc32c",
            "dir_crc": crc32c(dir_enc),  # CRCs cover the ENCODED bytes
            "cons_crc": crc32c(cons),
            "extent_crc_section": True,
            "cons_win_crc_section": True,
            "footer": True,
        }
    if parity is not None:
        header["parity"] = {
            "scheme": parity,
            "group_blocks": parity_group,
            "shards": m_par,
            "n_groups": n_groups,
            "extents_section": True,
        }
    crc_nbytes = (nb + n_par) * 4 if integrity else 0
    cw_nbytes = nb * 4 if integrity else 0
    data_start = 0
    hjson = b""
    ext_enc = b""
    header_nbytes = cons_offset = 0
    # extent offsets depend on the header size, which depends (via the
    # delta-coded extent table and its CRC) on the offsets: iterate to a
    # fixed point, like the legacy writer's convergence loop
    for _ in range(16):
        extents[:, 0] = data_start + rel
        if parity is not None:
            parity_extents[:, 0] = data_start + data_span + p_rel
        ext_enc = sagecodec.encode_i64_table(extents)
        header["codec"]["ext_nbytes"] = len(ext_enc)
        if integrity:
            header["integrity"]["extents_crc"] = crc32c(ext_enc)
        hjson = json.dumps(header).encode()
        header_nbytes = (
            _FIXED + len(hjson) + len(dir_enc) + len(ext_enc)
            + n_par * 16 + cw_nbytes + crc_nbytes
        )
        cons_offset = align_up(header_nbytes, align)
        new_start = align_up(cons_offset + cons.nbytes, align)
        if new_start == data_start:
            break
        data_start = new_start
    else:  # pragma: no cover - needs a pathological align/size interaction
        raise RuntimeError("write_v2: codec header layout failed to converge")
    # ---- pass 2: payload + parity bytes --------------------------------
    parity_crcs = np.zeros(n_par, dtype=np.uint32)
    parity_rows: list = [None] * n_par
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    try:
        with open(tmp, "w+b") as f:  # + so the footer can CRC the header back
            f.write(MAGIC)
            f.write(np.uint64(len(hjson)).tobytes())
            f.write(hjson)
            f.write(dir_enc)
            f.write(ext_enc)
            if parity is not None:
                f.write(parity_extents.tobytes())
            if integrity:
                f.write(cons_win_crcs.tobytes())
                f.write(extent_crcs.tobytes())
                if parity is not None:
                    f.write(parity_crcs.tobytes())  # placeholder, patched below
            f.write(b"\0" * (cons_offset - f.tell()))
            f.write(cons.tobytes())
            f.write(b"\0" * (data_start - f.tell()))
            for lo in range(0, nb, chunk_blocks):
                hi = min(lo + chunk_blocks, nb)
                words, starts, nwords = encode_chunk(lo, hi)
                out = bytearray()
                for bi in range(hi - lo):
                    b = lo + bi
                    if canon[b] != b:
                        continue  # dedup: shares an earlier block's extent
                    seg = words[starts[bi] : starts[bi] + nwords[bi]]
                    out += seg.tobytes()
                    out += b"\0" * int(slot[b] - nbytes_arr[b])
                f.write(out)
                if parity is not None:
                    # groups never straddle a chunk (chunk_blocks is a
                    # parity_group multiple); members are padded to the
                    # group's longest STORED payload
                    for g0 in range(lo, hi, parity_group):
                        g = g0 // parity_group
                        g1 = min(g0 + parity_group, nb)
                        members = np.zeros((g1 - g0, int(L_g[g])), dtype=np.uint8)
                        for mi, b in enumerate(range(g0, g1)):
                            bi = b - lo
                            seg = words[starts[bi] : starts[bi] + nwords[bi]]
                            members[mi, : 4 * seg.size] = seg.view(np.uint8)
                        shards = encode_parity(members, m_par)
                        for j in range(m_par):
                            p = g * m_par + j
                            parity_rows[p] = shards[j]
                            parity_crcs[p] = crc32c(shards[j])
            for p in range(n_par):
                f.write(parity_rows[p].tobytes())
                f.write(b"\0" * int(p_slot[p // m_par] - L_g[p // m_par]))
            file_nbytes = f.tell()
            if integrity:
                if parity is not None:
                    f.seek(header_nbytes - n_par * 4)
                    f.write(parity_crcs.tobytes())
                f.seek(0)
                header_crc = crc32c(f.read(header_nbytes))
                f.seek(file_nbytes)
                footer = (
                    FOOTER_MAGIC
                    + np.uint64(file_nbytes).tobytes()
                    + np.uint32(header_crc).tobytes()
                )
                f.write(footer + np.uint32(crc32c(footer)).tobytes())
                file_nbytes += FOOTER_NBYTES
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic publish
        try:  # persist the rename itself (best effort on exotic filesystems)
            dfd = os.open(path.parent, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    return {
        "n_blocks": nb,
        "payload_nbytes": layout.payload_nbytes,
        "stride_nbytes": stride,
        "header_nbytes": header_nbytes,
        "header_json_nbytes": len(hjson),
        "dir_enc_nbytes": len(dir_enc),
        "ext_enc_nbytes": len(ext_enc),
        "cons_nbytes": int(cons.nbytes),
        "data_start": data_start,
        "file_nbytes": file_nbytes,
        "align": align,
        "integrity": integrity,
        "checksum_nbytes": crc_nbytes,
        "cons_win_crc_nbytes": cw_nbytes,
        "footer_nbytes": FOOTER_NBYTES if integrity else 0,
        "parity": parity,
        "parity_group": parity_group if parity is not None else 0,
        "parity_shards": m_par,
        "parity_nbytes": parity_span,
        "parity_overhead": (
            parity_span / data_span if parity is not None and data_span else 0.0
        ),
        "codec": True,
        "codec_version": sagecodec.CODEC_VERSION,
        "cap_words": cap_words,
        "stored_payload_nbytes": int(nbytes_arr[is_canon].sum()),
        "data_span_nbytes": data_span,
        "dedup_blocks": int(nb - is_canon.sum()),
    }


# --------------------------------------------------------------------------
# lazy reader
# --------------------------------------------------------------------------

class SageContainerV2:
    """Header-only handle on a v2 container with lazy ranged block I/O.

    Construction reads *only* the header (meta + directory + extent table +
    checksum section) and — for integrity containers — validates every
    section length (``TornWriteError`` names the section that came up
    short), the directory/extent-table CRCs, and the commit footer before
    the handle exists. Block bytes move off disk exclusively through
    :meth:`gather_block_arrays`. No file descriptor is held between calls —
    every gather opens, reads its coalesced ranges, and closes.

    ``retry`` bounds transient-failure recovery on every ranged read;
    ``verify=False`` disables per-extent CRC checks on gather (the header
    and footer are always validated when present)."""

    def __init__(
        self,
        path: str | Path,
        *,
        io_stats: Optional[dict] = None,
        retry: RetryPolicy = DEFAULT_RETRY,
        verify: bool = True,
    ) -> None:
        self.path = Path(path)
        self.io_stats = io_stats if io_stats is not None else new_io_stats()
        self.retry = retry
        region = []  # raw header bytes, for the footer's header CRC

        def read_exact(f, n: int, section: str) -> bytes:
            data = f.read(n)
            if len(data) != n:
                raise TornWriteError(
                    f"{self.path}: {section} truncated "
                    f"({len(data)}/{n} bytes) — incomplete write",
                    path=str(self.path), section=section,
                )
            region.append(data)
            return data

        with _open_read(self.path) as f:
            magic = read_exact(f, len(MAGIC), "magic")
            if magic != MAGIC:
                raise ValueError(
                    f"{self.path}: not a SAGe v2 container (magic {magic!r})"
                )
            (hlen,) = np.frombuffer(read_exact(f, 8, "header length"), np.uint64)
            try:
                header = json.loads(
                    read_exact(f, int(hlen), "header json").decode()
                )
                self.meta = SageMeta.from_json(json.dumps(header["meta"]))
                nb = int(header["n_blocks"])
            except (UnicodeDecodeError, json.JSONDecodeError, KeyError,
                    TypeError, ValueError) as e:
                raise IntegrityError(
                    f"{self.path}: header json is unreadable ({e}) — "
                    f"corrupt or truncated container",
                    path=str(self.path), section="header json",
                ) from e
            self.codec = header.get("codec")
            self.integrity = header.get("integrity")
            self.parity = header.get("parity")
            if self.codec:
                dir_raw = read_exact(
                    f, int(self.codec["dir_nbytes"]), "directory")
                ext_raw = read_exact(
                    f, int(self.codec["ext_nbytes"]), "extent table")
            else:
                dir_raw = read_exact(f, nb * NDIR * 8, "directory")
                ext_raw = read_exact(f, nb * 2 * 8, "extent table")
            n_par = (
                int(self.parity["n_groups"]) * int(self.parity["shards"])
                if self.parity is not None else 0
            )
            self._parity_extents: Optional[np.ndarray] = None
            if self.parity is not None and self.parity.get("extents_section"):
                pext_raw = read_exact(f, n_par * 16, "parity extent table")
                self._parity_extents = np.frombuffer(
                    pext_raw, np.int64).reshape(n_par, 2).copy()
            self._cons_win_crcs: Optional[np.ndarray] = None
            if self.integrity and self.integrity.get("cons_win_crc_section"):
                cw_raw = read_exact(f, nb * 4, "consensus window checksums")
                self._cons_win_crcs = np.frombuffer(cw_raw, np.uint32).copy()
            self._extent_crcs: Optional[np.ndarray] = None
            if self.integrity and self.integrity.get("extent_crc_section"):
                crc_raw = read_exact(f, nb * 4, "checksum section")
                self._extent_crcs = np.frombuffer(crc_raw, np.uint32).copy()
            self._parity_crcs: Optional[np.ndarray] = None
            if self.parity is not None:
                pcrc_raw = read_exact(f, n_par * 4, "parity checksum section")
                self._parity_crcs = np.frombuffer(pcrc_raw, np.uint32).copy()
            header_nbytes = f.tell()
            if self.integrity:
                for crc, raw, section in (
                    (self.integrity.get("dir_crc"), dir_raw, "directory"),
                    (self.integrity.get("extents_crc"), ext_raw, "extent table"),
                ):
                    if crc is not None and crc32c(raw) != int(crc):
                        raise IntegrityError(
                            f"{self.path}: {section} checksum mismatch — "
                            f"corrupt container",
                            path=str(self.path), section=section,
                        )
                if self.integrity.get("footer"):
                    self._check_footer(f, header_nbytes, b"".join(region))
        # VERIFY-THEN-DECODE: the planner tables are only decoded after the
        # section CRCs (and footer-bound header CRC) above checked out —
        # the codec never runs on unverified bytes (DESIGN.md §11)
        try:
            if self.codec:
                self.directory = sagecodec.decode_i64_table(dir_raw, nb, NDIR)
                self.extents = sagecodec.decode_i64_table(ext_raw, nb, 2)
            else:
                self.directory = np.frombuffer(dir_raw, dtype=np.int64).reshape(
                    nb, NDIR).copy()
                self.extents = np.frombuffer(ext_raw, dtype=np.int64).reshape(
                    nb, 2).copy()
        except ValueError as e:
            raise IntegrityError(
                f"{self.path}: binary header table is undecodable ({e}) — "
                f"corrupt container",
                path=str(self.path), section="directory",
            ) from e
        self._verify_extents = bool(
            verify and self._extent_crcs is not None
        )
        self.layout = ExtentLayout(
            widths=tuple((k, int(w)) for k, w in header["widths"]),
            align=int(header["align"]),
        )
        self.stride_nbytes = int(header["stride_nbytes"])
        if self.codec:
            self._codec_dicts = np.asarray(self.codec["dicts"], dtype=np.uint8)
            self._cap_words = int(self.codec["cap_words"])
            self._parity_start = (
                int(self._parity_extents[0, 0])
                if self._parity_extents is not None and n_par else 0
            )
        else:
            self._codec_dicts = None
            self._cap_words = 0
            # parity shards sit directly after the last data extent (the
            # data region ends stride-aligned, so no derived-offset padding)
            self._parity_start = (
                int(self.extents[:, 0].max()) + self.stride_nbytes if nb else 0
            )
        self._cons_offset = align_up(header_nbytes, self.layout.align)
        self._cons_nbytes = int(header["cons_nbytes"])
        self.io_stats["opens"] += 1
        self.io_stats["header_bytes"] += header_nbytes + (
            FOOTER_NBYTES if self.integrity and self.integrity.get("footer") else 0
        )

    def _check_footer(self, f, header_nbytes: int, header_raw: bytes) -> None:
        """Validate the end-of-file commit footer: present, self-checksummed,
        binding the true body length and the header-region CRC. Any failure
        means the writer never committed (or the file was damaged after)."""
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size < header_nbytes + FOOTER_NBYTES:
            raise TornWriteError(
                f"{self.path}: file too short for a commit footer "
                f"({size} bytes) — torn write",
                path=str(self.path), section="commit footer",
            )
        f.seek(size - FOOTER_NBYTES)
        foot = f.read(FOOTER_NBYTES)
        if (
            len(foot) != FOOTER_NBYTES
            or foot[: len(FOOTER_MAGIC)] != FOOTER_MAGIC
            or crc32c(foot[:-4]) != int(np.frombuffer(foot[-4:], np.uint32)[0])
        ):
            raise TornWriteError(
                f"{self.path}: commit footer missing or invalid — the "
                f"writer never committed this container (torn write)",
                path=str(self.path), section="commit footer",
            )
        (body,) = np.frombuffer(foot[8:16], np.uint64)
        if int(body) != size - FOOTER_NBYTES:
            raise TornWriteError(
                f"{self.path}: commit footer records {int(body)} body bytes "
                f"but the file has {size - FOOTER_NBYTES} — torn write",
                path=str(self.path), section="commit footer",
            )
        (header_crc,) = np.frombuffer(foot[16:20], np.uint32)
        if crc32c(header_raw) != int(header_crc):
            raise IntegrityError(
                f"{self.path}: header region checksum mismatch against the "
                f"commit footer — corrupt header",
                path=str(self.path), section="header",
            )

    @classmethod
    def open(
        cls,
        path: str | Path,
        *,
        io_stats: Optional[dict] = None,
        retry: RetryPolicy = DEFAULT_RETRY,
        verify: bool = True,
    ) -> "SageContainerV2":
        return cls(path, io_stats=io_stats, retry=retry, verify=verify)

    @property
    def n_blocks(self) -> int:
        return self.meta.n_blocks

    def _check_ids(self, ids) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        if ids.ndim != 1:
            raise ValueError(f"block ids must be 1-D, got shape {ids.shape}")
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_blocks):
            raise IndexError(
                f"block ids out of bounds for {self.path} ({self.n_blocks} blocks)"
            )
        return ids

    def gather_block_arrays(self, ids) -> dict[str, np.ndarray]:
        """Block-major decoder arrays for ``ids`` — the lazy counterpart of
        :func:`repro_torch.core.blocks.prepare_block_arrays`.

        Each run of adjacent extents is read with ONE ranged ``seek``/
        ``read`` (alignment padding rides along inside a run; nothing else
        is touched), so a k-block gather costs O(k) extent bytes however
        the run boundaries fall. ``io_stats`` records every read.

        On codec containers the extents hold COMPRESSED payloads: this
        method verifies the stored bytes (:meth:`gather_packed`), decodes
        them with the host reference decoder, and gathers each block's
        consensus window from the shared section — the returned arrays are
        bit-identical to the legacy (raw-extent) path."""
        ids = self._check_ids(ids)
        if self.codec:
            packed = self.gather_packed(ids)
            arrays = sagecodec.decode_blocks(
                packed, dict(self.layout.widths), self._codec_dicts
            )
            arrays["cons"] = self.gather_consensus_windows(ids)
            arrays["dir"] = localize_directory(self.directory, ids)
            self.io_stats["extent_bytes_decoded"] += (
                int(ids.size) * self.layout.payload_nbytes
            )
            return arrays
        stride_w = self.stride_nbytes // 4
        order = np.argsort(ids, kind="stable")
        sids = ids[order]
        buf = np.empty((ids.size, stride_w), dtype=np.uint32)
        f = _open_read(self.path)
        try:
            i = 0
            while i < sids.size:
                j = i + 1
                while j < sids.size and sids[j] == sids[j - 1] + 1:
                    j += 1
                offset = int(self.extents[sids[i], 0])
                nbytes = (j - i) * self.stride_nbytes
                run = tuple(int(b) for b in sids[i:j])
                data, f = self._read_run(f, offset, nbytes, run)
                rows = np.frombuffer(data, dtype=np.uint32).reshape(j - i, stride_w)
                if self._verify_extents:
                    rows, f = self._verify_run(f, rows, offset, nbytes, run)
                buf[i:j] = rows
                self.io_stats["extent_reads"] += 1
                self.io_stats["extent_bytes_read"] += nbytes
                i = j
        finally:
            f.close()
        self.io_stats["blocks_fetched"] += int(ids.size)
        self.io_stats["extent_bytes_stored"] += int(self.extents[ids, 1].sum())
        self.io_stats["extent_bytes_decoded"] += (
            int(ids.size) * self.layout.payload_nbytes
        )
        if not np.array_equal(sids, ids):
            buf = buf[np.argsort(order, kind="stable")]  # back to request order
        offsets = self.layout.column_offsets()
        arrays = {k: buf[:, offsets[k] : offsets[k] + w] for k, w in self.layout.widths}
        arrays["dir"] = localize_directory(self.directory, ids)
        return arrays

    def gather_packed(self, ids) -> np.ndarray:
        """CRC-verified STORED (compressed) extent payloads for ``ids``:
        an (n, cap_words) uint32 array, each row zero-padded past its
        block's stored words — the direct input of every unpack decoder
        (host reference, jit, Pallas).

        Dedup-aware: blocks sharing a payload share an extent, which is
        read and verified once per gather. Only exactly-adjacent slots are
        coalesced into one ranged read (no gap bytes are ever fetched), so
        ``extent_bytes_read`` is bounded by the unique compressed slots of
        the request — the O(k)-compressed-bytes guarantee. Verification
        runs on the stored bytes BEFORE any decode; a persistent mismatch
        is healed from parity when present, else :class:`IntegrityError`."""
        if not self.codec:
            raise ValueError(f"{self.path}: not a codec container")
        ids = self._check_ids(ids)
        cap = self._cap_words
        out = np.zeros((ids.size, cap), dtype=np.uint32)
        offs = self.extents[ids, 0]
        nbs = self.extents[ids, 1]
        uoff, uidx, uinv = np.unique(offs, return_index=True, return_inverse=True)
        unb = nbs[uidx]  # a shared offset always carries identical nbytes
        align = self.layout.align
        uslot = -(-unb // align) * align
        rep = np.empty(uoff.size, dtype=np.int64)
        rep[uinv] = ids  # one representative block per unique extent
        f = _open_read(self.path)
        try:
            i = 0
            while i < uoff.size:
                j = i + 1
                while j < uoff.size and uoff[j] == uoff[j - 1] + uslot[j - 1]:
                    j += 1
                base = int(uoff[i])
                span = int(uoff[j - 1] + unb[j - 1]) - base
                run_blocks = tuple(int(rep[k]) for k in range(i, j))
                data, f = self._read_run(f, base, span, run_blocks)
                self.io_stats["extent_reads"] += 1
                self.io_stats["extent_bytes_read"] += span

                def segs_of(data):
                    return {
                        k: np.frombuffer(
                            data, np.uint32,
                            count=int(unb[k]) // 4,
                            offset=int(uoff[k]) - base,
                        )
                        for k in range(i, j)
                    }

                def bad_of(segs):
                    crcs = crc32c_many([segs[k] for k in range(i, j)])
                    return [
                        k for k, c in zip(range(i, j), crcs)
                        if c != int(self._extent_crcs[rep[k]])
                    ]

                segs = segs_of(data)
                if self._verify_extents:
                    bad = bad_of(segs)
                    if bad:
                        self.io_stats["checksum_retries"] += 1
                        data, f = self._read_run(f, base, span, run_blocks)
                        segs = segs_of(data)
                        bad = bad_of(segs)
                    if bad:
                        self.io_stats["checksum_failures"] += 1
                        bad_blocks = sorted(int(rep[k]) for k in bad)
                        if self.parity is not None:
                            rebuilt = self.reconstruct_blocks(bad_blocks)
                            for k in bad:
                                segs[k] = rebuilt[int(rep[k])].view(np.uint32)
                        else:
                            raise IntegrityError(
                                f"{self.path}: extent checksum mismatch for "
                                f"block(s) {bad_blocks} (persisted through a "
                                f"re-read) — corrupt extents",
                                path=str(self.path),
                                section=f"extent {bad_blocks[0]}",
                                blocks=tuple(bad_blocks),
                            )
                    self.io_stats["blocks_verified"] += int(
                        np.count_nonzero((uinv >= i) & (uinv < j))
                    )
                for k in range(i, j):
                    out[uinv == k, : segs[k].size] = segs[k]
                i = j
        finally:
            f.close()
        self.io_stats["blocks_fetched"] += int(ids.size)
        self.io_stats["extent_bytes_stored"] += int(nbs.sum())
        return out

    def gather_consensus_windows(self, ids) -> np.ndarray:
        """Per-block 2-bit consensus window rows, ranged-read from the
        shared consensus section (codec containers carry windows BY
        REFERENCE — ``directory[:, cons_start] // 16`` words into the
        section — instead of duplicating them into every extent).
        Overlapping/adjacent windows coalesce into one read; rows are
        zero-filled past the section end and checked against the
        per-window CRCs (one re-read, then :class:`IntegrityError`)."""
        ids = self._check_ids(ids)
        Wc = dict(self.layout.widths)["cons"]
        total_w = self._cons_nbytes // 4
        w0 = self.directory[ids, D["cons_start"]] // 16
        out = np.zeros((ids.size, Wc), dtype=np.uint32)
        uw0, uinv = np.unique(w0, return_inverse=True)
        f = _open_read(self.path)
        try:
            i = 0
            while i < uw0.size:
                j = i + 1
                end = int(uw0[i]) + Wc
                while j < uw0.size and int(uw0[j]) <= end:
                    end = max(end, int(uw0[j]) + Wc)
                    j += 1
                start = int(uw0[i])
                span = 4 * max(0, min(end, total_w) - start)

                def rows_of(data):
                    buf = np.zeros(end - start, dtype=np.uint32)
                    got = np.frombuffer(data, np.uint32)
                    buf[: got.size] = got
                    return {
                        k: buf[int(uw0[k]) - start : int(uw0[k]) - start + Wc]
                        for k in range(i, j)
                    }

                def bad_of(rows):
                    if not self._verify_extents or self._cons_win_crcs is None:
                        return []
                    # duplicates of a window share its CRC: check via any id
                    reps = {}
                    for pos, k in enumerate(uinv):
                        if i <= k < j:
                            reps.setdefault(int(k), int(ids[pos]))
                    crcs = crc32c_many([rows[k] for k in range(i, j)])
                    return [
                        k for k, c in zip(range(i, j), crcs)
                        if c != int(self._cons_win_crcs[reps[k]])
                    ]

                data, f = self._read_run(
                    f, self._cons_offset + 4 * start, span, ())
                self.io_stats["consensus_bytes_read"] += span
                rows = rows_of(data)
                bad = bad_of(rows)
                if bad:
                    self.io_stats["checksum_retries"] += 1
                    data, f = self._read_run(
                        f, self._cons_offset + 4 * start, span, ())
                    rows = rows_of(data)
                    bad = bad_of(rows)
                    if bad:
                        self.io_stats["checksum_failures"] += 1
                        bad_blocks = sorted(
                            int(b) for pos, b in enumerate(ids)
                            if int(uinv[pos]) in bad
                        )
                        raise IntegrityError(
                            f"{self.path}: consensus window checksum mismatch "
                            f"for block(s) {bad_blocks} (persisted through a "
                            f"re-read) — corrupt consensus section",
                            path=str(self.path), section="consensus",
                            blocks=tuple(bad_blocks),
                        )
                for k in range(i, j):
                    out[uinv == k] = rows[k]
                i = j
        finally:
            f.close()
        return out

    def parity_extent(self, p: int) -> tuple[int, int]:
        """(offset, nbytes) of parity shard ``p`` — from the explicit
        parity extent table on codec containers, derived from the uniform
        stride on legacy ones."""
        if self._parity_extents is not None:
            return int(self._parity_extents[p, 0]), int(self._parity_extents[p, 1])
        return (
            self._parity_start + int(p) * self.stride_nbytes,
            self.layout.payload_nbytes,
        )

    def _read_run(self, f, offset: int, nbytes: int, blocks: tuple[int, ...]):
        """One coalesced ranged read with bounded retry.

        EIO and short reads re-seek + re-read after the policy backoff,
        re-opening the file each retry (an EIO can poison the descriptor).
        Returns ``(data, f)`` — the caller must keep using the returned
        handle. Exhausted EIO → :class:`TransientIOError`; a short read
        that persists through every attempt → :class:`TornWriteError`."""
        policy = self.retry
        last: Optional[BaseException] = None
        for attempt in range(policy.attempts):
            if attempt:
                self.io_stats["read_retries"] += 1
                time.sleep(policy.delay(attempt - 1))
                try:
                    f.close()
                except OSError:
                    pass
                f = _open_read(self.path)
                self.io_stats["opens"] += 1
            try:
                f.seek(offset)
                data = f.read(nbytes)
            except SageIOError:
                raise
            except OSError as e:
                last = e
                continue
            if len(data) == nbytes:
                return data, f
            last = TornWriteError(
                f"{self.path}: short read at offset {offset} "
                f"({len(data)}/{nbytes} bytes) for blocks {blocks[:4]}...",
                path=str(self.path), section=f"extent run @{offset}",
                blocks=blocks,
            )
        self.io_stats["read_failures"] += 1
        if isinstance(last, TornWriteError):
            raise last
        raise TransientIOError(
            f"{self.path}: ranged read at offset {offset} ({nbytes} bytes) "
            f"failed after {policy.attempts} attempts: {last}",
            path=str(self.path), section=f"extent run @{offset}",
            blocks=blocks,
        ) from last

    def _verify_run(self, f, rows: np.ndarray, offset: int, nbytes: int,
                    blocks: tuple[int, ...]):
        """Check every block's payload against its stored CRC32C.

        A mismatch earns exactly ONE re-read of the run (a transient flip
        between the medium and the buffer heals); a mismatch that survives
        the re-read is provable corruption → :class:`IntegrityError` naming
        the bad blocks. Returns ``(rows, f)``."""
        pw = self.layout.payload_words
        stride_w = self.stride_nbytes // 4

        def bad_blocks(rows):
            crcs = crc32c_many([rows[bi, :pw] for bi in range(len(blocks))])
            return [
                b for b, c in zip(blocks, crcs)
                if c != int(self._extent_crcs[b])
            ]

        bad = bad_blocks(rows)
        if bad:
            self.io_stats["checksum_retries"] += 1
            data, f = self._read_run(f, offset, nbytes, blocks)
            rows = np.frombuffer(data, dtype=np.uint32).reshape(-1, stride_w)
            bad = bad_blocks(rows)
            if bad:
                self.io_stats["checksum_failures"] += 1
                if self.parity is not None:
                    # degraded-mode read: rebuild the damaged payloads from
                    # parity + survivors and serve them (the medium is still
                    # damaged — SageStore.repair makes this durable)
                    rebuilt = self.reconstruct_blocks(bad)
                    rows = rows.copy()
                    for bi, b in enumerate(blocks):
                        if b in rebuilt:
                            rows[bi, :pw] = rebuilt[b].view(np.uint32)
                            rows[bi, pw:] = 0
                    self.io_stats["blocks_verified"] += len(blocks)
                    return rows, f
                raise IntegrityError(
                    f"{self.path}: extent checksum mismatch for block(s) "
                    f"{bad} (persisted through a re-read) — corrupt extents",
                    path=str(self.path), section=f"extent {bad[0]}",
                    blocks=tuple(bad),
                )
        self.io_stats["blocks_verified"] += len(blocks)
        return rows, f

    # -------------------------------------------------- self-healing (PR 8)

    def _read_checked(self, f, offset: int, nbytes: int, crc: int,
                      blocks: tuple[int, ...]):
        """Read one stored payload (``nbytes`` — compressed on codec
        containers, the raw payload on legacy ones) and CRC-check it.

        One re-read on mismatch (same contract as :meth:`_verify_run`);
        a persistent mismatch returns ``(None, f)`` instead of raising —
        the healing paths treat it as an erasure, the scrub paths as a
        finding."""
        data, f = self._read_run(f, offset, nbytes, blocks)
        row = np.frombuffer(data, np.uint8)
        if crc32c(row) != int(crc):
            self.io_stats["checksum_retries"] += 1
            data, f = self._read_run(f, offset, nbytes, blocks)
            row = np.frombuffer(data, np.uint8)
            if crc32c(row) != int(crc):
                return None, f
        return row.copy(), f

    def reconstruct_blocks(self, bad) -> dict[int, np.ndarray]:
        """Rebuild damaged extent payloads from parity + surviving extents.

        ``bad`` are block ids whose payloads failed their CRC. Every
        parity group touched is solved independently: surviving members
        and intact parity shards are read (and verified) from disk, the
        erasures recovered over GF(256), and each rebuilt payload verified
        against the stored extent CRC before it is returned as a
        ``{block_id: uint8 payload}`` entry. Damage exceeding a group's
        intact parity shards raises :class:`IntegrityError` naming every
        damaged block (``reconstruction_failures`` counts them)."""
        if self.parity is None or self._extent_crcs is None:
            raise IntegrityError(
                f"{self.path}: container has no parity section — "
                f"cannot reconstruct blocks {tuple(bad)[:4]}",
                path=str(self.path), section="parity",
                blocks=tuple(int(b) for b in bad),
            )
        pg = int(self.parity["group_blocks"])
        m = int(self.parity["shards"])
        groups: dict[int, set[int]] = {}
        for b in {int(x) for x in bad}:
            groups.setdefault(b // pg, set()).add(b)
        out: dict[int, np.ndarray] = {}
        f = _open_read(self.path)
        self.io_stats["opens"] += 1
        try:
            for g in sorted(groups):
                # parity runs over STORED payloads, each member zero-padded
                # to the group's longest (the parity shard length)
                Lg = self.parity_extent(g * m)[1]
                erased_set = set(groups[g])
                known: dict[int, np.ndarray] = {}
                for b in range(g * pg, min((g + 1) * pg, self.n_blocks)):
                    if b in erased_set:
                        continue
                    nbytes = int(self.extents[b, 1])
                    row, f = self._read_checked(
                        f, int(self.extents[b, 0]), nbytes,
                        self._extent_crcs[b], (b,)
                    )
                    self.io_stats["extent_reads"] += 1
                    self.io_stats["extent_bytes_read"] += nbytes
                    if row is None:  # collateral damage found while solving
                        erased_set.add(b)
                    else:
                        if row.size < Lg:
                            row = np.concatenate(
                                [row, np.zeros(Lg - row.size, dtype=np.uint8)]
                            )
                        known[b - g * pg] = row
                par: dict[int, np.ndarray] = {}
                for j in range(m):
                    p = g * m + j
                    poff, pnb = self.parity_extent(p)
                    row, f = self._read_checked(
                        f, poff, pnb, self._parity_crcs[p], (),
                    )
                    self.io_stats["parity_reads"] += 1
                    self.io_stats["parity_bytes_read"] += pnb
                    if row is not None:
                        par[j] = row
                erased = sorted(b - g * pg for b in erased_set)
                try:
                    rebuilt = recover_erasures(known, erased, par, Lg)
                except ValueError as e:
                    self.io_stats["reconstruction_failures"] += len(erased_set)
                    raise IntegrityError(
                        f"{self.path}: unrecoverable damage — "
                        f"{len(erased)} damaged extent(s) "
                        f"{tuple(sorted(erased_set))} in parity group {g} "
                        f"exceed its {len(par)} intact parity shard(s)",
                        path=str(self.path), section=f"parity group {g}",
                        blocks=tuple(sorted(erased_set)),
                    ) from e
                for pos, row in rebuilt.items():
                    b = g * pg + pos
                    row = row[: int(self.extents[b, 1])]  # strip group padding
                    if crc32c(row) != int(self._extent_crcs[b]):
                        self.io_stats["reconstruction_failures"] += 1
                        raise IntegrityError(
                            f"{self.path}: rebuilt extent {b} failed CRC "
                            f"verification — parity or survivors corrupt",
                            path=str(self.path), section=f"extent {b}",
                            blocks=(b,),
                        )
                    out[b] = row
                    self.io_stats["reconstructions"] += 1
        finally:
            f.close()
        return out

    def verify_blocks(self, ids=None) -> list[int]:
        """Scrub-scan extent payload CRCs WITHOUT raising; returns the
        damaged block ids (each mismatch got one re-read first). ``None``
        scans every block. No-op ``[]`` on pre-checksum containers."""
        if self._extent_crcs is None:
            return []
        todo = (
            range(self.n_blocks) if ids is None
            else sorted({int(x) for x in np.asarray(ids).reshape(-1)})
        )
        bad: list[int] = []
        f = _open_read(self.path)
        self.io_stats["opens"] += 1
        try:
            for b in todo:
                if not 0 <= b < self.n_blocks:
                    raise IndexError(
                        f"block id {b} out of bounds for {self.path} "
                        f"({self.n_blocks} blocks)"
                    )
                nbytes = int(self.extents[b, 1])
                row, f = self._read_checked(
                    f, int(self.extents[b, 0]), nbytes,
                    self._extent_crcs[b], (b,)
                )
                self.io_stats["extent_reads"] += 1
                self.io_stats["extent_bytes_read"] += nbytes
                self.io_stats["blocks_verified"] += 1
                if row is None:
                    bad.append(b)
        finally:
            f.close()
        return bad

    def verify_parity(self, groups=None) -> list[int]:
        """Scrub-scan parity shard CRCs; returns damaged shard indices
        (``group * shards + j``). ``groups`` limits the scan to those
        parity groups. ``[]`` when the container carries no parity."""
        if self.parity is None:
            return []
        m = int(self.parity["shards"])
        n_par = int(self.parity["n_groups"]) * m
        ps = (
            range(n_par) if groups is None
            else sorted({int(g) * m + j for g in groups for j in range(m)})
        )
        bad: list[int] = []
        f = _open_read(self.path)
        self.io_stats["opens"] += 1
        try:
            for p in ps:
                poff, pnb = self.parity_extent(p)
                row, f = self._read_checked(
                    f, poff, pnb, self._parity_crcs[p], (),
                )
                self.io_stats["parity_reads"] += 1
                self.io_stats["parity_bytes_read"] += pnb
                if row is None:
                    bad.append(p)
        finally:
            f.close()
        return bad

    def rebuild_parity(self, shards) -> dict[int, np.ndarray]:
        """Recompute damaged parity shards from their groups' (verified)
        data extents — the inverse direction of :meth:`reconstruct_blocks`.
        Raises :class:`IntegrityError` if a group member is itself damaged
        (repair the data first, then the parity)."""
        if self.parity is None:
            return {}
        pg = int(self.parity["group_blocks"])
        m = int(self.parity["shards"])
        out: dict[int, np.ndarray] = {}
        f = _open_read(self.path)
        self.io_stats["opens"] += 1
        try:
            for g in sorted({int(p) // m for p in shards}):
                rows = []
                Lg = self.parity_extent(g * m)[1]
                for b in range(g * pg, min((g + 1) * pg, self.n_blocks)):
                    nbytes = int(self.extents[b, 1])
                    row, f = self._read_checked(
                        f, int(self.extents[b, 0]), nbytes,
                        self._extent_crcs[b], (b,)
                    )
                    self.io_stats["extent_reads"] += 1
                    self.io_stats["extent_bytes_read"] += nbytes
                    if row is None:
                        raise IntegrityError(
                            f"{self.path}: cannot rebuild parity for group "
                            f"{g}: member extent {b} is damaged — "
                            f"reconstruct the data first",
                            path=str(self.path), section=f"extent {b}",
                            blocks=(b,),
                        )
                    if row.size < Lg:
                        row = np.concatenate(
                            [row, np.zeros(Lg - row.size, dtype=np.uint8)]
                        )
                    rows.append(row)
                enc = encode_parity(np.stack(rows), m)
                for p in shards:
                    if int(p) // m == g:
                        out[int(p)] = enc[int(p) % m]
        finally:
            f.close()
        return out

    def rewrite_extents(
        self,
        payloads: dict[int, np.ndarray],
        parity_payloads: Optional[dict[int, np.ndarray]] = None,
    ) -> None:
        """Atomically patch repaired payloads back into the container.

        The whole file is copied to a same-directory tmp, the given data
        extents (and parity shards) are seek-patched with their stride pad
        re-zeroed, fsynced, and ``os.replace``d over the original — a
        crashed repair leaves the damaged-but-consistent container intact.
        Every payload must match its STORED CRC (repair only ever restores
        the committed bytes), so this handle stays valid afterwards."""

        def as_bytes(row, nbytes: int, what: str) -> bytes:
            row = np.ascontiguousarray(row)
            if row.dtype != np.uint8:
                row = row.view(np.uint8)
            if row.nbytes != nbytes:
                raise ValueError(
                    f"{what}: payload must be {nbytes} bytes, got {row.nbytes}"
                )
            return row.tobytes()

        align = self.layout.align
        tmp = self.path.with_name(f"{self.path.name}.tmp.{os.getpid()}")
        try:
            with open(self.path, "rb") as src, open(tmp, "wb") as dst:
                shutil.copyfileobj(src, dst)
            with open(tmp, "r+b") as f:
                for b, row in sorted((payloads or {}).items()):
                    b = int(b)
                    nbytes = int(self.extents[b, 1])
                    raw = as_bytes(row, nbytes, f"extent {b}")
                    if crc32c(raw) != int(self._extent_crcs[b]):
                        raise IntegrityError(
                            f"{self.path}: refusing to rewrite extent {b} "
                            f"with bytes that do not match its stored CRC",
                            path=str(self.path), section=f"extent {b}",
                            blocks=(b,),
                        )
                    f.seek(int(self.extents[b, 0]))
                    f.write(raw + b"\0" * (align_up(nbytes, align) - nbytes))
                for p, row in sorted((parity_payloads or {}).items()):
                    p = int(p)
                    poff, pnb = self.parity_extent(p)
                    raw = as_bytes(row, pnb, f"parity shard {p}")
                    if crc32c(raw) != int(self._parity_crcs[p]):
                        raise IntegrityError(
                            f"{self.path}: refusing to rewrite parity shard "
                            f"{p} with bytes that do not match its stored CRC",
                            path=str(self.path), section=f"parity shard {p}",
                        )
                    f.seek(poff)
                    f.write(raw + b"\0" * (align_up(pnb, align) - pnb))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)  # atomic publish, like write_v2
            try:
                dfd = os.open(self.path.parent, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:
                pass
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise

    def read_consensus(self) -> np.ndarray:
        """The full 2-bit-packed consensus (its own ranged section — block
        extents carry their decode windows, so ordinary ranged reads never
        touch this). On integrity containers the section CRC is verified,
        with one re-read before a mismatch becomes :class:`IntegrityError`."""
        f = _open_read(self.path)
        try:
            data, f = self._read_run(
                f, self._cons_offset, self._cons_nbytes, blocks=()
            )
            cons_crc = (self.integrity or {}).get("cons_crc")
            if self._verify_extents and cons_crc is not None:
                if crc32c(data) != int(cons_crc):
                    self.io_stats["checksum_retries"] += 1
                    data, f = self._read_run(
                        f, self._cons_offset, self._cons_nbytes, blocks=()
                    )
                    if crc32c(data) != int(cons_crc):
                        self.io_stats["checksum_failures"] += 1
                        raise IntegrityError(
                            f"{self.path}: consensus section checksum "
                            f"mismatch (persisted through a re-read)",
                            path=str(self.path), section="consensus",
                        )
        finally:
            f.close()
        self.io_stats["consensus_bytes_read"] += self._cons_nbytes
        return np.frombuffer(data, dtype=np.uint32).copy()

    def to_sage_file(self, *, chunk_blocks: int = 1024) -> SageFile:
        """Materialize the full v1 in-memory form (compat / back-migration).

        Scatters each block's extent rows back onto the flat streams at the
        directory offsets; overlapping rows are copies of the same source
        words, so the reconstruction is bit-identical to the original."""
        meta = self.meta
        words = {s: (meta.stream_bits.get(s, 0) + 31) // 32 for s in STREAMS}
        streams = {s: np.zeros(words[s], dtype=np.uint32) for s in STREAMS}
        # codec rows zero their tails past each block's own words (the
        # truncation layer) — scatter only the used prefix so a block's
        # zeroed tail never clobbers a neighbor's already-placed words
        used = (
            sagecodec.used_words(
                self.directory, meta.stream_bits, dict(self.layout.widths))
            if self.codec else None
        )
        for lo in range(0, self.n_blocks, chunk_blocks):
            ids = np.arange(lo, min(lo + chunk_blocks, self.n_blocks), dtype=np.int64)
            rows = self.gather_block_arrays(ids)
            for bi, b in enumerate(ids):
                for si, s in enumerate(STREAMS):
                    off = int(self.directory[b, D[f"off_{s}"]]) >> 5
                    lim = rows[s].shape[1] if used is None else int(used[b, si])
                    n = min(lim, words[s] - off)
                    if n > 0:
                        streams[s][off : off + n] = rows[s][bi, :n]
        return SageFile(
            meta=meta,
            consensus2b=self.read_consensus(),
            directory=self.directory.copy(),
            streams=streams,
        )


# --------------------------------------------------------------------------
# version sniffing
# --------------------------------------------------------------------------

def container_version(path: str | Path, *, detail: bool = False):
    """1 for a v1 ``.npz`` archive, 2 for a v2 block-extent container.

    Sniffs the leading magic bytes; raises ``ValueError`` for anything
    else (including empty/truncated files). With ``detail=True`` returns a
    dict reporting integrity capability instead of the bare int:
    ``{"version", "integrity", "checksums", "footer"}`` — ``integrity`` is
    False for v1 archives and pre-checksum v2 containers (both of which
    stay fully readable, just unverified)."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(len(MAGIC))
        if head == MAGIC:
            if not detail:
                return 2
            hdr = {}
            try:
                (hlen,) = np.frombuffer(f.read(8), dtype=np.uint64)
                hdr = json.loads(f.read(int(hlen)).decode())
            except (ValueError, UnicodeDecodeError, json.JSONDecodeError):
                pass  # truncated/corrupt header: opening it will say why
            integ = hdr.get("integrity") or {}
            par = hdr.get("parity") or {}
            cdc = hdr.get("codec") or {}
            return {
                "version": 2,
                "integrity": bool(integ),
                "checksums": bool(integ.get("extent_crc_section")),
                "footer": bool(integ.get("footer")),
                "parity": par.get("scheme"),
                "parity_shards": int(par.get("shards", 0)),
                "codec": bool(cdc),
                "codec_version": int(cdc.get("version", 0)),
            }
    if head[:4] == b"PK\x03\x04":  # zip archive == numpy .npz
        if detail:
            return {"version": 1, "integrity": False, "checksums": False,
                    "footer": False, "parity": None, "parity_shards": 0,
                    "codec": False, "codec_version": 0}
        return 1
    raise ValueError(
        f"{path}: not a SAGe container (leading bytes {head!r}; expected a "
        f"v1 .npz archive or a v2 {MAGIC!r} block-extent container)"
    )


def open_container(path: str | Path):
    """Open a container of either version: v2 paths return the lazy
    :class:`SageContainerV2` handle (header-only I/O); v1 paths fall back to
    the eager whole-file :meth:`SageFile.load`."""
    if container_version(path) == 2:
        return SageContainerV2.open(path)
    return SageFile.load(path)


# --------------------------------------------------------------------------
# host-side extent cache (byte budget)
# --------------------------------------------------------------------------

class HostExtentCache:
    """Byte-budget LRU over host block-group arrays.

    Sits between the v2 containers and device residency: a device-evicted
    group whose extents are still cached re-uploads without touching disk.
    ``budget`` bounds resident bytes UNCONDITIONALLY (``None`` =
    unbounded): an entry that alone exceeds the budget is not cached at
    all (``cache_oversize_skips`` counts them) — re-reading it from disk
    is the out-of-core-correct fallback, blowing the host budget is not."""

    def __init__(self, budget: Optional[int]) -> None:
        if budget is not None and budget < 0:
            raise ValueError(f"cache_budget must be >= 0 or None, got {budget}")
        self.budget = budget
        self._entries: "OrderedDict[tuple, tuple[dict, int]]" = OrderedDict()
        self.stats = {
            "cache_hits": 0, "cache_misses": 0, "cache_evictions": 0,
            "cache_oversize_skips": 0, "cache_drops": 0,
            "cache_bytes": 0, "cache_peak_bytes": 0,
        }

    def get(self, key, record: bool = True) -> Optional[dict]:
        """``record=False`` is the double-checked re-read under the disk
        lock: one logical miss must count once, not once per check."""
        hit = self._entries.get(key)
        if hit is None:
            if record:
                self.stats["cache_misses"] += 1
            return None
        self._entries.move_to_end(key)
        if record:
            self.stats["cache_hits"] += 1
        return hit[0]

    def put(self, key, arrays: dict, nbytes: int) -> None:
        if key in self._entries:
            self.stats["cache_bytes"] -= self._entries.pop(key)[1]
        if self.budget is not None and nbytes > self.budget:
            self.stats["cache_oversize_skips"] += 1
            return
        # make room FIRST: resident bytes never exceed the budget, even
        # transiently (the out-of-core pipeline asserts this via peak_bytes)
        while (
            self.budget is not None
            and self.stats["cache_bytes"] + nbytes > self.budget
        ):
            _, (_, evicted) = self._entries.popitem(last=False)
            self.stats["cache_bytes"] -= evicted
            self.stats["cache_evictions"] += 1
        self._entries[key] = (arrays, nbytes)
        self.stats["cache_bytes"] += nbytes
        self.stats["cache_peak_bytes"] = max(
            self.stats["cache_peak_bytes"], self.stats["cache_bytes"]
        )

    def drop(self, name: Optional[str] = None, group: Optional[int] = None) -> None:
        """Invalidate entries for dataset ``name`` (all when None); with
        ``group`` set, only that dataset's block group — the quarantine
        path drops exactly the damaged group so healthy cached groups keep
        serving."""
        keys = [
            k for k in self._entries
            if (name is None or k[0] == name)
            and (group is None or (len(k) > 1 and k[1] == group))
        ]
        for k in keys:
            self.stats["cache_bytes"] -= self._entries.pop(k)[1]
            self.stats["cache_drops"] += 1

    def __len__(self) -> int:
        return len(self._entries)
