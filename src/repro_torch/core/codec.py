"""Per-extent codec for the v2 container (SAGe's algorithm-architecture
co-design, PAPER.md §4): compression chosen so *decode* is shift/mask/
gather work — no general-purpose inflate anywhere near the hot path.

Three cooperating layers, all lossless:

1. **Word truncation** — a block's row in the fixed-shape block-major
   layout is gathered at a word-aligned offset of the flat bitstream, so
   only the leading ``used_words`` carry the block's own bits; everything
   past them is neighbor data the masked decoder never reads. The codec
   stores only the used prefix and decoders zero-fill the tail.
2. **Nibble dictionary coding** — a container-level 15-entry byte
   dictionary per stream (entry 15 is the escape); each (block, stream)
   section is stored as 4-bit codes plus a compacted escape-byte array
   when that is smaller than the raw words, raw otherwise.
3. **Consensus by reference** — block extents do not duplicate their
   consensus window at all: windows are ranged-read straight out of the
   shared 2-bit consensus section (offset = ``cons_start // 16`` words),
   checked against per-window CRCs.

Packed extent payload (codec v1), little-endian uint32 words::

  word 0..13   per-stream descriptor: used_words | (mode << 20)
  word 14..27  per-stream escape count (0 in raw mode)
  then one word-aligned section per stream, in STREAMS order:
    mode 0 (raw):    used_words words — the truncated row prefix
    mode 1 (nibble): ceil(used_words/2) words of 4-bit codes (8 per
                     word, low nibble first) + ceil(n_esc/4) words of
                     escape bytes (4 per word, low byte first)

The same decode algorithm runs vectorized on the host (this module, the
reference), as plain torch (:func:`repro_torch.kernels.sage_decode.unpack_rows_plain`),
and as a CUDA kernel (:func:`repro_torch.kernels.sage_decode.sage_unpack`). This module also
provides the delta+zigzag binary encoding of the int64 directory / extent
tables that replaces their raw (or JSON) header sections.
"""

from __future__ import annotations

import numpy as np

from .bitio import (
    pack_bits,
    ranges_from_counts,
    unpack_fields,
    zigzag_decode,
    zigzag_encode,
)
from .format import D, STREAMS

__all__ = [
    "CODEC_VERSION",
    "DESC_WORDS",
    "ESCAPE",
    "MODE_NIBBLE",
    "MODE_RAW",
    "N_STREAMS",
    "USED_MASK",
    "build_stream_dicts",
    "decode_blocks",
    "decode_i64_table",
    "encode_blocks",
    "encode_i64_table",
    "nibble_luts",
    "section_words",
    "used_words",
]

CODEC_VERSION = 1
N_STREAMS = len(STREAMS)  # 14
DESC_WORDS = 2 * N_STREAMS  # 28-word descriptor ahead of the sections
MODE_RAW, MODE_NIBBLE = 0, 1
ESCAPE = 15  # the dictionary-miss nibble
USED_MASK = (1 << 20) - 1  # used_words field of a descriptor word


# --------------------------------------------------------------------------
# layer 2: container-level nibble dictionaries
# --------------------------------------------------------------------------

def build_stream_dicts(streams: dict[str, np.ndarray]) -> np.ndarray:
    """(N_STREAMS, 16) uint8 dictionary: per stream, the 15 most frequent
    byte values of its flat bitstream (ties broken toward the smaller
    byte, so the table is deterministic); entry 15 is unused (escape)."""
    dicts = np.zeros((N_STREAMS, 16), dtype=np.uint8)
    for si, s in enumerate(STREAMS):
        arr = np.asarray(streams.get(s, ()), dtype=np.uint32)
        if arr.size:
            counts = np.bincount(arr.view(np.uint8), minlength=256)
            dicts[si, :15] = np.argsort(-counts, kind="stable")[:15].astype(np.uint8)
        else:
            dicts[si, :15] = np.arange(15, dtype=np.uint8)
    return dicts


def nibble_luts(dicts: np.ndarray) -> np.ndarray:
    """(N_STREAMS, 256) byte -> nibble code lookup (ESCAPE for misses)."""
    luts = np.full((N_STREAMS, 256), ESCAPE, dtype=np.uint8)
    for si in range(N_STREAMS):
        luts[si, dicts[si, :15]] = np.arange(15, dtype=np.uint8)
    return luts


# --------------------------------------------------------------------------
# layer 1: per-(block, stream) used-word counts
# --------------------------------------------------------------------------

def used_words(directory: np.ndarray, stream_bits: dict, widths: dict) -> np.ndarray:
    """(n_blocks, N_STREAMS) int64: how many leading row words carry each
    block's own bits. Blocks occupy consecutive bit ranges of every stream
    (the encoder appends block-major), so block ``b`` owns
    ``[off_b, off_{b+1})`` — the last block runs to the stream's total bit
    count. Anything non-monotonic (never produced by the encoder) falls
    back to the full row width, which is always safe."""
    nb = directory.shape[0]
    out = np.empty((nb, N_STREAMS), dtype=np.int64)
    for si, s in enumerate(STREAMS):
        w = int(widths[s])
        off = directory[:, D[f"off_{s}"]].astype(np.int64)
        nxt = np.empty(nb, dtype=np.int64)
        if nb:
            nxt[:-1] = off[1:]
            nxt[-1] = int(stream_bits.get(s, 0))
        bits = nxt - off
        u = np.where(bits > 0, (off + bits - 1) // 32 - (off >> 5) + 1, 0)
        out[:, si] = np.where((bits < 0) | (u > w), w, u)
    return out


def section_words(used: np.ndarray, modes: np.ndarray, nesc: np.ndarray) -> np.ndarray:
    """Stored word count of each (block, stream) section."""
    return np.where(modes == MODE_NIBBLE, (used + 1) // 2 + (nesc + 3) // 4, used)


# --------------------------------------------------------------------------
# block payload encode (writer) / decode (host reference)
# --------------------------------------------------------------------------

def encode_blocks(
    rows: dict[str, np.ndarray], used: np.ndarray, luts: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack a chunk of block rows into codec extent payloads (vectorized).

    ``rows`` is the :func:`prepare_block_arrays` output for the chunk
    (stream name -> (n, W_s) uint32); ``used`` the matching rows of
    :func:`used_words`; ``luts`` from :func:`nibble_luts`. Returns
    ``(words, starts, nwords)``: the n payloads concatenated into one flat
    uint32 array plus each block's start offset and word count in it."""
    n = used.shape[0]
    sec = np.empty((n, N_STREAMS), dtype=np.int64)
    modes = np.empty((n, N_STREAMS), dtype=np.int64)
    nescs = np.empty((n, N_STREAMS), dtype=np.int64)
    cached = []
    for si, s in enumerate(STREAMS):
        r = np.ascontiguousarray(rows[s], dtype=np.uint32)
        w = r.shape[1]
        if w >= USED_MASK:
            raise ValueError(f"stream {s}: row width {w} overflows the descriptor")
        u = used[:, si]
        by = r.view(np.uint8).reshape(n, 4 * w)
        nib = luts[si][by]
        in_use = np.arange(4 * w, dtype=np.int64)[None, :] < (4 * u)[:, None]
        esc = (nib == ESCAPE) & in_use
        ne = esc.sum(axis=1)
        m = ((u + 1) // 2 + (ne + 3) // 4) < u  # nibble strictly smaller
        modes[:, si] = m
        nescs[:, si] = np.where(m, ne, 0)
        sec[:, si] = section_words(u, modes[:, si], nescs[:, si])
        cached.append((r, by, nib, esc, in_use))
    nwords = DESC_WORDS + sec.sum(axis=1)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(nwords, out=starts[1:])
    out = np.zeros(int(starts[-1]), dtype=np.uint32)
    didx = starts[:-1, None] + np.arange(N_STREAMS, dtype=np.int64)[None, :]
    out[didx] = (used | (modes << 20)).astype(np.uint32)
    out[didx + N_STREAMS] = nescs.astype(np.uint32)
    sec_off = starts[:-1, None] + DESC_WORDS + np.concatenate(
        [np.zeros((n, 1), dtype=np.int64), np.cumsum(sec, axis=1)[:, :-1]], axis=1
    )
    rows_idx = np.arange(n, dtype=np.int64)
    for si in range(N_STREAMS):
        r, by, nib, esc, in_use = cached[si]
        w = r.shape[1]
        u = used[:, si]
        m = modes[:, si].astype(bool)
        # raw sections: scatter each truncated prefix in one shot
        cnt = np.where(~m, u, 0)
        k = ranges_from_counts(cnt)
        rep = np.repeat(rows_idx, cnt)
        out[sec_off[rep, si] + k] = r[rep, k]
        # nibble sections: 8 codes per word, zero past the used bytes
        nibm = np.where(in_use & m[:, None], nib, 0).astype(np.uint32)
        nw_full = (4 * w + 7) // 8
        pad = 8 * nw_full - 4 * w
        if pad:
            nibm = np.concatenate(
                [nibm, np.zeros((n, pad), dtype=np.uint32)], axis=1
            )
        shifts = (4 * np.arange(8, dtype=np.uint32))[None, None, :]
        nib_words_full = (nibm.reshape(n, nw_full, 8) << shifts).sum(
            axis=2, dtype=np.uint32
        )  # disjoint 4-bit lanes: sum == bitwise or
        nwc = np.where(m, (u + 1) // 2, 0)
        k = ranges_from_counts(nwc)
        rep = np.repeat(rows_idx, nwc)
        out[sec_off[rep, si] + k] = nib_words_full[rep, k]
        # escapes: row-major selection preserves per-block byte order
        escm = esc & m[:, None]
        escb = by[escm].astype(np.uint32)
        cnt = escm.sum(axis=1)
        ranks = ranges_from_counts(cnt)
        rep = np.repeat(rows_idx, cnt)
        dst = sec_off[rep, si] + nwc[rep] + ranks // 4
        np.bitwise_or.at(out, dst, escb << (8 * (ranks % 4)).astype(np.uint32))
    return out, starts[:-1].copy(), nwords


def decode_blocks(
    packed: np.ndarray, widths: dict[str, int], dicts: np.ndarray
) -> dict[str, np.ndarray]:
    """Reference (numpy) inverse of :func:`encode_blocks`.

    ``packed`` is (n, cap_words) uint32, each row a payload zero-padded to
    the container's cap. Returns stream -> (n, W_s) uint32 rows whose
    tails past the used words are zero — bit-identical decoder input (the
    masked decode never reads past a block's own bits)."""
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    n, cap = packed.shape
    desc = packed[:, :N_STREAMS].astype(np.int64)
    used = desc & USED_MASK
    modes = (desc >> 20) & 3
    nesc = packed[:, N_STREAMS:DESC_WORDS].astype(np.int64)
    sec = section_words(used, modes, nesc)
    sec_off = DESC_WORDS + np.concatenate(
        [np.zeros((n, 1), dtype=np.int64), np.cumsum(sec, axis=1)[:, :-1]], axis=1
    )
    row = np.arange(n, dtype=np.int64)[:, None]
    out: dict[str, np.ndarray] = {}
    for si, s in enumerate(STREAMS):
        w = int(widths[s])
        u = used[:, si][:, None]
        off = sec_off[:, si][:, None]
        kw = np.arange(w, dtype=np.int64)[None, :]
        raw = np.where(
            kw < u, packed[row, np.clip(off + kw, 0, cap - 1)], np.uint32(0)
        )
        kb = np.arange(4 * w, dtype=np.int64)[None, :]
        nib = (
            packed[row, np.clip(off + kb // 8, 0, cap - 1)]
            >> (4 * (kb % 8)).astype(np.uint32)
        ) & 15
        in_use = kb < 4 * u
        is_esc = (nib == ESCAPE) & in_use
        rank = np.cumsum(is_esc, axis=1) - is_esc  # exclusive prefix rank
        eoff = off + (u + 1) // 2
        escb = (
            packed[row, np.clip(eoff + rank // 4, 0, cap - 1)]
            >> (8 * (rank % 4)).astype(np.uint32)
        ) & 255
        byte = np.where(is_esc, escb, dicts[si][nib]).astype(np.uint32)
        byte = np.where(in_use, byte, np.uint32(0))
        shifts = (8 * np.arange(4, dtype=np.uint32))[None, None, :]
        nib_rows = (byte.reshape(n, w, 4) << shifts).sum(axis=2, dtype=np.uint32)
        out[s] = np.where(
            (modes[:, si] == MODE_NIBBLE)[:, None], nib_rows, raw
        ).astype(np.uint32)
    return out


# --------------------------------------------------------------------------
# binary int64 tables (directory / extent table header sections)
# --------------------------------------------------------------------------

TABLE_MAGIC = b"SGTB"
_RAW64 = 255  # column tag: zigzag deltas need > 32 bits -> raw int64 column


def encode_i64_table(arr: np.ndarray) -> bytes:
    """Compact binary encoding of an (n, c) int64 table: per column, the
    first value raw + zigzag deltas bit-packed at the column's max delta
    width (columns whose deltas exceed 32 bits fall back to raw int64).
    Deterministic bytes for fixed input — golden-tested against drift."""
    arr = np.ascontiguousarray(arr, dtype=np.int64)
    if arr.ndim != 2:
        raise ValueError(f"expected a 2-D table, got shape {arr.shape}")
    n, c = arr.shape
    parts = [TABLE_MAGIC, np.uint32(n).tobytes(), np.uint32(c).tobytes()]
    for j in range(c):
        col = arr[:, j]
        if n == 0:
            parts.append(bytes([0]))
            continue
        deltas = zigzag_encode(np.diff(col))
        width = int(deltas.max()).bit_length() if deltas.size else 0
        if width > 32:
            parts.append(bytes([_RAW64]) + col.tobytes())
            continue
        body = pack_bits(deltas, width)[0].tobytes() if width else b""
        parts.append(bytes([width]) + np.int64(col[0]).tobytes() + body)
    return b"".join(parts)


def decode_i64_table(buf: bytes, n: int, c: int) -> np.ndarray:
    """Inverse of :func:`encode_i64_table` for a table of known shape."""
    mv = memoryview(buf)
    if bytes(mv[:4]) != TABLE_MAGIC:
        raise ValueError("binary table: bad magic")
    hn, hc = (int(x) for x in np.frombuffer(mv[4:12], dtype=np.uint32))
    if (hn, hc) != (n, c):
        raise ValueError(
            f"binary table: shape mismatch (stored {hn}x{hc}, expected {n}x{c})"
        )
    pos = 12
    out = np.empty((n, c), dtype=np.int64)
    for j in range(c):
        width = mv[pos]
        pos += 1
        if n == 0:
            continue
        if width == _RAW64:
            out[:, j] = np.frombuffer(mv[pos : pos + 8 * n], dtype=np.int64)
            pos += 8 * n
            continue
        first = int(np.frombuffer(mv[pos : pos + 8], dtype=np.int64)[0])
        pos += 8
        m = n - 1
        col = np.empty(n, dtype=np.int64)
        col[0] = first
        if width:
            nw = (m * width + 31) // 32
            words = np.frombuffer(mv[pos : pos + 4 * nw], dtype=np.uint32)
            pos += 4 * nw
            starts = width * np.arange(m, dtype=np.int64)
            deltas = zigzag_decode(
                unpack_fields(words, starts, np.full(m, width, dtype=np.int64))
            )
            np.cumsum(deltas, out=col[1:])
            col[1:] += first
        else:
            col[1:] = first
        out[:, j] = col
    if pos != len(buf):
        raise ValueError(
            f"binary table: trailing bytes ({len(buf) - pos}) after {c} columns"
        )
    return out
