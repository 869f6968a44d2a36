"""Vectorized bit-packing utilities (host side, numpy).

All SAGe streams are little-endian bitstreams packed into uint32 words:
bit i of the stream lives in word i//32, bit position i%32. The layout is
chosen so that a 64-bit window ``(w[j+1] << 32) | w[j]`` shifted right by
``off % 32`` exposes any field that starts at bit ``off`` — the exact
double-register trick SAGe's hardware uses (§5.2.1 of the paper), which is
also how the JAX/Pallas decoders extract variable-width fields.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "BitWriter",
    "pack_bits",
    "ranges_from_counts",
    "unpack_fields",
    "unpack_bits",
    "pack_2bit",
    "unpack_2bit",
    "unpack_2bit_batch",
    "zigzag_encode",
    "zigzag_decode",
]


def zigzag_encode(values: np.ndarray) -> np.ndarray:
    """Map signed int64 onto uint64 so small-magnitude values get small
    codes: 0,-1,1,-2,2,... -> 0,1,2,3,4,... (the delta-coding companion of
    :func:`pack_bits`; used by the v2 container's binary table encoding)."""
    v = np.asarray(values, dtype=np.int64)
    # two's-complement wrap via astype keeps the math overflow-free
    return (v.astype(np.uint64) << np.uint64(1)) ^ (v >> np.int64(63)).astype(np.uint64)


def zigzag_decode(codes: np.ndarray) -> np.ndarray:
    """Inverse of :func:`zigzag_encode` (uint64 codes -> int64 values)."""
    u = np.asarray(codes, dtype=np.uint64)
    return ((u >> np.uint64(1)) ^ (np.uint64(0) - (u & np.uint64(1)))).astype(np.int64)


def ranges_from_counts(counts: np.ndarray) -> np.ndarray:
    """``[0..c0), [0..c1), ...`` concatenated — the gather companion of
    ``np.repeat``, built from one cumsum (no per-count ``np.arange`` loop).

    Used by the vectorized encode path (minimizer hit expansion, batched
    read slicing) wherever a variable-length range per row must become one
    flat index array. Empty counts yield an empty array."""
    counts = np.asarray(counts, dtype=np.int64)
    if counts.size == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(counts)
    total = int(ends[-1])
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    return np.arange(total, dtype=np.int64) - np.repeat(ends - counts, counts)


class BitWriter:
    """Append-only little-endian bitstream writer."""

    def __init__(self) -> None:
        self._words: list[int] = []
        self._cur = 0  # current partial word (python int, unbounded)
        self._nbits = 0  # total bits written

    @property
    def nbits(self) -> int:
        return self._nbits

    def write(self, value: int, width: int) -> None:
        """Write ``width`` low bits of ``value``."""
        if width == 0:
            return
        if value < 0 or (width < 63 and value >= (1 << width)):
            raise ValueError(f"value {value} does not fit in {width} bits")
        pos = self._nbits % 32
        self._cur |= int(value) << pos
        self._nbits += width
        while (len(self._words) + 1) * 32 <= self._nbits:
            self._words.append(self._cur & 0xFFFFFFFF)
            self._cur >>= 32

    def write_unary(self, cls: int) -> None:
        """Write a unary class code: ``cls`` ones followed by a zero."""
        self.write((1 << cls) - 1, cls + 1)

    def extend_bits(self, bits: np.ndarray) -> None:
        """Append a 0/1 array as individual bits (vectorized)."""
        bits = np.asarray(bits, dtype=np.uint8)
        for chunk in np.split(bits, range(8192, bits.size, 8192)):
            if chunk.size:
                v = 0
                # pack chunk into a python int (little endian)
                v = int.from_bytes(np.packbits(chunk, bitorder="little").tobytes(), "little")
                self.write(v, int(chunk.size))

    def getvalue(self) -> np.ndarray:
        out = list(self._words)
        if self._nbits % 32 or not out:
            out.append(self._cur & 0xFFFFFFFF)
        return np.asarray(out, dtype=np.uint32)


def pack_bits(values: np.ndarray, widths) -> tuple[np.ndarray, int]:
    """Pack variable-width fields into a uint32 little-endian bitstream.

    Fully vectorized: splits every field into (up to) three byte-aligned
    contributions and scatter-ORs them into a byte buffer. ``widths`` may be
    a per-field array or a single int applied to every field (the common
    fixed-width-stream case — saves the caller a ``np.full`` per block).
    Returns (words_uint32, total_bits).
    """
    values = np.asarray(values, dtype=np.uint64).ravel()
    if np.isscalar(widths) or np.ndim(widths) == 0:
        widths = np.full(values.size, int(widths), dtype=np.int64)
    widths = np.asarray(widths, dtype=np.int64).ravel()
    if values.size == 0:
        return np.zeros(0, dtype=np.uint32), 0
    if np.any(widths < 0) or np.any(widths > 32):
        raise ValueError("widths must be in [0, 32]")
    mask = (np.uint64(1) << widths.astype(np.uint64)) - np.uint64(1)
    values = np.bitwise_and(values, mask)  # no in-place: input may be a caller view
    ends = np.cumsum(widths)
    total = int(ends[-1])
    starts = ends - widths
    nbytes = (total + 7) // 8 + 8
    buf = np.zeros(nbytes, dtype=np.uint64)  # one logical byte per slot
    b0 = starts >> 3
    sh = (starts & 7).astype(np.uint64)
    shifted = values << sh  # fits in 32+7 < 64 bits
    for k in range(5):  # 39 bits -> at most 5 bytes
        np.bitwise_or.at(buf, b0 + k, (shifted >> np.uint64(8 * k)) & np.uint64(0xFF))
    by = buf.astype(np.uint8)
    nwords = (total + 31) // 32
    by4 = np.zeros(nwords * 4, dtype=np.uint8)
    by4[: min(by.size, by4.size)] = by[: by4.size]
    words = by4.view("<u4").copy()
    return words, total


def unpack_fields(words: np.ndarray, starts: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Vectorized extraction of variable-width fields from a uint32 stream."""
    words = np.asarray(words, dtype=np.uint32)
    starts = np.asarray(starts, dtype=np.int64)
    widths = np.asarray(widths, dtype=np.int64)
    w64 = np.zeros(words.size + 2, dtype=np.uint64)
    w64[: words.size] = words
    idx = starts >> 5
    off = (starts & 31).astype(np.uint64)
    window = w64[idx] | (w64[idx + 1] << np.uint64(32))
    vals = window >> off
    # fields up to 32 bits starting at off<=31 always fit in the 64b window
    mask = (np.uint64(1) << widths.astype(np.uint64)) - np.uint64(1)
    return (vals & mask).astype(np.uint64)


def unpack_bits(words: np.ndarray, nbits: int) -> np.ndarray:
    """Expand a packed stream into a 0/1 uint8 array of length nbits."""
    words = np.asarray(words, dtype=np.uint32)
    by = words.view(np.uint8)
    bits = np.unpackbits(by, bitorder="little")
    return bits[:nbits]


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack base codes (0..3) into uint32 words, 16 bases per word."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.size
    pad = (-n) % 16
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
    c = codes.reshape(-1, 16).astype(np.uint32)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    return (c << shifts).sum(axis=1, dtype=np.uint32)


def unpack_2bit(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_2bit (1-D case of :func:`unpack_2bit_batch`)."""
    return unpack_2bit_batch(words, n)


def unpack_2bit_batch(words: np.ndarray, n: int) -> np.ndarray:
    """Batched inverse of pack_2bit: (..., W) packed rows -> (..., n) base
    codes in one broadcasted shift — no Python loop over rows."""
    words = np.asarray(words, dtype=np.uint32)
    shifts = 2 * np.arange(16, dtype=np.uint32)
    c = (words[..., :, None] >> shifts) & np.uint32(3)
    return c.reshape(*words.shape[:-1], -1)[..., :n].astype(np.uint8)
