"""Host (numpy) half of the block decoder: the fixed-shape block-major layout.

These helpers define the per-block row layout that the device decoders read
and that the v2 block-extent container persists verbatim
(:mod:`repro_torch.core.layout`). They are pure numpy, so the container
reader and the encoder can use them without touching torch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.format import D, STREAMS, SageFile

PAD_BASE = 4  # output padding token


def stream_row_words(meta, s: str) -> int:
    """Per-block row width (uint32 words) of stream ``s`` in the fixed-shape
    block-major layout: the worst-case per-block bit count rounded up, plus
    one slack word for the 64-bit extraction window."""
    blk_bits = meta.stream_bits.get(f"blk_{s}", 0)
    return max(2, (blk_bits + 31) // 32 + 1)


def block_row_widths(meta) -> dict[str, int]:
    """Word width of every per-block row (streams + the consensus window) —
    the column layout shared by :func:`prepare_block_arrays` and the v2
    block-extent container."""
    widths = {s: stream_row_words(meta, s) for s in STREAMS}
    widths["cons"] = meta.caps.window // 16
    return widths


def localize_directory(directory: np.ndarray, ids: Optional[np.ndarray] = None) -> np.ndarray:
    """Block-local int32 directory rows for the device decoders.

    ``base_pos`` is rewritten relative to the block's consensus window
    (``base_pos - cons_start``) *before* the int32 cast, so device math stays
    int32-safe regardless of genome size."""
    rows = directory if ids is None else directory[np.asarray(ids, dtype=np.int64)]
    dir32 = np.clip(rows, -(2**31), 2**31 - 1).astype(np.int32)
    dir32[:, D["base_pos"]] = (rows[:, D["base_pos"]] - rows[:, D["cons_start"]]).astype(np.int32)
    return dir32


def _gather_rows(src: np.ndarray, starts: np.ndarray, width: int) -> np.ndarray:
    """(n,) word offsets -> (n, width) rows of ``src``, zero-filled past the
    end of the stream — one fancy-indexed gather, no per-row Python loop."""
    if src.size == 0:  # absent stream (e.g. leng/lena on fixed-length files)
        return np.zeros((starts.size, width), dtype=np.uint32)
    idx = starts[:, None] + np.arange(width, dtype=np.int64)[None, :]
    ok = idx < src.size
    out = src[np.where(ok, idx, 0)]
    out[~ok] = 0
    return out


def prepare_block_arrays(sf: SageFile, ids: Optional[np.ndarray] = None) -> dict[str, np.ndarray]:
    """Fixed-shape block-major host arrays for ``ids`` (all blocks when None).

    Each stream is one strided gather over the flat bitstream (per-block
    word offsets come straight from the directory). This host gather defines
    the per-block row layout the v2 block-extent container persists."""
    directory = sf.directory if ids is None else sf.directory[np.asarray(ids, dtype=np.int64)]
    widths = block_row_widths(sf.meta)
    arrays: dict[str, np.ndarray] = {}
    for s in STREAMS:
        offs = (directory[:, D[f"off_{s}"]] >> 5).astype(np.int64)  # word aligned
        arrays[s] = _gather_rows(
            np.ascontiguousarray(sf.streams[s], dtype=np.uint32), offs, widths[s]
        )
    # consensus windows (2-bit packed, 16 bases/word)
    w0 = (directory[:, D["cons_start"]] // 16).astype(np.int64)
    arrays["cons"] = _gather_rows(
        np.ascontiguousarray(sf.consensus2b, dtype=np.uint32), w0, widths["cons"]
    )
    arrays["dir"] = localize_directory(directory)
    return arrays


def bucket_size(n: int) -> int:
    """Smallest power-of-two bucket holding ``n`` blocks (n >= 1)."""
    if n < 1:
        raise ValueError(f"cannot bucket {n} blocks")
    return 1 << (n - 1).bit_length()


def pad_block_ids(ids: np.ndarray, shards: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Pad ``ids`` to its power-of-two bucket: returns (padded ids, int32
    validity mask). Pad lanes repeat ``ids[0]`` (any in-bounds block works —
    the mask makes their decode output deterministic PAD/zeros).

    With ``shards > 1`` the bucket is computed per shard and the total pads
    to ``bucket(ceil(n / shards)) * shards``, so every lane shard of a
    block-sharded decode holds a power-of-two lane count; ``shards=1`` is
    the single-device rule."""
    ids = np.asarray(ids, dtype=np.int64)
    n = ids.size
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    b = bucket_size(-(-n // shards)) * shards
    padded = np.full(b, ids[0], dtype=np.int64)
    padded[:n] = ids
    valid = (np.arange(b) < n).astype(np.int32)
    return padded, valid
