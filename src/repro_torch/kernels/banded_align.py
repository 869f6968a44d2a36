"""Batched banded edit-distance DP for the SAGe_Write mapper front-end:
the CUDA kernel's wrapper, its plain torch version and the host wrapper.

The JAX package runs this DP as a jitted ``lax.scan`` over DP rows,
``vmap``-ed across a batch of same-length reads (``_align_scan``; no Pallas
kernel): XLA compiles a chunk's whole L-row scan into one device program.
Eager torch would dispatch ~15 small ops a row, ~2,250 launches for a
1024-lane chunk at L = 150, so on CUDA tensors :func:`align_scan` launches
one hand-written kernel a chunk (``csrc/banded_align.cu``); on CPU tensors
it takes :func:`align_scan_plain`, a transcription of ``_align_scan``.

Bit-for-bit contract: the recurrence of
:func:`repro_torch.genomics.mapper.banded_align` (same INF arithmetic, same
tie-breaking, same band-edge masking); the full move matrix plus the final
DP row go back to the host, where ``repro_torch.genomics.batch_map``
replays the sequential mapper's traceback.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import cuda_lib

I32 = torch.int32
INF = 1 << 20  # matches repro_torch.genomics.mapper.banded_align


def align_scan_plain(reads: torch.Tensor, wins: torch.Tensor, off0: torch.Tensor,
                     wlen: torch.Tensor, *, band: int) -> tuple[torch.Tensor, torch.Tensor]:
    """DP forward pass for a batch of same-length reads, one row at a time.

    reads: (B, L) int32 base codes; wins: (B, Wmax) int32 consensus window
    (values past ``wlen`` are ignored); off0/wlen: (B,) int32 window anchor
    and true window length. Returns (moves (B, L, width) uint8, last row
    (B, width) int32), width = 2*band + 1."""
    B, L = reads.shape
    width = 2 * band + 1
    dev = reads.device
    ar = torch.arange(width, dtype=I32, device=dev)[None, :]
    js0 = (off0.to(I32) - band)[:, None]
    wl = wlen.to(I32)[:, None]
    wins = wins.to(I32)
    inf = torch.tensor(INF, dtype=I32, device=dev)
    zero = torch.tensor(0, dtype=I32, device=dev)
    inf_col = torch.full((B, 1), INF, dtype=I32, device=dev)
    prev = torch.zeros((B, width), dtype=I32, device=dev)  # free start anywhere in band
    moves = torch.empty((B, L, width), dtype=torch.uint8, device=dev)
    for i in range(1, L + 1):
        base = reads[:, i - 1 : i].to(I32)
        j = (i - 1) + js0 + ar  # window col consumed on diag
        valid = (j >= 0) & (j < wl)
        cj = torch.where(valid, j, zero).clamp(max=wins.shape[1] - 1).long()
        match = (torch.gather(wins, 1, cj) == base) & (base < 4) & valid
        diag = prev + (~match).to(I32) + torch.where(valid, zero, inf)
        up = torch.cat([prev[:, 1:], inf_col], dim=1) + 1
        cur = torch.minimum(diag, up)
        mv = (up < diag).to(torch.uint8)
        # left (deletion) via prefix-min, lanes gated to in-window cols
        b_lo = -i - js0 + 1
        b_hi = wl - i - js0
        y = torch.where(ar < b_lo - 1, inf, cur - ar)
        lft = torch.cummin(y, dim=1).values + ar
        allowed = (ar >= b_lo) & (ar <= b_hi)
        lft = torch.where(allowed, lft, cur)
        mv = torch.where(lft < cur, torch.tensor(2, dtype=torch.uint8, device=dev), mv)
        cur = torch.minimum(lft, cur)
        moves[:, i - 1] = mv
        prev = cur
    return moves, prev


@functools.cache
def _lib():
    lib = cuda_lib.lib("banded_align")
    lib.align_scan_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.align_scan_launch.restype = ctypes.c_int
    lib.align_scan_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.align_scan_plan.restype = None
    lib.align_scan_error_string.restype = ctypes.c_char_p
    return lib


PLAN_KEYS = ("grid", "threads", "smem_bytes", "cells_per_thread", "threads_per_lane", "lanes_per_warp",
             "lanes_per_cta", "lane_smem_bytes", "route", "ring_rows", "flush_steps", "window_steps",
             "double_steps")
ROUTES = {1: "ring", 0: "direct", -1: None}


def align_plan(B: int, L: int, band: int, wmax: int) -> dict:
    """How the DP kernel runs ``B`` lanes of ``L`` rows at ``band`` with
    ``wmax``-column windows: grid, threads a CTA, dynamic shared memory,
    cells (band positions) a thread, threads a lane, lanes a warp and a CTA,
    shared bytes a lane, the moves' route ("ring": a shared-memory ring of
    ``ring_rows`` rows flushed every ``flush_steps`` double steps; "direct":
    straight to device memory; None: the kernel does not take the shape),
    double steps a staging window, and double steps in all."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    _lib().align_scan_plan(B, L, band, wmax, out)
    plan = dict(zip(PLAN_KEYS, out))
    plan["route"] = ROUTES[plan["route"]]
    return plan


def align_scan(reads: torch.Tensor, wins: torch.Tensor, off0: torch.Tensor,
               wlen: torch.Tensor, *, band: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`align_scan_plain`'s function: the CUDA kernel for CUDA
    tensors (an anti-diagonal wavefront over each lane's band, one launch
    for the batch), the plain version for CPU tensors."""
    if reads.dim() != 2 or wins.dim() != 2 or off0.dim() != 1 or wlen.dim() != 1:
        raise ValueError("align_scan: reads (B, L), wins (B, Wmax), off0 (B,), wlen (B,)")
    B, L = reads.shape
    if wins.shape[0] != B or off0.shape[0] != B or wlen.shape[0] != B or band < 0:
        raise ValueError(f"align_scan: lane counts differ or band < 0 "
                         f"({tuple(reads.shape)}, {tuple(wins.shape)}, band {band})")
    if any(t.dtype != I32 for t in (reads, wins, off0, wlen)):
        raise ValueError("align_scan: every input must be int32")
    if cuda_lib.on_cpu(reads, wins, off0, wlen):
        cuda_lib.COUNTS["plain:align_scan"] += 1
        return align_scan_plain(reads, wins, off0, wlen, band=band)
    cuda_lib.require_cuda(reads, wins, off0, wlen, name="align_scan")
    wmax = wins.shape[1]
    plan = align_plan(B, L, band, wmax)
    if plan["route"] is None:
        raise ValueError(f"align_scan: the kernel does not take band {band} with "
                         f"{L} rows and {wmax}-column windows ({plan})")
    width = 2 * band + 1
    moves = torch.empty((B, L, width), dtype=torch.uint8, device=reads.device)
    last = torch.empty((B, width), dtype=I32, device=reads.device)
    lib = _lib()
    with torch.cuda.device(reads.device):
        rc = lib.align_scan_launch(
            reads.data_ptr(), wins.data_ptr(), off0.data_ptr(), wlen.data_ptr(),
            moves.data_ptr(), last.data_ptr(), B, L, band, wmax,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(rc, "align_scan", lib.align_scan_error_string)
    cuda_lib.COUNTS["launch:align_scan"] += 1
    return moves, last


def _bucket(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


# Soft cap on one DP call's move-matrix bytes; callers chunk above this so
# long-read batches don't materialize gigabyte intermediates.
MOVES_BUDGET_BYTES = 256 << 20
# Hard cap on lanes per DP call: every full chunk then shares one
# power-of-two bucket shape (full-chunk bucket + at most one tail bucket
# per (L, band)).
MAX_CHUNK_LANES = 1024


def dp_inputs(rows: np.ndarray, cons: np.ndarray, cand: np.ndarray,
              band: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The DP's numpy inputs for lanes ``rows`` (B, L) near ``cand`` (B,):
    (reads int32, windows (B, L + 2*band) int32 gathered with one strided
    fancy index and clipped at the consensus ends, off0 int32, wlen int32)."""
    B, L = rows.shape
    cand = np.asarray(cand, dtype=np.int64)
    ws = np.maximum(cand - band, 0)
    we = np.minimum(int(cons.size), cand + L + band)
    idx = ws[:, None] + np.arange(L + 2 * band, dtype=np.int64)[None, :]
    win = cons[np.clip(idx, 0, cons.size - 1)].astype(np.int32)
    return (np.ascontiguousarray(rows, dtype=np.int32), win,
            (cand - ws).astype(np.int32), (we - ws).astype(np.int32))


def align_rows(
    rows: np.ndarray, cons: np.ndarray, cand: np.ndarray, band: int, *, device="cuda",
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Banded DP for every row of ``rows`` (B, L) near ``cand`` (B,), on
    ``device``.

    Host wrapper: gathers each lane's consensus window, pads the batch to a
    power-of-two lane bucket (padded lanes repeat lane 0), chunks oversized
    batches, runs :func:`align_scan` on ``device`` and returns numpy
    (moves, last_row, ws, off0, wlen). Lanes whose window is empty (W <= 0)
    must be filtered by the caller beforehand."""
    rows = np.ascontiguousarray(rows)
    B, L = rows.shape
    cand = np.asarray(cand, dtype=np.int64)
    ws = np.maximum(cand - band, 0)
    we = np.minimum(int(cons.size), cand + L + band)
    wlen = (we - ws).astype(np.int32)
    width = 2 * band + 1
    chunk = max(1, min(MOVES_BUDGET_BYTES // max(L * width, 1), MAX_CHUNK_LANES))
    moves_parts, last_parts = [], []
    for s in range(0, B, chunk):
        r, win, o0, wl = dp_inputs(rows[s : s + chunk], cons, cand[s : s + chunk], band)
        n = r.shape[0]
        nb = _bucket(n)
        if nb != n:  # pad lanes by repeating lane 0; outputs sliced off below
            pad = nb - n
            r = np.concatenate([r, np.repeat(r[:1], pad, axis=0)])
            win = np.concatenate([win, np.repeat(win[:1], pad, axis=0)])
            o0 = np.concatenate([o0, np.repeat(o0[:1], pad)])
            wl = np.concatenate([wl, np.repeat(wl[:1], pad)])
        mv, last = align_scan(
            *(torch.from_numpy(a).to(device) for a in (r, win, o0, wl)), band=band,
        )
        moves_parts.append(mv.cpu().numpy()[:n])
        last_parts.append(last.cpu().numpy()[:n])
    return (
        np.concatenate(moves_parts) if len(moves_parts) > 1 else moves_parts[0],
        np.concatenate(last_parts) if len(last_parts) > 1 else last_parts[0],
        ws,
        (cand - ws).astype(np.int64),
        wlen.astype(np.int64),
    )
