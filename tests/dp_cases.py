"""Seeded inputs of the banded-alignment DP, shared by the CPU tests (against
the JAX package) and the card tests (kernel against plain version).

Imports only numpy and the port, so it also runs where JAX is absent.

``wavefront_scan`` is a numpy emulation of the DP kernel's own schedule
(csrc/banded_align.cu): an anti-diagonal wavefront with the kernel's
encodings, thread layout, neighbour exchange and ring of moves.

Each case gives (rows (B, L) uint8, consensus uint8, candidate positions
(B,), band), as the batched mapper hands them to ``align_rows``: reads cut
from the consensus with substitutions and indels, a few junk lanes, and
candidates jittered around the true position."""

import zlib

import numpy as np

from repro_torch.kernels.banded_align import _bucket, dp_inputs

# name -> (L, band, lanes)
DP_CASES = {
    "l150_b24": (150, 24, 64),    # Illumina: width 49
    "l37_b24": (37, 24, 16),      # a read shorter than the band's width
    "l1200_b144": (1200, 144, 4),  # long read: width 289
    "bucket5": (150, 24, 5),      # a lane bucket padded from 5 to 8
    "clipped": (150, 24, 12),     # windows clipped at both consensus ends
    "code4": (150, 24, 16),       # reads (and consensus) holding code 4
}
CARD_DP_CASES = {
    **DP_CASES,
    "l3000_b320": (3000, 320, 64),  # width 641
    "l600_b511": (600, 511, 4),     # width 1023, next to the kernel's MAX_WIDTH
}
# the wavefront emulation's cases: DP_CASES and one full lane chunk
WAVEFRONT_CASES = {**DP_CASES, "l150_b24_x1024": (150, 24, 1024)}
_ALL_CASES = {**CARD_DP_CASES, **WAVEFRONT_CASES}


def _mutate(seq: np.ndarray, rng: np.random.Generator, rate: float) -> np.ndarray:
    out = []
    for b in seq:
        u = rng.random()
        if u < rate / 3:
            out.append((int(b) + int(rng.integers(1, 4))) % 4)
        elif u < 2 * rate / 3:
            continue  # deletion
        elif u < rate:
            out.extend([int(b), int(rng.integers(0, 4))])  # insertion
        else:
            out.append(int(b))
    return np.asarray(out, dtype=np.uint8)


def dp_case(name: str):
    """(rows, cons, cand, band) of case ``name``."""
    L, band, B = _ALL_CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    cons = rng.integers(0, 4, max(8_000, 3 * L)).astype(np.uint8)
    if name == "code4":
        cons[rng.random(cons.size) < 0.01] = 4
    pos = rng.integers(0, cons.size - 2 * L, B)
    rows = np.empty((B, L), np.uint8)
    for i, p in enumerate(pos):
        m = _mutate(cons[p : p + 2 * L], rng, 0.04)
        rows[i] = m[:L]
    rows[-2:] = rng.integers(0, 4, (min(2, B), L))  # junk lanes: distance near L
    cand = pos + rng.integers(-band // 2, band // 2 + 1, B)
    if name == "clipped":
        cand[:6] = [-10, 0, 5, cons.size - L - 5, cons.size - L // 2, cons.size - band - L + 3]
        for i in range(6):
            lo = max(int(cand[i]), 0)
            seg = cons[lo : lo + L]
            rows[i, : seg.size] = seg
    if name == "code4":
        rows[rng.random(rows.shape) < 0.02] = 4
    return rows, cons, cand, band


def scan_inputs(name: str):
    """``align_scan``'s numpy inputs of case ``name``, padded to the lane
    bucket by repeating lane 0, as ``align_rows`` pads them; and the band."""
    rows, cons, cand, band = dp_case(name)
    arrs = list(dp_inputs(rows, cons, cand, band))
    pad = _bucket(rows.shape[0]) - rows.shape[0]
    if pad:
        arrs = [np.concatenate([a, np.repeat(a[:1], pad, axis=0)]) for a in arrs]
    return arrs, band


# ------------------------------------------------- the kernel's schedule
INF = 1 << 20
I32_MAX, I32_MIN = 2**31 - 1, -(2**31)
NO_BASE, OFF_WINDOW, LEFT_OFF = 5, 6, (1 << 30) + 1  # the kernel's staged codes
CELLS_PER_THREAD = (2, 4, 8, 12, 16, 24, 32)  # align_scan_plan's choices


def kernel_cells_per_thread(width: int) -> int:
    """The cells a thread of align_scan_plan: the fewest that let one warp
    hold a lane's band."""
    return next(c for c in CELLS_PER_THREAD if -(-width // c) <= 32)


def wavefront_scan(reads, wins, off0, wlen, band: int, cpt: int):
    """``align_scan``'s (moves, last row) computed in the DP kernel's order.

    A thread owns ``cpt`` consecutive positions p of the band; position p is
    column c = p - v, where the v = G*cpt - width virtual positions
    (G threads a lane) sit in front of column 0. In double step d every
    position advances one row: position p holds row i = d - p // 2, its even
    positions first, then its odd ones, so cell (i, p) runs at step
    t = 2i + p and reads its diagonal (i-1, p) made at t-2, its up (i-1, p+1)
    and its left (i, p-1) made at t-1. Per position one value is held (the
    thread's register); the cell is
        diag = val[p] + min(R ^ E, 1) + pen          (pen = E & INF)
        cur0 = min(diag, up + 1),  mv = up + 1 < diag
        lf   = max(left + A, floor[p])               (A = 1, or 2**30 + 1 off the window)
        cur  = min(cur0, lf),      mv = 2 if lf < cur0
    with R the staged read code (0xFE for codes >= 4), E the staged window
    code (INF | 0xFF off the window), floor INT_MAX at column 0 only. The
    last position's up comes from the next lane's first thread, which sends
    INF; position 0's left from the previous lane's last thread (held
    here as the previous lane's value). Rows outside 1..L keep their value
    and store nothing. Moves go to a ring of NR row slots that is flushed
    every F double steps, as the kernel's shared-memory route does."""
    reads, wins = np.asarray(reads, np.int64), np.asarray(wins, np.int64)
    B, L = reads.shape
    W = 2 * band + 1
    wmax = wins.shape[1]
    G = -(-W // cpt)
    P, H = G * cpt, cpt // 2
    v, lag = P - W, P // 2 - 1
    js0 = np.asarray(off0, np.int64) - band
    wl = np.asarray(wlen, np.int64)

    pad_r = P // 2 - 1
    x = np.arange(L + P - 2) - pad_r  # read index i - 1 of each staged byte
    rs = np.full((B, x.size), NO_BASE, np.int64)
    inside = (x >= 0) & (x < L)
    rs[:, inside] = np.where(reads < 4, reads, NO_BASE)[:, x[inside]]
    j = js0[:, None] + (np.arange(L + P - 1) - v)[None, :]  # window column of each staged column
    valid = (j >= 0) & (j < wl[:, None])
    w = np.take_along_axis(wins, np.clip(j, 0, wmax - 1), axis=1)
    code = np.where(valid, np.minimum(w, 4), OFF_WINDOW)
    pen = np.where(valid, 0, INF)
    lft = np.where(valid, 1, LEFT_OFF)
    t_zero = np.where(valid & (j == 0), I32_MIN, I32_MAX)  # the window's first column opens the INF + c cap
    # lanes whose anchor lies a band or more left of the window start take the cap
    t_lane = (js0 <= -W)[:, None]

    p = np.arange(P)
    k, q = p // cpt, p % cpt
    c = p - v
    floor = np.where(c == 0, I32_MAX, I32_MIN)
    t_col = np.where(c >= 2, INF + c, I32_MAX)
    val = np.zeros((B, P), np.int64)
    nr = (lag + 16 + 15) // 16 * 16  # ring rows, a multiple of 16: lag + F <= NR
    f = nr - lag
    ring = np.zeros((B, nr * W), np.uint8)
    moves = np.zeros((B, L, W), np.uint8)
    lanes = np.arange(B)[:, None]
    done, next_flush = 0, f
    for d in range(1, L + lag + 1):
        for half in (0, 1):
            pp = p[half::2]
            m = q[pp] // 2
            i = d - k[pp] * H - m
            ei = d + k[pp] * H + m - 1 + half
            diag = val[:, pp] + (rs[:, pad_r + i - 1] != code[:, ei]) + pen[:, ei]
            up = np.where(pp + 1 < P, val[:, np.minimum(pp + 1, P - 1)], INF) + 1
            left = np.where(pp >= 1, val[:, np.maximum(pp - 1, 0)], np.roll(val[:, P - 1], 1)[:, None])
            lf = np.maximum(left + lft[:, ei], floor[pp])
            lf = np.where(t_lane, np.minimum(lf, np.maximum(t_col[pp], t_zero[:, ei])), lf)
            cur0 = np.minimum(diag, up)
            cur = np.minimum(cur0, lf)
            mv = np.where(cur0 <= lf, np.where(diag <= up, 0, 1), 2).astype(np.uint8)
            ok = (i >= 1) & (i <= L)
            assert max(abs(int(diag.max())), abs(int(lf.max()))) < 2**31, "int32 overflow"
            val[:, pp] = np.where(ok, cur, val[:, pp])
            real = ok & (pp >= v)
            slot = ((i[real] - 1) % nr) * W + pp[real] - v
            ring[lanes, slot[None, :]] = mv[:, real]
        if d == next_flush or d == L + lag:  # rows done..d - lag are complete
            top = min(d - lag, L)
            for r in range(done, top):
                moves[:, r] = ring[:, (r % nr) * W:(r % nr) * W + W]
            done, next_flush = max(done, top), next_flush + (f if d == next_flush else 0)
    return moves, val[:, v:].astype(np.int32)
