"""Seeded inputs of the banded-alignment DP, shared by the CPU tests (against
the JAX package) and the card tests (kernel against plain version).

Imports only numpy and the port, so it also runs where JAX is absent.

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
CARD_DP_CASES = {**DP_CASES, "l3000_b320": (3000, 320, 64)}  # width 641


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
    L, band, B = CARD_DP_CASES[name]
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
