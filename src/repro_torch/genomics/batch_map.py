"""Batched mapper front-end for SAGe_Write.

``batch_map_reads(mapper, reads)`` produces the same per-read result as
``[mapper.map_read(r) for r in reads]`` — read for read, op for op — but
runs the hot loop batched:

* minimizer seeding and diagonal candidate voting are single numpy passes
  over a length-grouped read matrix (both strands stacked into one batch);
* the banded DP runs for every candidate lane on ``device``: one
  hand-written CUDA kernel launch per lane chunk on the card, its plain
  torch version on the CPU (:mod:`repro_torch.kernels.banded_align`);
* the traceback walks all lanes simultaneously (one vectorized step per
  DP row instead of a Python walk per read).

Reads the batch cannot decide without diverging from the sequential mapper
fall back to ``mapper.map_read`` per read: N-containing reads (escaped
either way), length groups smaller than ``min_batch`` or longer than
``batch_max_len``, and reads whose alignment triggers the chimera-splitting
attempt (``n_edits > 0.12 L`` with a second seed cluster). The fallback IS
the sequential mapper, so equivalence is by construction there; everywhere
else it is asserted by tests/test_torch_encode.py against the JAX
package's batched mapper.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from repro_torch.genomics.mapper import Alignment, ReadMapper, Segment, _merge_ops, _mix

INF = 1 << 20  # matches banded_align


def _batch_kmer_hashes(rows: np.ndarray, k: int) -> np.ndarray:
    """(B, L) base codes -> (B, L-k+1) minimizer hashes (no N handling:
    callers pre-filter N-containing reads to the sequential path)."""
    B, L = rows.shape
    n = L - k + 1
    s = rows.astype(np.int64)
    code = np.zeros((B, n), dtype=np.int64)
    for i in range(k):
        code |= s[:, i : i + n] << (2 * (k - 1 - i))
    return _mix(code)


def _batch_minimizers(rows: np.ndarray, k: int, w: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-lane (k, w) minimizers of every row: returns flattened
    (lane_id, qpos, hash) triples, qpos ascending within each lane —
    exactly the per-read ``minimizers()`` selection (windowed argmin
    positions are non-decreasing, so adjacent dedupe equals ``np.unique``)."""
    h = _batch_kmer_hashes(rows, k)
    B, n = h.shape
    if n <= w:
        # mirrors the sequential n<=w special case only when n == w (one
        # window); callers guard n < w to the fallback path
        lane = np.arange(B, dtype=np.int64)
        qp = np.argmin(h, axis=1).astype(np.int64)
        return lane, qp, h[lane, qp]
    win = sliding_window_view(h, w, axis=1)
    m = win.argmin(axis=2) + np.arange(n - w + 1, dtype=np.int64)[None, :]
    first = np.ones(m.shape, dtype=bool)
    first[:, 1:] = m[:, 1:] != m[:, :-1]
    lane, col = np.nonzero(first)
    lane = lane.astype(np.int64)
    qp = m[lane, col]
    return lane, qp, h[lane, qp]


def _batch_candidates(
    index, rows: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Top seed cluster per lane, replicating ``ReadMapper._candidates``:
    returns (has_candidate (B,), cand_pos (B,), n_clusters (B,))."""
    B, L = rows.shape
    lane, qp, h = _batch_minimizers(rows, index.k, index.w)
    has = np.zeros(B, dtype=bool)
    cand_of = np.zeros(B, dtype=np.int64)
    ncl = np.zeros(B, dtype=np.int64)
    # one lookup for every lane's minimizers — the same hit expansion (and
    # occ_cut semantics) the sequential mapper uses, qidx mapped to lanes
    qi, rpos = index.lookup(h)
    nh = qi.size
    if nh == 0:
        return has, cand_of, ncl
    hit_lane = lane[qi]
    hit_q = qp[qi]
    diag = rpos - hit_q
    order = np.lexsort((diag, hit_lane))  # stable: per-lane diag sort
    ls, d, q = hit_lane[order], diag[order], hit_q[order]
    tol = max(32, int(L * 0.08))
    brk = np.ones(nh, dtype=bool)
    brk[1:] = (ls[1:] != ls[:-1]) | ((d[1:] - d[:-1]) > tol)
    cstart = np.nonzero(brk)[0]
    cend = np.append(cstart[1:], nh)
    votes = cend - cstart
    qlo = np.minimum.reduceat(q, cstart)
    qhi = np.maximum.reduceat(q, cstart)
    # diag is sorted within a cluster, so the median is the middle pair
    med = (d[cstart + (votes - 1) // 2] + d[cstart + votes // 2]) / 2.0
    cand = np.trunc(med).astype(np.int64)  # == int(np.median(...))
    clane = ls[cstart]
    ncl = np.bincount(clane, minlength=B).astype(np.int64)
    # top cluster = lexicographic max of (votes, cand, qlo, qhi), as
    # clusters.sort(reverse=True) orders them in the sequential mapper
    oc = np.lexsort((qhi, qlo, cand, votes, clane))
    cl_s = clane[oc]
    last = np.ones(cl_s.size, dtype=bool)
    last[:-1] = cl_s[1:] != cl_s[:-1]
    has[cl_s[last]] = True
    cand_of[cl_s[last]] = cand[oc[last]]
    return has, cand_of, ncl


def _traceback_batch(
    moves: np.ndarray,
    last: np.ndarray,
    rows: np.ndarray,
    cons: np.ndarray,
    ws: np.ndarray,
    off0: np.ndarray,
    wlen: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """All-lanes traceback of the batched DP (one vectorized step per row
    instead of a per-read Python walk). Returns (ok, pos, nops, opk, opp):
    per-lane op streams in reverse emit order, kind 0=S 1=I1 2=D1."""
    B, L, width = moves.shape
    band = (width - 1) // 2
    js0 = (off0 - band).astype(np.int64)
    b = np.argmin(last, axis=1).astype(np.int64)  # first min, as np.argmin
    dist = last[np.arange(B), b]
    ok = dist < INF
    i = np.full(B, L, dtype=np.int64)
    cap = 2 * L + width + 2
    opk = np.zeros((B, cap), dtype=np.uint8)
    opp = np.zeros((B, cap), dtype=np.int32)
    nops = np.zeros(B, dtype=np.int64)
    active = ok & (i > 0)
    steps = 0
    while True:
        idx = np.nonzero(active)[0]
        if idx.size == 0:
            break
        steps += 1
        if steps > cap:  # unreachable for a valid DP; refuse rather than spin
            ok[idx] = False
            break
        ii, bb = i[idx], b[idx]
        badb = (bb < 0) | (bb >= width)  # off-band walk: impossible when dist<INF
        ok[idx[badb]] = False
        mv = moves[idx, ii - 1, np.clip(bb, 0, width - 1)]
        mv = np.where(badb, np.uint8(0), mv)
        j = (ii - 1) + js0[idx] + bb
        badj = (mv == 0) & ((j < 0) | (j >= wlen[idx]))
        jj = np.where(badj, 0, j)
        base = rows[idx, ii - 1].astype(np.int64)
        sub = (mv == 0) & ~badj & ((cons[ws[idx] + jj] != base) | (base >= 4))
        emit = sub | (mv != 0)
        w_idx = idx[emit]
        opk[w_idx, nops[w_idx]] = mv[emit]  # S shares code 0 with diag
        opp[w_idx, nops[w_idx]] = np.where(mv[emit] == 2, ii[emit], ii[emit] - 1)
        nops[w_idx] += 1
        i[idx] = ii - (mv != 2)
        b[idx] = bb + (mv == 1).astype(np.int64) - (mv == 2).astype(np.int64)
        ok[idx[badj]] = False
        active[idx] = ok[idx] & (i[idx] > 0)
    pos = ws + js0 + b
    ok &= pos >= 0
    return ok, pos, nops, opk, opp


def _lane_alignment(
    row: np.ndarray, pos: int, nops: int, opk: np.ndarray, opp: np.ndarray
) -> Alignment:
    """Materialize one lane's Alignment from its reversed op stream."""
    ops = [
        ("S", int(opp[m]), int(row[opp[m]])) if opk[m] == 0
        else (("I1", int(opp[m])) if opk[m] == 1 else ("D1", int(opp[m])))
        for m in range(nops - 1, -1, -1)
    ]
    return Alignment(
        pos=int(pos), rev=False, ops=_merge_ops(ops, row),
        n_edits=int(nops), read_len=int(row.size),
    )


def batch_map_reads(
    mapper: ReadMapper,
    reads: list[np.ndarray],
    *,
    min_batch: int = 4,
    batch_max_len: int = 4096,
    stats: Optional[dict] = None,
    device="cuda",
) -> list[Optional[list[Segment]]]:
    """Batched equivalent of ``[mapper.map_read(r) for r in reads]``; the
    banded DP runs on ``device`` (``"cuda"`` needs a card)."""
    from repro_torch.core.decode_torch import resolve_device  # genomics must not import core at module scope

    device = resolve_device(device)
    n = len(reads)
    out: list[Optional[list[Segment]]] = [None] * n
    decided = np.zeros(n, dtype=bool)
    groups: dict[int, list[int]] = {}
    for idx, r in enumerate(reads):
        if r.size == 0 or bool(np.any(r == 4)):
            decided[idx] = r.size > 0  # N read: map_read returns None
            if r.size > 0:
                out[idx] = None
            else:
                groups.setdefault(0, []).append(idx)
        else:
            groups.setdefault(int(r.size), []).append(idx)
    n_batched = n_fallback = 0
    fallback: list[int] = []
    for L, idxs in sorted(groups.items()):
        if (
            len(idxs) < min_batch
            or L == 0
            or L > batch_max_len
            or L - mapper.index.k + 1 < mapper.index.w
        ):
            fallback.extend(idxs)
            continue
        n_batched += len(idxs)
        B = len(idxs)
        rows = np.stack([reads[i] for i in idxs]).astype(np.uint8)
        rrows = rows[:, ::-1]
        rrows = np.where(rrows < 4, 3 - rrows, rrows).astype(np.uint8)
        both = np.concatenate([rows, rrows])  # lanes [0,B)=fwd, [B,2B)=rev
        has, cand, ncl = _batch_candidates(mapper.index, both)
        band = mapper._band(L)
        ws0 = np.maximum(cand - band, 0)
        we0 = np.minimum(int(mapper.cons.size), cand + L + band)
        alive = has & (we0 - ws0 > 0) & (L > 0)  # W<=0 or L==0 -> aln None
        lanes = np.nonzero(alive)[0]
        a_ok = np.zeros(2 * B, dtype=bool)
        a_pos = np.zeros(2 * B, dtype=np.int64)
        a_nops = np.zeros(2 * B, dtype=np.int64)
        a_opk = a_opp = None
        lane_slot: dict[int, int] = {}
        if lanes.size:
            from repro_torch.kernels.banded_align import align_rows

            moves, lastrow, ws, off0, wlen = align_rows(
                both[lanes], mapper.cons, cand[lanes], band, device=device
            )
            ok, pos, nops, opk, opp = _traceback_batch(
                moves, lastrow, both[lanes], mapper.cons, ws, off0, wlen
            )
            a_ok[lanes], a_pos[lanes], a_nops[lanes] = ok, pos, nops
            a_opk, a_opp = opk, opp
            lane_slot = {int(g): s for s, g in enumerate(lanes)}
        rate_cap = mapper.max_edit_rate * max(1, L)
        for bidx, ridx in enumerate(idxs):
            fl, rl = bidx, B + bidx  # forward / reverse lanes
            # chimera-splitting attempt -> sequential mapper decides
            if any(
                a_ok[ln] and a_nops[ln] > 0.12 * L and ncl[ln] >= 2
                for ln in (fl, rl)
            ):
                fallback.append(ridx)
                n_batched -= 1
                continue
            if a_ok[fl] and (not a_ok[rl] or a_nops[fl] <= a_nops[rl]):
                win, rev = fl, False
            elif a_ok[rl]:
                win, rev = rl, True
            else:
                decided[ridx] = True  # unmappable -> escape
                continue
            decided[ridx] = True
            if a_nops[win] > rate_cap:
                continue  # out[ridx] stays None
            s = lane_slot[win]
            aln = _lane_alignment(both[win], a_pos[win], int(a_nops[win]), a_opk[s], a_opp[s])
            aln.rev = rev
            out[ridx] = [Segment(0, L, aln)]
    for ridx in fallback:
        out[ridx] = mapper.map_read(reads[ridx])
        decided[ridx] = True
    n_fallback = len(fallback)
    if stats is not None:
        stats["n_batch_mapped"] = stats.get("n_batch_mapped", 0) + n_batched
        stats["n_fallback"] = stats.get("n_fallback", 0) + n_fallback
    assert bool(decided.all())
    return out
