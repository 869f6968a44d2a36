"""Host-side read mapper used by the SAGe encoder.

Minimizer-seeded, banded-edit-distance verified mapper producing per-read
alignments as (consensus position, strand, edit ops). Compression is off the
analysis critical path (paper footnote 7), so this runs on the host in numpy.

Edit ops are expressed in *read* coordinates, the coordinate system SAGe's
MPA/MPGA streams use (paper Fig. 7):
  ("S", p, base)        substitution at read offset p (read base != consensus)
  ("I", p, bases)       insertion of len(bases) before read offset p; the
                        inserted bases are read[p : p+len]
  ("D", p, length)      deletion of `length` consensus bases between read
                        offsets p-1 and p
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.genomics.synth import revcomp


def kmer_codes(seq: np.ndarray, k: int) -> np.ndarray:
    """Packed 2-bit k-mer codes at every position (N poisons the window)."""
    n = seq.size - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    valid = seq < 4
    s = np.where(valid, seq, 0).astype(np.int64)
    code = np.zeros(seq.size - k + 1, dtype=np.int64)
    for i in range(k):
        code |= s[i : i + n] << (2 * (k - 1 - i))
    ok = np.ones(n, dtype=bool)
    for i in range(k):
        ok &= valid[i : i + n]
    return np.where(ok, code, -1)


def _mix(h: np.ndarray) -> np.ndarray:
    """Cheap invertible hash so minimizers aren't lexicographic (poly-A traps)."""
    u = (h ^ (h >> 13)).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    return ((u ^ (u >> np.uint64(29))) & np.uint64((1 << 62) - 1)).astype(np.int64)


def minimizers(seq: np.ndarray, k: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (hash, position) arrays of (k, w) minimizers of ``seq``."""
    codes = kmer_codes(seq, k)
    if codes.size == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    h = np.where(codes >= 0, _mix(codes), np.int64(1) << 62)
    n = h.size
    if n <= w:
        p = int(np.argmin(h))
        return h[p : p + 1], np.asarray([p], dtype=np.int64)
    from numpy.lib.stride_tricks import sliding_window_view

    win = sliding_window_view(h, w)
    arg = np.argmin(win, axis=1) + np.arange(win.shape[0])
    sel = np.unique(arg)
    hh = h[sel]
    keep = hh < (np.int64(1) << 62)
    return hh[keep], sel[keep].astype(np.int64)


@dataclasses.dataclass
class MinimizerIndex:
    k: int
    w: int
    hashes: np.ndarray  # sorted
    positions: np.ndarray  # co-sorted
    occ_cut: int = 64  # ignore seeds more frequent than this (repeats)

    @classmethod
    def build(cls, ref: np.ndarray, k: int = 13, w: int = 8) -> "MinimizerIndex":
        h, p = minimizers(ref, k, w)
        order = np.argsort(h, kind="stable")
        return cls(k=k, w=w, hashes=h[order], positions=p[order])

    def lookup(self, h: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """For query hashes, return (query_idx, ref_pos) hit pairs.

        Empty-hit paths (no query hashes, an empty index — e.g. built from a
        reference shorter than ``k`` — or zero matches) return empty arrays
        instead of raising, and hit expansion is one cumsum
        (:func:`ranges_from_counts`) rather than a per-count ``np.arange``
        loop."""
        from repro_torch.core.bitio import ranges_from_counts  # function-level: genomics must not import core at module scope

        h = np.asarray(h, dtype=np.int64)
        empty = np.zeros(0, dtype=np.int64)
        if h.size == 0 or self.hashes.size == 0:
            return empty, empty
        lo = np.searchsorted(self.hashes, h, side="left")
        hi = np.searchsorted(self.hashes, h, side="right")
        cnt = np.minimum(hi - lo, self.occ_cut)
        qidx = np.repeat(np.arange(h.size), cnt)
        if qidx.size == 0:
            return empty, empty
        rpos = self.positions[np.repeat(lo, cnt) + ranges_from_counts(cnt)]
        return qidx, rpos


@dataclasses.dataclass
class Alignment:
    pos: int  # consensus start position
    rev: bool
    ops: list[tuple]  # read-coordinate edit ops (see module docstring)
    n_edits: int  # total edited bases (subs + ins bases + del bases)
    read_len: int


@dataclasses.dataclass
class Segment:
    """One aligned piece of a (possibly chimeric) read."""

    read_start: int
    read_end: int
    aln: Alignment


def banded_align(
    read: np.ndarray, cons: np.ndarray, cand_pos: int, band: int
) -> Optional[Alignment]:
    """Banded semi-global edit alignment of ``read`` near ``cand_pos``.

    The consensus window start is free within [cand_pos-band, cand_pos+band];
    unit costs; traceback yields read-coordinate ops. N in the read always
    mismatches (encoder escapes N-reads anyway).
    """
    L = read.size
    ws = max(0, cand_pos - band)
    we = min(cons.size, cand_pos + L + band)
    W = we - ws
    if W <= 0 or L == 0:
        return None
    width = 2 * band + 1
    INF = np.int32(1 << 20)
    # D[i, b] = edit distance of read[:i] vs window ending at j = i-1+b-band+off0
    # where off0 = cand_pos - ws anchors the band on the expected diagonal.
    off0 = cand_pos - ws
    prev = np.zeros(width, dtype=np.int32)  # row i=0: free start anywhere
    moves = np.zeros((L, width), dtype=np.uint8)  # 0=diag,1=up(ins),2=left(del)
    js0 = off0 - band  # col consumed on diag at row i, lane b: (i-1) + js0 + b
    ar = np.arange(width, dtype=np.int32)
    for i in range(1, L + 1):
        j = (i - 1) + js0 + ar  # window col consumed on diag
        valid = (j >= 0) & (j < W)
        cj = np.where(valid, j, 0)
        match = (cons[ws + cj] == read[i - 1]) & (read[i - 1] < 4) & valid
        diag = prev + np.where(match, 0, 1) + np.where(valid, 0, INF)
        # up: insertion (consume read base only): from prev row, band shifts
        up = np.concatenate([prev[1:], [INF]]) + 1
        cur = np.minimum(diag, up)
        mv = np.where(up < diag, 1, 0).astype(np.uint8)
        # left: deletion (consume consensus col j-1 = i+js0+b-1, same row):
        # lft[b] = min(cur[b], lft[b-1]+1) == b + prefix_min(cur[b'] - b')
        # restricted to lanes whose consumed col is inside the window.
        b_lo = -i - js0 + 1  # first lane allowed to receive a left move
        b_hi = W - i - js0  # last allowed lane
        y = cur - ar
        if b_lo > 1:
            y[: min(max(b_lo - 1, 0), width)] = INF
        pm = np.minimum.accumulate(y)
        lft = pm + ar
        allowed = (ar >= b_lo) & (ar <= b_hi)
        lft = np.where(allowed, lft, cur)
        mv = np.where(lft < cur, np.uint8(2), mv)
        cur = np.minimum(lft, cur)
        moves[i - 1] = mv
        prev = cur
    b_end = int(np.argmin(prev))
    dist = int(prev[b_end])
    if dist >= INF:
        return None
    # traceback
    ops: list[tuple] = []
    i, b = L, b_end
    n_edits = 0
    while i > 0:
        mv = moves[i - 1, b]
        if mv == 0:
            j = (i - 1) + js0 + b
            if not (0 <= j < W) :
                return None
            if cons[ws + j] != read[i - 1] or read[i - 1] >= 4:
                ops.append(("S", i - 1, int(read[i - 1])))
                n_edits += 1
            i -= 1
        elif mv == 1:  # insertion: read base consumed, no consensus
            ops.append(("I1", i - 1))
            n_edits += 1
            i -= 1
            b += 1
        else:  # deletion: consensus consumed
            ops.append(("D1", i))
            n_edits += 1
            b -= 1
    start_j = js0 + b  # consensus window col where alignment begins
    pos = ws + start_j
    if pos < 0:
        return None
    ops.reverse()
    merged = _merge_ops(ops, read)
    return Alignment(pos=int(pos), rev=False, ops=merged, n_edits=n_edits, read_len=L)


def _merge_ops(ops: list[tuple], read: np.ndarray) -> list[tuple]:
    """Merge unit ops into blocks: runs of I1 at consecutive read coords ->
    one insertion; runs of D1 at same read coord -> one deletion."""
    merged: list[tuple] = []
    i = 0
    n = len(ops)
    while i < n:
        kind = ops[i][0]
        if kind == "S":
            merged.append(ops[i])
            i += 1
        elif kind == "I1":
            p0 = ops[i][1]
            j = i + 1
            while j < n and ops[j][0] == "I1" and ops[j][1] == ops[j - 1][1] + 1:
                j += 1
            length = j - i
            merged.append(("I", p0, read[p0 : p0 + length].copy()))
            i = j
        else:  # D1
            p0 = ops[i][1]
            j = i + 1
            while j < n and ops[j][0] == "D1" and ops[j][1] == p0:
                j += 1
            merged.append(("D", p0, j - i))
            i = j
    return merged


class ReadMapper:
    """Minimizer + banded-verify mapper with chimera splitting (top-N=3)."""

    def __init__(
        self,
        cons: np.ndarray,
        k: int = 13,
        w: int = 8,
        band_frac: float = 0.12,
        min_band: int = 24,
        max_band: int = 320,
        max_edit_rate: float = 0.42,
        top_n: int = 3,
    ) -> None:
        self.cons = cons
        self.index = MinimizerIndex.build(cons, k=k, w=w)
        self.band_frac = band_frac
        self.min_band = min_band
        self.max_band = max_band
        self.max_edit_rate = max_edit_rate
        self.top_n = top_n

    def _candidates(self, read: np.ndarray, nmax: int = 4) -> list[tuple[int, int, int, int]]:
        """Return [(votes, cand_pos, q_lo, q_hi)] diagonal clusters."""
        h, qp = minimizers(read, self.index.k, self.index.w)
        if h.size == 0:
            return []
        qi, rp = self.index.lookup(h)
        if qi.size == 0:
            return []
        diag = rp - qp[qi]
        order = np.argsort(diag, kind="stable")
        d = diag[order]
        q = qp[qi][order]
        r = rp[order]
        tol = max(32, int(read.size * 0.08))
        clusters: list[tuple[int, int, int, int]] = []
        s = 0
        for e in range(1, d.size + 1):
            if e == d.size or d[e] - d[e - 1] > tol:
                votes = e - s
                qlo, qhi = int(q[s:e].min()), int(q[s:e].max())
                cand = int(np.median(r[s:e] - q[s:e]))
                clusters.append((votes, cand, qlo, qhi))
                s = e
        clusters.sort(reverse=True)
        return clusters[:nmax]

    def _band(self, L: int) -> int:
        return int(np.clip(int(L * self.band_frac), self.min_band, self.max_band))

    def map_read(self, read: np.ndarray) -> Optional[list[Segment]]:
        """Map a read; returns aligned segments (1 normally, ≤top_n if
        chimeric) or None if unmappable (encoder escapes it)."""
        if np.any(read == 4):
            return None  # N-containing: corner case (paper §5.1.4)
        best: Optional[list[Segment]] = None
        best_edits = None
        for rev in (False, True):
            r = revcomp(read) if rev else read
            cands = self._candidates(r)
            if not cands:
                continue
            aln = banded_align(r, self.cons, cands[0][1], self._band(r.size))
            if aln is None:
                continue
            aln.rev = rev
            segs = [Segment(0, r.size, aln)]
            edits = aln.n_edits
            # chimera attempt: if poor, split by seed clusters (top-N)
            if edits > 0.12 * r.size and len(cands) >= 2:
                ch = self._chimeric(r, cands)
                if ch is not None:
                    ch_edits = sum(s.aln.n_edits for s in ch)
                    if ch_edits + 8 * len(ch) < edits:
                        for s in ch:
                            s.aln.rev = rev
                        segs, edits = ch, ch_edits
            if best_edits is None or edits < best_edits:
                best, best_edits = segs, edits
        if best is None:
            return None
        total_len = best[0].aln.read_len if len(best) == 1 else sum(
            s.read_end - s.read_start for s in best
        )
        if best_edits > self.max_edit_rate * max(1, total_len):
            return None
        return best

    def _chimeric(self, read: np.ndarray, cands: list[tuple[int, int, int, int]]) -> Optional[list[Segment]]:
        """Split the read into ≤top_n segments from distinct seed clusters."""
        # greedy: order clusters by read-interval start; keep non-overlapping
        picked: list[tuple[int, int, int]] = []  # (qlo, qhi, cand)
        for votes, cand, qlo, qhi in sorted(cands, key=lambda c: -c[0])[: self.top_n]:
            if qhi - qlo < 30:
                continue
            if all(qhi <= plo or qlo >= phi for plo, phi, _ in picked):
                picked.append((qlo, qhi, cand))
        if len(picked) < 2:
            return None
        picked.sort()
        # expand intervals to tile the read
        bounds = [0]
        for a, b in zip(picked[:-1], picked[1:]):
            bounds.append((a[1] + b[0]) // 2)
        bounds.append(read.size)
        segs: list[Segment] = []
        for (qlo, qhi, cand), lo, hi in zip(picked, bounds[:-1], bounds[1:]):
            sub = read[lo:hi]
            if sub.size < 20:
                return None
            aln = banded_align(sub, self.cons, cand + (lo - qlo), self._band(sub.size))
            if aln is None:
                return None
            segs.append(Segment(lo, hi, aln))
        return segs


@dataclasses.dataclass
class StoreMappingReport:
    """Outcome of mapping a stored dataset through the SAGe_ISP path."""

    total: int = 0
    pruned: int = 0  # exact matches skipped before the mapper (GenStore-EM)
    mapped: int = 0
    unmapped: int = 0


def map_store_reads(
    session,
    name: str,
    consensus: np.ndarray,
    *,
    mapper: Optional[ReadMapper] = None,
    block_range=None,
    blocks_per_fetch: int = 2,
    prefetch: int = 2,
    prune_exact: bool = True,
) -> StoreMappingReport:
    """Map every read of a stored dataset: SAGe_ISP decode stream -> exact
    match pruning (in-storage-filter style) -> banded mapper for survivors.

    ``session`` is a :class:`repro_torch.core.store.SageReadSession`; decode of the
    next block group overlaps mapping of the current one via the stream's
    prefetch buffers."""
    mapper = mapper or ReadMapper(consensus)
    rep = StoreMappingReport()

    def consume(sb) -> None:
        from repro_torch.core.bitio import ranges_from_counts  # genomics must not import core at module scope

        d = sb.data
        # one host copy of each decoded plane (they lie on the store's device)
        toks, n_reads, starts, lens, poss, revs = (
            d[k].cpu().numpy()
            for k in ("tokens", "n_reads", "read_start", "read_len", "read_pos", "read_rev")
        )
        # ---- batched token extraction: one gather for every read's bases ----
        # (block-major read order, identical to the former nested loops)
        nmax = starts.shape[1]
        sel = np.arange(nmax)[None, :] < n_reads[:, None]
        bi, ri = np.nonzero(sel)
        if bi.size == 0:
            return
        st = starts[bi, ri].astype(np.int64)
        ln = lens[bi, ri].astype(np.int64)
        po = poss[bi, ri].astype(np.int64)
        rv = revs[bi, ri].astype(bool)
        off = ranges_from_counts(ln)  # within-read offset of every base
        rd = np.repeat(np.arange(bi.size), ln)  # read id of every base
        flat = toks[np.repeat(bi, ln), np.repeat(st, ln) + off].astype(np.uint8)
        rep.total += int(bi.size)
        pruned = np.zeros(bi.size, dtype=bool)
        if prune_exact:
            ok = (po >= 0) & (po + ln <= consensus.size)
            # forward-strand base at offset j: seq[j] or revcomp(seq)[j]
            ln_b, rv_b, ok_b = ln[rd], rv[rd], ok[rd]
            src = np.repeat(st, ln) + np.where(rv_b, ln_b - 1 - off, off)
            fwd = toks[np.repeat(bi, ln), src].astype(np.uint8)
            fwd = np.where(rv_b & (fwd < 4), 3 - fwd, fwd)
            eq = np.where(ok_b, fwd == consensus[np.where(ok_b, po[rd] + off, 0)], False)
            cs = np.concatenate([[0], np.cumsum(eq)])
            ends = np.cumsum(ln)
            pruned = ok & ((cs[ends] - cs[ends - ln]) == ln)
            rep.pruned += int(pruned.sum())
        seqs = np.split(flat, np.cumsum(ln)[:-1])
        for i in np.nonzero(~pruned)[0]:
            if mapper.map_read(seqs[i]) is not None:
                rep.mapped += 1
            else:
                rep.unmapped += 1

    if block_range is None:
        session.read_stream(
            name, consume, blocks_per_fetch=blocks_per_fetch, prefetch=prefetch
        )
    else:  # explicit range: chunked ranged reads (no wraparound semantics)
        from repro_torch.core.store import StreamBatch

        ids = session.resolve_blocks(name, block_range)
        for i in range(0, len(ids), blocks_per_fetch):
            sub = ids[i : i + blocks_per_fetch]
            consume(StreamBatch(name=name, epoch=0, block_ids=sub,
                                data=session.read(name, sub)))
    return rep


def apply_alignment(aln_pos: int, ops: list[tuple], length: int, cons: np.ndarray) -> np.ndarray:
    """Reconstruct the (forward-strand) read from consensus + ops. Oracle used
    by tests and the reference decoder."""
    out = np.empty(length, dtype=np.uint8)
    ci = aln_pos  # consensus cursor
    ri = 0
    k = 0
    ops = list(ops)
    while ri < length:
        if k < len(ops) and ops[k][1] == ri:
            op = ops[k]
            k += 1
            if op[0] == "S":
                out[ri] = op[2]
                ri += 1
                ci += 1
            elif op[0] == "I":
                bases = op[2]
                out[ri : ri + len(bases)] = bases
                ri += len(bases)
            else:  # D
                ci += op[2]
        else:
            out[ri] = cons[ci]
            ri += 1
            ci += 1
    return out
