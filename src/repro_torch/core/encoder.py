"""SAGe encoder (host side).

Maps each read against the consensus, converts alignments into SAGe's
guide-array streams with dataset-adaptive bit widths, and lays the streams
out in fixed-capacity blocks (the TPU analogue of the paper's per-channel
partitioning).

Two pipelines produce bit-identical containers:

* the **batched** default: mapping runs through the vectorized front-end
  (:mod:`repro_torch.genomics.batch_map`, whose banded DP is one CUDA
  kernel launch per lane chunk on the card), stream values live in one
  columnar :class:`SegTable`, every block's streams pack with one
  :func:`pack_bits` pass per stream, and losslessness is checked by
  round-tripping the encoded blocks through the bucketed decoder (the
  block-decode kernel on the card);
* the **reference**: the read-at-a-time walk (``batched=False``, pure
  numpy, no device), kept as the correctness baseline.

Compression stays on the host CPU+accelerator side of SAGe_Write — it is
off the analysis critical path (paper footnote 7) — but batching it keeps
ingest from capping the serving path at scale.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import tuning
from repro_torch.core.bitio import pack_2bit, pack_bits, ranges_from_counts
from repro_torch.core.format import NDIR, STREAMS, BlockCaps, D, SageFile, SageMeta
from repro_torch.genomics.mapper import ReadMapper
from repro_torch.genomics.synth import ReadSet, revcomp

_SENT = 1 << 62  # "no position yet" sentinel (matches _Block.min_pos)


@dataclasses.dataclass
class SegRecord:
    """One segment, fully resolved into stream values."""

    pos: int
    length: int
    rev: bool
    cont: bool
    corner: bool
    # per-mismatch (parallel lists)
    mp: list[int]  # read-coordinate of each op
    mbb: list[int]  # 2-bit base-or-signal
    kinds: list[str]  # "S" | "I" | "D"
    ilen: list[int]  # indel block length (for I/D ops; aligned with indel order)
    ibases: list[np.ndarray]  # inserted bases per I op
    esc: Optional[np.ndarray] = None  # corner read content (codes 0..4)


class EscapeRead(Exception):
    pass


def _segment_records(read: np.ndarray, segs, cons: np.ndarray) -> list[SegRecord]:
    """Convert mapper segments into SegRecords (raises EscapeRead on any
    condition the compact encoding cannot express)."""
    rev = segs[0].aln.rev
    r = revcomp(read) if rev else read
    out: list[SegRecord] = []
    for si, s in enumerate(segs):
        aln = s.aln
        L = s.read_end - s.read_start
        mp: list[int] = []
        mbb: list[int] = []
        kinds: list[str] = []
        ilen: list[int] = []
        ibases: list[np.ndarray] = []
        prev_p = 0
        for op in aln.ops:
            kind, p = op[0], int(op[1])
            if p < prev_p:
                raise EscapeRead("ops out of order")
            prev_p = p
            if kind == "S":
                base = int(op[2])
                if base >= 4:
                    raise EscapeRead("N base")
                mp.append(p)
                kinds.append("S")
                mbb.append(base)
            elif kind == "I":
                bases = np.asarray(op[2], dtype=np.uint8)
                if bases.size < 1 or bases.size > 255 or np.any(bases >= 4):
                    raise EscapeRead("bad insertion")
                mp.append(p)
                kinds.append("I")
                ilen.append(int(bases.size))
                ibases.append(bases)
                mbb.append(-1)  # filled below (signal)
            else:  # D
                length = int(op[2])
                if length < 1 or length > 255:
                    raise EscapeRead("bad deletion")
                mp.append(p)
                kinds.append("D")
                ilen.append(length)
                mbb.append(-1)
        rec = SegRecord(
            pos=aln.pos, length=L, rev=bool(rev), cont=si > 0, corner=False,
            mp=mp, mbb=mbb, kinds=kinds, ilen=ilen, ibases=ibases,
        )
        _fill_codes(rec, cons)
        out.append(rec)
    return out


def _fill_codes(rec: SegRecord, cons: np.ndarray) -> None:
    """Compute the 2-bit mbb code for every mismatch record.

    TPU adaptation of the paper's merged base/type trick (§5.1.2), at
    identical bit cost: a substitution base is one of only THREE bases
    (it must differ from the consensus base), so we store its *rank*
    among the non-consensus bases (0..2); code 3 marks an indel. The
    paper instead stores the base and signals indels by equality with
    the consensus — sequential to detect; the rank code is detectable
    in parallel (code==3) while still costing exactly 2 bits per
    mismatch and 2+1+1 bits per indel, bit-for-bit the paper's sizes.
    """
    cursor = rec.pos
    prev_p = 0
    ii = 0  # index into ilen (all indels)
    bi = 0  # index into ibases (insertions only)
    for m, (p, k) in enumerate(zip(rec.mp, rec.kinds)):
        cursor += p - prev_p  # matched bases between ops consume 1:1
        prev_p = p
        if cursor >= cons.size:
            raise EscapeRead("cursor oob")
        if k == "S":
            base = rec.mbb[m]
            cb = int(cons[cursor])
            if cb == base:
                raise EscapeRead("sub equals consensus")
            rec.mbb[m] = base - (1 if base > cb else 0)  # rank among != cb
            cursor += 1
            prev_p = p + 1
        elif k == "I":
            rec.mbb[m] = 3
            # inserted bases consume read coords without consensus:
            prev_p = p + len(rec.ibases[bi])
            ii += 1
            bi += 1
        else:  # D
            rec.mbb[m] = 3
            cursor += rec.ilen[ii]
            ii += 1


def _verify(read: np.ndarray, recs: list[SegRecord], cons: np.ndarray) -> bool:
    """Re-derive the read from its records using decode semantics (rank
    codes + kinds), independent of the mapper's op list."""
    parts = []
    for rec in recs:
        seg = np.empty(rec.length, dtype=np.uint8)
        cursor = rec.pos
        ri = 0
        ii = 0  # indel index (ilen)
        bi = 0  # insertion index (ibases)
        prev_p = 0
        for m, p in enumerate(rec.mp):
            while ri < p:  # matched bases
                seg[ri] = cons[cursor]
                ri += 1
                cursor += 1
            code = rec.mbb[m]
            if code < 3:  # substitution: rank -> base
                cb = int(cons[cursor])
                seg[ri] = code + (1 if code >= cb else 0)
                ri += 1
                cursor += 1
            else:
                ln = rec.ilen[ii]
                if rec.kinds[m] == "I":
                    seg[ri : ri + ln] = rec.ibases[bi]
                    ri += ln
                    bi += 1
                else:
                    cursor += ln
                ii += 1
        while ri < rec.length:
            seg[ri] = cons[cursor]
            ri += 1
            cursor += 1
        parts.append(seg)
    full = np.concatenate(parts) if len(parts) > 1 else parts[0]
    if recs[0].rev:
        full = revcomp(full)
    return bool(np.array_equal(full, read))


@dataclasses.dataclass
class _Block:
    recs: list[SegRecord] = dataclasses.field(default_factory=list)
    n_reads: int = 0
    n_mism: int = 0
    n_indel: int = 0
    n_multi: int = 0
    n_insb: int = 0
    n_corner: int = 0
    n_escb: int = 0
    n_tokens: int = 0
    min_pos: int = 1 << 62
    max_end: int = 0

    def fits_more(self, token_target: int, window_target: int) -> bool:
        if self.n_tokens >= token_target:
            return False
        if self.max_end and self.min_pos < (1 << 62):
            if self.max_end - (self.min_pos & ~15) >= window_target:
                return False
        return True

    def add_read(self, recs: list[SegRecord]) -> None:
        for rec in recs:
            self.recs.append(rec)
            self.n_tokens += rec.length
            if rec.corner:
                self.n_corner += 1
                self.n_escb += rec.length
                continue
            self.n_mism += len(rec.mp)
            total_del = 0
            ii = 0
            for k in rec.kinds:
                if k in ("I", "D"):
                    ln = rec.ilen[ii]
                    ii += 1
                    self.n_indel += 1
                    if ln > 1:
                        self.n_multi += 1
                    if k == "I":
                        self.n_insb += ln
                    else:
                        total_del += ln
            self.min_pos = min(self.min_pos, rec.pos)
            self.max_end = max(self.max_end, rec.pos + rec.length + total_del)
        self.n_reads += 1


class SageEncoder:
    """End-to-end SAGe compression of a read set against a consensus.

    ``batched=True`` (default) routes SAGe_Write through the vectorized
    pipeline (batched seeding -> banded DP on ``device`` -> columnar pack
    -> decode-based verify on ``device``); ``batched=False`` is the
    sequential reference, pure numpy. Both produce the :class:`SageFile`
    of the JAX package's encoder at every ``opt_level``.

    ``device`` (default ``"cuda"``) is resolved only when the batched path
    runs: without a card it raises unless the caller passes ``"cpu"``
    (the plain torch versions); it never falls back to the sequential path.

    ``verify`` controls the batched path's losslessness check: True
    round-trips every encoded block through the bucketed decoder and
    demotes any mismatching read to the escape stream (the batch analogue
    of the reference's per-read ``_verify`` walk); False trusts the mapper.
    The reference path always walks per read."""

    def __init__(
        self,
        consensus: np.ndarray,
        token_target: int = 65536,
        window_target: int = 1 << 20,
        mapper: Optional[ReadMapper] = None,
        max_classes: int = 4,
        batched: bool = True,
        verify: bool = True,
        batch_min: int = 4,
        batch_max_len: int = 4096,
        device="cuda",
    ) -> None:
        self.cons = np.asarray(consensus, dtype=np.uint8)
        self.token_target = token_target
        self.window_target = window_target
        self.mapper = mapper or ReadMapper(self.cons)
        self.max_classes = max_classes
        self.batched = batched
        self.verify = verify
        self.batch_min = batch_min
        self.batch_max_len = batch_max_len
        self.device = device
        self.stats: dict[str, Union[int, float]] = {}

    # ------------------------------------------------------------------ map
    def _map_all(self, reads: list[np.ndarray]) -> tuple[list[list[SegRecord]], int]:
        mapped: list[tuple[int, list[SegRecord]]] = []
        corners: list[list[SegRecord]] = []
        n_escaped = 0
        for read in reads:
            recs: Optional[list[SegRecord]] = None
            segs = self.mapper.map_read(read)
            if segs is not None:
                try:
                    recs = _segment_records(read, segs, self.cons)
                    if not _verify(read, recs, self.cons):
                        recs = None
                except EscapeRead:
                    recs = None
            if recs is None:
                n_escaped += 1
                esc = SegRecord(
                    pos=0, length=read.size, rev=False, cont=False, corner=True,
                    mp=[], mbb=[], kinds=[], ilen=[], ibases=[], esc=read,
                )
                corners.append([esc])
            else:
                mapped.append((recs[0].pos, recs))
        mapped.sort(key=lambda t: t[0])
        ordered = [recs for _, recs in mapped] + corners
        self.stats["n_escaped"] = n_escaped
        return ordered, n_escaped

    # ---------------------------------------------------------------- block
    def _blockize(self, per_read: list[list[SegRecord]]) -> list[_Block]:
        blocks: list[_Block] = []
        cur = _Block()
        for recs in per_read:
            if cur.recs and not cur.fits_more(self.token_target, self.window_target):
                blocks.append(cur)
                cur = _Block()
            cur.add_read(recs)
        if cur.recs:
            blocks.append(cur)
        return blocks

    # ----------------------------------------------------------------- pack
    def encode(self, rs: ReadSet, opt_level: int = 4) -> SageFile:
        """opt_level reproduces the paper's Fig.17 ablation:
          0: raw fixed-width fields (no optimization)
          1: + adaptive matching-position deltas (§5.1.3)
          2: + adaptive mismatch positions/counts/lengths (§5.1.1)
          3: + merged base/type rank coding + single-base indel flag (§5.1.2)
          4: + corner-case escapes tuned (full SAGe; default)"""
        if self.batched:
            return self._encode_batched(rs, opt_level)
        return self._encode_reference(rs, opt_level)

    def _encode_reference(self, rs: ReadSet, opt_level: int = 4) -> SageFile:
        """Sequential reference pipeline (read-at-a-time map + verify walk,
        per-record stream accumulation). Retained as the bit-exactness
        baseline; the batched path must reproduce its output exactly."""
        per_read, _ = self._map_all(rs.reads)
        blocks = self._blockize(per_read)

        # ---- pass B: gather values for class tuning (global, per paper) ----
        all_map: list[int] = []
        all_len: list[int] = []
        all_cnt: list[int] = []
        all_mp: list[int] = []
        lengths = [rec.length for b in blocks for rec in b.recs]
        fixed_len = lengths[0] if lengths and all(l == lengths[0] for l in lengths) else 0
        for b in blocks:
            base_pos = None
            first_pos = 0
            for rec in b.recs:
                if rec.cont:
                    d = rec.pos - first_pos
                    all_map.append((d << 1) ^ (d >> 63) if d >= 0 else ((-d) << 1) - 1)
                else:
                    if rec.corner:
                        all_map.append(0)
                    else:
                        if base_pos is None:
                            base_pos = rec.pos
                        all_map.append(rec.pos - base_pos)
                        base_pos = rec.pos
                        first_pos = rec.pos
                if not fixed_len:
                    all_len.append(rec.length)
                all_cnt.append(len(rec.mp))
                prev = 0
                for p in rec.mp:
                    all_mp.append(p - prev)
                    prev = p
        def fixed_for(vals, width):
            mx = int(max(vals)) if len(vals) else 0
            return (max(width, mx.bit_length()),)

        classes = {
            "map": tuning.tune_classes(np.asarray(all_map, dtype=np.uint64), self.max_classes)
            if opt_level >= 1 else fixed_for(all_map, 32),
            "len": (tuning.tune_classes(np.asarray(all_len, dtype=np.uint64), self.max_classes) if not fixed_len else (8,))
            if opt_level >= 2 else fixed_for(all_len, 16),
            "cnt": tuning.tune_classes(np.asarray(all_cnt, dtype=np.uint64), self.max_classes)
            if opt_level >= 2 else fixed_for(all_cnt, 16),
            "mp": tuning.tune_classes(np.asarray(all_mp, dtype=np.uint64), self.max_classes)
            if opt_level >= 2 else fixed_for(all_mp, 16),
        }

        # ---- pass C: pack streams block by block (word-aligned blocks) ----
        words: dict[str, list[np.ndarray]] = {s: [] for s in STREAMS}
        bitpos: dict[str, int] = {s: 0 for s in STREAMS}
        directory = np.zeros((len(blocks), NDIR), dtype=np.int64)
        caps = BlockCaps(0, 0, 0, 0, 0, 0, 0, 16)
        block_bits: dict[str, int] = {s: 0 for s in STREAMS}

        for bi, b in enumerate(blocks):
            row = directory[bi]
            vals = _BlockValues()
            base_pos = None
            for rec in b.recs:
                vals.add(rec, fixed_len)
                if not rec.cont and not rec.corner and base_pos is None:
                    base_pos = rec.pos
                    row[D["base_pos"]] = rec.pos
            cons_start = (b.min_pos if b.min_pos < (1 << 62) else 0) & ~15
            span = max(b.max_end - cons_start, 16)
            row[D["n_segs"]] = len(b.recs)
            row[D["n_reads"]] = b.n_reads
            row[D["n_mism"]] = b.n_mism
            row[D["n_indel"]] = b.n_indel
            row[D["n_multi"]] = b.n_multi
            row[D["n_insb"]] = b.n_insb
            row[D["n_corner"]] = b.n_corner
            row[D["n_escb"]] = b.n_escb
            row[D["n_tokens"]] = b.n_tokens
            row[D["cons_start"]] = cons_start
            row[D["cons_span"]] = span

            packed = vals.pack(classes, opt_level=opt_level)
            for s in STREAMS:
                row[D[f"off_{s}"]] = bitpos[s]
                w, nbits = packed[s]
                words[s].append(w)
                bitpos[s] += w.size * 32  # word-aligned blocks
                block_bits[s] = max(block_bits[s], nbits)

            caps.segs = max(caps.segs, len(b.recs))
            caps.mism = max(caps.mism, b.n_mism)
            caps.indel = max(caps.indel, b.n_indel)
            caps.multi = max(caps.multi, b.n_multi)
            caps.insb = max(caps.insb, b.n_insb)
            caps.escb = max(caps.escb, b.n_escb)
            caps.tokens = max(caps.tokens, b.n_tokens)
            caps.window = max(caps.window, (span + 15) & ~15)

        streams = {
            s: (np.concatenate(words[s]) if words[s] else np.zeros(0, dtype=np.uint32))
            for s in STREAMS
        }
        meta = SageMeta(
            version=1,
            read_kind=rs.kind,
            n_reads=len(rs.reads),
            n_segments=sum(len(b.recs) for b in blocks),
            n_blocks=len(blocks),
            fixed_read_len=fixed_len,
            cons_len=int(self.cons.size),
            caps=caps,
            classes=classes,
            stream_bits={s: int(bitpos[s]) for s in STREAMS},
        )
        meta.stream_bits.update({f"blk_{s}": int(block_bits[s]) for s in STREAMS})
        return SageFile(
            meta=meta,
            consensus2b=pack_2bit(self.cons),
            directory=directory,
            streams=streams,
        )

    # ------------------------------------------------------------- batched
    def _map_all_batched(self, reads: list[np.ndarray], device: torch.device) -> list[Optional[list[SegRecord]]]:
        """Batched mapping front-end -> per-read SegRecords (None = escape);
        the banded DP runs on ``device``. Unlike the reference ``_map_all``
        there is no per-read verify walk here; losslessness is checked in
        batch by decode round-trip."""
        from repro_torch.genomics.batch_map import batch_map_reads

        map_stats: dict = {}
        segs_list = batch_map_reads(
            self.mapper, reads, min_batch=self.batch_min,
            batch_max_len=self.batch_max_len, stats=map_stats, device=device,
        )
        self.stats.update(map_stats)
        out: list[Optional[list[SegRecord]]] = []
        for read, segs in zip(reads, segs_list):
            recs: Optional[list[SegRecord]] = None
            if segs is not None:
                try:
                    recs = _segment_records(read, segs, self.cons)
                except EscapeRead:
                    recs = None
            out.append(recs)
        return out

    def _ordered_records(
        self,
        reads: list[np.ndarray],
        recs_list: list[Optional[list[SegRecord]]],
        escaped: set[int],
    ) -> tuple[list[int], list[list[SegRecord]]]:
        """File order: mapped reads stably sorted by first-segment position,
        then escapes in read order (exactly the reference ``_map_all``).
        Returns (perm: file order -> read index, per-read records)."""
        mapped = [
            (int(recs_list[i][0].pos), i)
            for i in range(len(reads))
            if i not in escaped and recs_list[i] is not None
        ]
        mapped.sort(key=lambda t: t[0])
        esc_ids = [i for i in range(len(reads)) if i in escaped or recs_list[i] is None]
        perm = [i for _, i in mapped] + esc_ids
        per_read = [recs_list[i] for _, i in mapped] + [
            [SegRecord(
                pos=0, length=reads[i].size, rev=False, cont=False, corner=True,
                mp=[], mbb=[], kinds=[], ilen=[], ibases=[], esc=reads[i],
            )]
            for i in esc_ids
        ]
        return perm, per_read

    def _blockize_table(self, tbl: "SegTable") -> np.ndarray:
        """Assign a block id to every read — the reference ``_blockize`` /
        ``fits_more`` decision replayed over precomputed per-read aggregates
        (O(1) Python per read; all per-segment math is vectorized)."""
        starts = tbl.read_seg_start
        R = starts.size - 1
        if R == 0:
            return np.zeros(0, dtype=np.int64)
        csL = np.concatenate([[0], np.cumsum(tbl.length)])
        tok_r = (csL[starts[1:]] - csL[starts[:-1]]).tolist()
        nseg_r = np.diff(starts).tolist()
        pos_nc, end_nc = tbl.window_bounds()
        minp_r = np.minimum.reduceat(pos_nc, starts[:-1]).tolist()
        maxe_r = np.maximum.reduceat(end_nc, starts[:-1]).tolist()
        blk = np.zeros(R, dtype=np.int64)
        bid, ntok, nsegs, minp, maxe = 0, 0, 0, _SENT, 0
        for r in range(R):
            if nsegs:
                fits = ntok < self.token_target
                if fits and maxe and minp < _SENT and maxe - (minp & ~15) >= self.window_target:
                    fits = False
                if not fits:
                    bid += 1
                    ntok, nsegs, minp, maxe = 0, 0, _SENT, 0
            blk[r] = bid
            ntok += tok_r[r]
            nsegs += nseg_r[r]
            minp = min(minp, minp_r[r])
            maxe = max(maxe, maxe_r[r])
        return blk

    def _pack_table(
        self, tbl: "SegTable", blk_read: np.ndarray, opt_level: int, rs: ReadSet
    ) -> SageFile:
        """Vectorized passes B+C of the reference encoder: compute every
        stream's value array once (columnar, whole dataset), tune classes on
        those arrays, then emit each block with one ``pack_bits`` call per
        stream — no per-mismatch (or per-segment) Python anywhere."""
        S, M = tbl.pos.size, tbl.mp.size
        nb = int(blk_read.max()) + 1 if blk_read.size else 0
        blk_seg = blk_read[tbl.read_id] if S else np.zeros(0, dtype=np.int64)
        lengths = tbl.length
        fixed_len = (
            int(lengths[0]) if S and bool(np.all(lengths == lengths[0])) else 0
        )

        # ---- stream value arrays (global, segment/mismatch order) --------
        map_val = np.zeros(S, dtype=np.int64)
        anchor = ~tbl.cont & ~tbl.corner
        a_idx = np.nonzero(anchor)[0]
        if a_idx.size:
            prev = np.concatenate([[0], tbl.pos[a_idx[:-1]]])
            first = np.ones(a_idx.size, dtype=bool)
            first[1:] = blk_seg[a_idx][1:] != blk_seg[a_idx][:-1]
            map_val[a_idx] = np.where(first, 0, tbl.pos[a_idx] - prev)
        c_idx = np.nonzero(tbl.cont)[0]
        if c_idx.size:
            first_pos = tbl.pos[tbl.read_seg_start[tbl.read_id[c_idx]]]
            d = tbl.pos[c_idx] - first_pos
            map_val[c_idx] = np.where(d >= 0, d << 1, ((-d) << 1) - 1)  # zigzag
        seg_m_end = np.cumsum(tbl.n_mism)
        seg_m_start = seg_m_end - tbl.n_mism
        m_first = np.zeros(M, dtype=bool)
        m_first[seg_m_start[tbl.n_mism > 0]] = True
        mp_prev = np.concatenate([[0], tbl.mp[:-1]]) if M else np.zeros(0, np.int64)
        mp_delta = tbl.mp - np.where(m_first, 0, mp_prev)
        rfl = tbl.rev.astype(np.int64) | (tbl.cont.astype(np.int64) << 1) | (
            tbl.corner.astype(np.int64) << 2
        )
        ind = np.nonzero(tbl.is_ind)[0]
        ilen_i = tbl.ilen[ind]
        idg = tbl.is_ins[ind].astype(np.int64) | ((ilen_i > 1).astype(np.int64) << 1)
        idl_multi = ilen_i[ilen_i > 1]

        # ---- class tuning (pass B; identical value multisets) ------------
        def fixed_for(vals: np.ndarray, width: int) -> tuple[int, ...]:
            mx = int(vals.max()) if vals.size else 0
            return (max(width, mx.bit_length()),)

        len_vals = lengths if not fixed_len else np.zeros(0, dtype=np.int64)
        classes = {
            "map": tuning.tune_classes(map_val.astype(np.uint64), self.max_classes)
            if opt_level >= 1 else fixed_for(map_val, 32),
            "len": (tuning.tune_classes(len_vals.astype(np.uint64), self.max_classes) if not fixed_len else (8,))
            if opt_level >= 2 else fixed_for(len_vals, 16),
            "cnt": tuning.tune_classes(tbl.n_mism.astype(np.uint64), self.max_classes)
            if opt_level >= 2 else fixed_for(tbl.n_mism, 16),
            "mp": tuning.tune_classes(mp_delta.astype(np.uint64), self.max_classes)
            if opt_level >= 2 else fixed_for(mp_delta, 16),
        }
        guide_vals = {"map": map_val, "len": len_vals, "cnt": tbl.n_mism, "mp": mp_delta}
        guide_cls = {
            k: tuning.assign_classes(v.astype(np.uint64), classes[k])
            for k, v in guide_vals.items()
        }
        guide_w = {k: np.asarray(classes[k], dtype=np.int64) for k in classes}

        # ---- per-block boundaries (cumsums over the columnar arrays) -----
        sb = np.searchsorted(blk_seg, np.arange(nb + 1))  # seg bounds/block
        def cs(x):
            return np.concatenate([[0], np.cumsum(x)])

        csm = cs(tbl.n_mism)[sb]  # mismatch bound at each block edge
        csi = cs(tbl.n_indel)[sb]
        csu = cs(tbl.n_multi)[sb]
        csp = cs(tbl.n_insb)[sb]
        cse = cs(tbl.n_escb)[sb]
        cst = cs(tbl.length)[sb]
        # len-guide bounds: len stream has one entry per segment (or none)
        pos_nc, end_nc = tbl.window_bounds()
        n_reads_b = np.bincount(blk_read, minlength=nb).astype(np.int64)
        base_pos_b = np.zeros(nb, dtype=np.int64)  # first anchor pos per block
        if a_idx.size:
            ab, afirst = np.unique(blk_seg[a_idx], return_index=True)
            base_pos_b[ab] = tbl.pos[a_idx[afirst]]

        directory = np.zeros((nb, NDIR), dtype=np.int64)
        caps = BlockCaps(0, 0, 0, 0, 0, 0, 0, 16)
        words: dict[str, list[np.ndarray]] = {s: [] for s in STREAMS}
        bitpos: dict[str, int] = {s: 0 for s in STREAMS}
        block_bits: dict[str, int] = {s: 0 for s in STREAMS}
        mbb_w = 2 if opt_level >= 3 else 4
        mbb_u64 = tbl.mbb.astype(np.uint64)
        idg_u64 = idg.astype(np.uint64)
        idl_u64 = idl_multi.astype(np.uint64)
        ibs_u64 = tbl.ibases.astype(np.uint64)
        rfl_u64 = rfl.astype(np.uint64)
        esc_u64 = tbl.esc.astype(np.uint64)
        gvals_u64 = {k: v.astype(np.uint64) for k, v in guide_vals.items()}

        for bi in range(nb):
            s0, s1 = int(sb[bi]), int(sb[bi + 1])
            m0, m1 = int(csm[bi]), int(csm[bi + 1])
            i0, i1 = int(csi[bi]), int(csi[bi + 1])
            u0, u1 = int(csu[bi]), int(csu[bi + 1])
            p0, p1 = int(csp[bi]), int(csp[bi + 1])
            e0, e1 = int(cse[bi]), int(cse[bi + 1])
            row = directory[bi]
            minp = int(pos_nc[s0:s1].min())
            maxe = int(end_nc[s0:s1].max())
            cons_start = (minp if minp < _SENT else 0) & ~15
            span = max(maxe - cons_start, 16)
            row[D["base_pos"]] = int(base_pos_b[bi])
            row[D["n_segs"]] = s1 - s0
            row[D["n_reads"]] = int(n_reads_b[bi])
            row[D["n_mism"]] = m1 - m0
            row[D["n_indel"]] = i1 - i0
            row[D["n_multi"]] = u1 - u0
            row[D["n_insb"]] = p1 - p0
            row[D["n_corner"]] = int(tbl.corner[s0:s1].sum())
            row[D["n_escb"]] = e1 - e0
            row[D["n_tokens"]] = int(cst[bi + 1] - cst[bi])
            row[D["cons_start"]] = cons_start
            row[D["cons_span"]] = span

            packed: dict[str, tuple[np.ndarray, int]] = {}
            for kind, (g_name, a_name), (k0, k1) in (
                ("map", ("mapg", "mapa"), (s0, s1)),
                ("len", ("leng", "lena"), (0, 0) if fixed_len else (s0, s1)),
                ("cnt", ("cntg", "cnta"), (s0, s1)),
                ("mp", ("mpg", "mpa"), (m0, m1)),
            ):
                cls = guide_cls[kind][k0:k1]
                gv = (np.uint64(1) << cls.astype(np.uint64)) - np.uint64(1)
                packed[g_name] = pack_bits(gv, cls + 1)
                packed[a_name] = pack_bits(gvals_u64[kind][k0:k1], guide_w[kind][cls])
            packed["mbb"] = pack_bits(mbb_u64[m0:m1], mbb_w)
            packed["idg"] = pack_bits(idg_u64[i0:i1], 2)
            if opt_level >= 3:
                packed["idl"] = pack_bits(idl_u64[u0:u1], 8)
            else:
                packed["idl"] = pack_bits(np.full(i1 - i0, 1, dtype=np.uint64), 8)
            packed["ibs"] = pack_bits(ibs_u64[p0:p1], 2)
            packed["rfl"] = pack_bits(rfl_u64[s0:s1], 3)
            packed["esc"] = pack_bits(esc_u64[e0:e1], 3)
            for s in STREAMS:
                row[D[f"off_{s}"]] = bitpos[s]
                w, nbits = packed[s]
                words[s].append(w)
                bitpos[s] += w.size * 32  # word-aligned blocks
                block_bits[s] = max(block_bits[s], nbits)

            caps.segs = max(caps.segs, s1 - s0)
            caps.mism = max(caps.mism, m1 - m0)
            caps.indel = max(caps.indel, i1 - i0)
            caps.multi = max(caps.multi, u1 - u0)
            caps.insb = max(caps.insb, p1 - p0)
            caps.escb = max(caps.escb, e1 - e0)
            caps.tokens = max(caps.tokens, int(cst[bi + 1] - cst[bi]))
            caps.window = max(caps.window, (span + 15) & ~15)

        streams = {
            s: (np.concatenate(words[s]) if words[s] else np.zeros(0, dtype=np.uint32))
            for s in STREAMS
        }
        meta = SageMeta(
            version=1,
            read_kind=rs.kind,
            n_reads=len(rs.reads),
            n_segments=S,
            n_blocks=nb,
            fixed_read_len=fixed_len,
            cons_len=int(self.cons.size),
            caps=caps,
            classes=classes,
            stream_bits={s: int(bitpos[s]) for s in STREAMS},
        )
        meta.stream_bits.update({f"blk_{s}": int(block_bits[s]) for s in STREAMS})
        return SageFile(
            meta=meta,
            consensus2b=pack_2bit(self.cons),
            directory=directory,
            streams=streams,
        )

    def _decode_verify_failures(
        self, sf: SageFile, expected: list[np.ndarray], device: torch.device
    ) -> list[int]:
        """Round-trip ``sf`` through the bucketed decoder on ``device`` (the
        block-decode kernel on the card, its plain version on the CPU) and
        return the file-order indices of reads that did not decode to their
        original bases — the batch replacement for the per-read ``_verify``
        walk. The decoded planes come to the host once."""
        from repro_torch.core.decode_torch import decode_blocks_bucketed, prepare_device_blocks

        nb = sf.meta.n_blocks
        if nb == 0:
            return []
        db = prepare_device_blocks(sf).to(device)
        out = decode_blocks_bucketed(db, np.arange(nb, dtype=np.int64))
        toks, n_reads, starts, lens = (
            out[k].cpu().numpy() for k in ("tokens", "n_reads", "read_start", "read_len")
        )
        bi, ri = np.nonzero(np.arange(starts.shape[1])[None, :] < n_reads[:, None])
        assert bi.size == len(expected), "decoder read count != encoded read count"
        st = starts[bi, ri].astype(np.int64)
        ln = lens[bi, ri].astype(np.int64)
        exp_ln = np.fromiter((r.size for r in expected), dtype=np.int64, count=len(expected))
        fail = ln != exp_ln
        cmp_ids = np.nonzero(~fail)[0]
        if cmp_ids.size:
            ln_c = exp_ln[cmp_ids]
            flat = toks[
                np.repeat(bi[cmp_ids], ln_c),
                np.repeat(st[cmp_ids], ln_c) + ranges_from_counts(ln_c),
            ].astype(np.int64)
            exp_flat = (
                np.concatenate([expected[i] for i in cmp_ids]).astype(np.int64)
                if int(ln_c.sum()) else np.zeros(0, dtype=np.int64)
            )
            eq = np.concatenate([[0], np.cumsum(flat == exp_flat)])
            ends = np.cumsum(ln_c)
            fail[cmp_ids] |= (eq[ends] - eq[ends - ln_c]) != ln_c
        return [int(i) for i in np.nonzero(fail)[0]]

    def _encode_batched(self, rs: ReadSet, opt_level: int = 4) -> SageFile:
        """Batched SAGe_Write: map in batch, pack columnar, verify by decode.
        Escape demotion loops until the decode round-trip is clean, so the
        final container is lossless by construction (and bit-identical to
        the sequential reference, which demotes the same reads via its
        per-read walk)."""
        from repro_torch.core.decode_torch import resolve_device

        device = resolve_device(self.device)
        reads = rs.reads
        t0 = time.perf_counter()
        recs_list = self._map_all_batched(reads, device)
        t1 = time.perf_counter()
        escaped = {i for i, r in enumerate(recs_list) if r is None}
        t_pack = t_verify = 0.0
        rounds = 0
        while True:
            rounds += 1
            if rounds > len(reads) + 2:
                raise RuntimeError("encode verify loop failed to converge")
            tp = time.perf_counter()
            perm, per_read = self._ordered_records(reads, recs_list, escaped)
            tbl = SegTable.from_records(per_read)
            blk_read = self._blockize_table(tbl)
            sf = self._pack_table(tbl, blk_read, opt_level, rs)
            t_pack += time.perf_counter() - tp
            if not self.verify or sf.meta.n_blocks == 0:
                break
            tv = time.perf_counter()
            # opt levels < 3 pack mbb/idl in a layout the decoder does not
            # read (the paper's ablation sizes only); verify the records
            # through an opt-4 shadow container instead
            sfv = sf if opt_level >= 3 else self._pack_table(tbl, blk_read, 4, rs)
            fails = self._decode_verify_failures(sfv, [reads[p] for p in perm], device)
            t_verify += time.perf_counter() - tv
            if not fails:
                break
            escaped |= {int(perm[f]) for f in fails}
        self.stats["n_escaped"] = len(escaped)
        self.stats["verify_rounds"] = rounds
        self.stats["t_map"] = t1 - t0
        self.stats["t_pack"] = t_pack
        self.stats["t_verify"] = t_verify
        return sf


@dataclasses.dataclass
class SegTable:
    """Columnar (struct-of-arrays) layout of every segment record — the
    batched encoder's working set. One row per segment; mismatch-level
    arrays are concatenated in segment order with per-segment counts, so
    every downstream pass (blockize, tuning, pack) is a cumsum/slice."""

    pos: np.ndarray  # (S,) int64 consensus position
    length: np.ndarray  # (S,)
    rev: np.ndarray  # (S,) bool
    cont: np.ndarray  # (S,) bool
    corner: np.ndarray  # (S,) bool
    n_mism: np.ndarray  # (S,) mismatch records per segment
    read_id: np.ndarray  # (S,) owning read (file order)
    read_seg_start: np.ndarray  # (R+1,) segment bounds per read
    mp: np.ndarray  # (M,) absolute read coordinate per mismatch
    mbb: np.ndarray  # (M,) 2-bit rank/indel code
    is_ind: np.ndarray  # (M,) bool: indel record
    is_ins: np.ndarray  # (M,) bool: insertion record
    ilen: np.ndarray  # (M,) indel block length (0 for substitutions)
    ibases: np.ndarray  # (IB,) inserted bases, insertion order
    esc: np.ndarray  # (E,) escaped corner-read bases
    n_indel: np.ndarray  # (S,) derived per-segment counts
    n_multi: np.ndarray
    n_insb: np.ndarray
    n_escb: np.ndarray
    del_total: np.ndarray

    def window_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-segment consensus window extent with corner sentinels
        (min-pos candidates, max-end candidates) — the single definition
        block layout AND the directory's cons_start/cons_span both use."""
        pos_nc = np.where(self.corner, _SENT, self.pos)
        end_nc = np.where(self.corner, 0, self.pos + self.length + self.del_total)
        return pos_nc, end_nc

    @classmethod
    def from_records(cls, per_read: list[list[SegRecord]]) -> "SegTable":
        pos, length, rev, cont, corner, nm, rid = [], [], [], [], [], [], []
        mp_p, mbb_p, kind_p, ilen_p, ib_p, esc_p = [], [], [], [], [], []
        seg_counts = []
        for r, recs in enumerate(per_read):
            seg_counts.append(len(recs))
            for rec in recs:
                pos.append(rec.pos)
                length.append(rec.length)
                rev.append(rec.rev)
                cont.append(rec.cont)
                corner.append(rec.corner)
                rid.append(r)
                if rec.corner:
                    nm.append(0)
                    assert rec.esc is not None
                    esc_p.append(np.asarray(rec.esc, dtype=np.uint8))
                    continue
                nm.append(len(rec.mp))
                if rec.mp:
                    mp_p.append(np.asarray(rec.mp, dtype=np.int64))
                    mbb_p.append(np.asarray(rec.mbb, dtype=np.int64))
                    k = np.frombuffer("".join(rec.kinds).encode(), dtype=np.uint8)
                    kind_p.append(k)
                    il = np.zeros(k.size, dtype=np.int64)
                    if rec.ilen:
                        il[k != ord("S")] = rec.ilen
                    ilen_p.append(il)
                    ib_p.extend(rec.ibases)

        def cat(parts, dtype):
            return (
                np.concatenate(parts).astype(dtype)
                if parts else np.zeros(0, dtype=dtype)
            )

        kind = cat(kind_p, np.uint8)
        is_ind = kind != ord("S")
        is_ins = kind == ord("I")
        ilen = cat(ilen_p, np.int64)
        n_mism = np.asarray(nm, dtype=np.int64)
        m_end = np.cumsum(n_mism)
        m_start = m_end - n_mism

        def seg_sum(per_m: np.ndarray) -> np.ndarray:
            c = np.concatenate([[0], np.cumsum(per_m)])
            return c[m_end] - c[m_start]

        length_a = np.asarray(length, dtype=np.int64)
        corner_a = np.asarray(corner, dtype=bool)
        return cls(
            pos=np.asarray(pos, dtype=np.int64),
            length=length_a,
            rev=np.asarray(rev, dtype=bool),
            cont=np.asarray(cont, dtype=bool),
            corner=corner_a,
            n_mism=n_mism,
            read_id=np.asarray(rid, dtype=np.int64),
            read_seg_start=np.concatenate([[0], np.cumsum(seg_counts)]).astype(np.int64),
            mp=cat(mp_p, np.int64),
            mbb=cat(mbb_p, np.int64),
            is_ind=is_ind,
            is_ins=is_ins,
            ilen=ilen,
            ibases=cat(ib_p, np.int64),
            esc=cat(esc_p, np.int64),
            n_indel=seg_sum(is_ind.astype(np.int64)),
            n_multi=seg_sum((is_ind & (ilen > 1)).astype(np.int64)),
            n_insb=seg_sum(np.where(is_ins, ilen, 0)),
            n_escb=length_a * corner_a,
            del_total=seg_sum(np.where(is_ind & ~is_ins, ilen, 0)),
        )


class _BlockValues:
    """Accumulates one block's stream values, then bit-packs them."""

    def __init__(self) -> None:
        self.map_vals: list[int] = []
        self.len_vals: list[int] = []
        self.cnt_vals: list[int] = []
        self.mp_vals: list[int] = []
        self.mbb: list[int] = []
        self.idg: list[int] = []
        self.idl: list[int] = []
        self.ibs: list[int] = []
        self.rfl: list[int] = []
        self.esc: list[int] = []
        self._base_pos: Optional[int] = None
        self._first_pos = 0

    def add(self, rec: SegRecord, fixed_len: int) -> None:
        if rec.cont:
            d = rec.pos - self._first_pos
            self.map_vals.append((d << 1) if d >= 0 else (((-d) << 1) - 1))
        elif rec.corner:
            self.map_vals.append(0)
        else:
            if self._base_pos is None:
                self._base_pos = rec.pos
            self.map_vals.append(rec.pos - self._base_pos)
            self._base_pos = rec.pos
            self._first_pos = rec.pos
        if not fixed_len:
            self.len_vals.append(rec.length)
        self.cnt_vals.append(len(rec.mp))
        self.rfl.append(int(rec.rev) | (int(rec.cont) << 1) | (int(rec.corner) << 2))
        if rec.corner:
            assert rec.esc is not None
            self.esc.extend(int(x) for x in rec.esc)
            return
        prev = 0
        ii = 0  # indel index (ilen)
        bi = 0  # insertion index (ibases)
        for m, (p, k) in enumerate(zip(rec.mp, rec.kinds)):
            self.mp_vals.append(p - prev)
            prev = p
            self.mbb.append(rec.mbb[m])
            if k == "S":
                continue
            ln = rec.ilen[ii]
            is_ins = k == "I"
            self.idg.append(int(is_ins) | (int(ln > 1) << 1))
            if ln > 1:
                self.idl.append(ln)
            if is_ins:
                self.ibs.extend(int(x) for x in rec.ibases[bi])
                bi += 1
            ii += 1

    def pack(self, classes: dict[str, tuple[int, ...]], opt_level: int = 4) -> dict[str, tuple[np.ndarray, int]]:
        out: dict[str, tuple[np.ndarray, int]] = {}

        def guide_and_vals(kind: str, values: list[int]) -> tuple[tuple[np.ndarray, int], tuple[np.ndarray, int]]:
            v = np.asarray(values, dtype=np.uint64)
            widths_tab = classes[kind]
            cls = tuning.assign_classes(v, widths_tab)
            # unary guide: cls ones then a zero -> value (2^cls - 1), width cls+1
            gvals = (np.uint64(1) << cls.astype(np.uint64)) - np.uint64(1)
            g = pack_bits(gvals, cls + 1)
            w = np.asarray(widths_tab, dtype=np.int64)[cls]
            a = pack_bits(v, w)  # pack_bits masks on a fresh array, never in place
            return g, a

        out["mapg"], out["mapa"] = guide_and_vals("map", self.map_vals)
        out["leng"], out["lena"] = guide_and_vals("len", self.len_vals)
        out["cntg"], out["cnta"] = guide_and_vals("cnt", self.cnt_vals)
        out["mpg"], out["mpa"] = guide_and_vals("mp", self.mp_vals)
        n = len(self.mbb)
        # opt 3: 2-bit merged base/type rank code; below: 2-bit base + 2-bit
        # explicit type and an 8-bit length for EVERY indel (paper's O0-O2)
        mbb_w = 2 if opt_level >= 3 else 4
        out["mbb"] = pack_bits(np.asarray(self.mbb, dtype=np.uint64), np.full(n, mbb_w, dtype=np.int64))
        out["idg"] = pack_bits(np.asarray(self.idg, dtype=np.uint64), np.full(len(self.idg), 2, dtype=np.int64))
        if opt_level >= 3:
            out["idl"] = pack_bits(np.asarray(self.idl, dtype=np.uint64), np.full(len(self.idl), 8, dtype=np.int64))
        else:
            n_indel = len(self.idg)
            out["idl"] = pack_bits(np.full(n_indel, 1, dtype=np.uint64), np.full(n_indel, 8, dtype=np.int64))
        out["ibs"] = pack_bits(np.asarray(self.ibs, dtype=np.uint64), np.full(len(self.ibs), 2, dtype=np.int64))
        out["rfl"] = pack_bits(np.asarray(self.rfl, dtype=np.uint64), np.full(len(self.rfl), 3, dtype=np.int64))
        out["esc"] = pack_bits(np.asarray(self.esc, dtype=np.uint64), np.full(len(self.esc), 3, dtype=np.int64))
        return out
