"""SAGe encoder (host side).

Maps each read against the consensus, converts alignments into SAGe's
guide-array streams with dataset-adaptive bit widths, and lays the streams
out in fixed-capacity blocks (the TPU analogue of the paper's per-channel
partitioning).

This port carries the sequential read-at-a-time pipeline only
(``batched=False``, pure numpy). The JAX package's batched pipeline writes
the bit-identical :class:`SageFile` faster; it needs the batched mapper and
a banded-alignment device op, which this package does not have yet, so
``batched=True`` raises ``NotImplementedError``.

Compression stays on the host side of SAGe_Write — it is off the analysis
critical path (paper footnote 7).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np

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

    Only the sequential pipeline exists here (``batched=False``, the
    default): it maps and verifies read by read, exactly like the JAX
    package's reference path, and writes the same :class:`SageFile`.
    ``batched=True`` raises ``NotImplementedError`` (ROADMAP Queue A,
    slice 3: batched SAGe_Write). ``verify`` is accepted for signature
    parity; the sequential path always verifies per read."""

    def __init__(
        self,
        consensus: np.ndarray,
        token_target: int = 65536,
        window_target: int = 1 << 20,
        mapper: Optional[ReadMapper] = None,
        max_classes: int = 4,
        batched: bool = False,
        verify: bool = True,
        batch_min: int = 4,
        batch_max_len: int = 4096,
    ) -> None:
        if batched:
            raise NotImplementedError(
                "SageEncoder(batched=True) is not ported yet (ROADMAP Queue A, "
                "slice 3: batched SAGe_Write); use batched=False, which writes "
                "the same SageFile"
            )
        self.cons = np.asarray(consensus, dtype=np.uint8)
        self.token_target = token_target
        self.window_target = window_target
        self.mapper = mapper or ReadMapper(self.cons)
        self.max_classes = max_classes
        self.batched = batched
        self.verify = verify
        self.batch_min = batch_min
        self.batch_max_len = batch_max_len
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
        return self._encode_reference(rs, opt_level)

    def _encode_reference(self, rs: ReadSet, opt_level: int = 4) -> SageFile:
        """Sequential reference pipeline (read-at-a-time map + verify walk,
        per-record stream accumulation)."""
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
