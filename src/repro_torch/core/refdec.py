"""Sequential reference decoder (numpy oracle).

Mirrors the paper's Scan Unit / Read Construction Unit hardware as a
straight-line FSM over the bitstreams: read a unary guide code, read that
many bits from the value array, advance — exactly Fig. 7's walk. Completely
independent of the vectorized JAX/Pallas decoders; used as the correctness
oracle in tests and as the "SAGe software" baseline in benchmarks.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.bitio import unpack_2bit
from repro_torch.core.format import D, S, SageFile
from repro_torch.genomics.synth import revcomp


class _BitReader:
    def __init__(self, words: np.ndarray, bitpos: int) -> None:
        self.bits = np.unpackbits(np.asarray(words, dtype=np.uint32).view(np.uint8), bitorder="little")
        self.pos = bitpos

    def read(self, width: int) -> int:
        if width == 0:
            return 0
        b = self.bits[self.pos : self.pos + width]
        self.pos += width
        return int(b @ (1 << np.arange(width, dtype=np.int64)))

    def read_unary(self) -> int:
        n = 0
        while self.bits[self.pos]:
            n += 1
            self.pos += 1
        self.pos += 1
        return n


@dataclasses.dataclass
class DecodedRead:
    seq: np.ndarray  # coded bases (0..4)
    pos: int  # consensus position of first segment (corner: -1)
    rev: bool
    corner: bool


def decode_block(sf: SageFile, bi: int, cons: np.ndarray) -> list[DecodedRead]:
    """Decode one block sequentially."""
    row = sf.directory[bi]
    meta = sf.meta
    rd = {s: _BitReader(sf.streams[s], int(row[D[f"off_{s}"]])) for s in S}
    cls = meta.classes

    def read_adaptive(kind: str, gname: str, aname: str) -> int:
        c = rd[gname].read_unary()
        return rd[aname].read(cls[kind][c])

    out: list[DecodedRead] = []
    acc = int(row[D["base_pos"]])
    first_pos = acc
    n_segs = int(row[D["n_segs"]])
    parts: list[np.ndarray] = []
    cur_rev = False
    cur_corner = False
    cur_pos = -1

    def flush() -> None:
        nonlocal parts
        if not parts:
            return
        seq = np.concatenate(parts) if len(parts) > 1 else parts[0]
        if cur_rev:
            seq = revcomp(seq)
        out.append(DecodedRead(seq=seq, pos=cur_pos, rev=cur_rev, corner=cur_corner))
        parts = []

    for si in range(n_segs):
        flags = rd["rfl"].read(3)
        rev, cont, corner = bool(flags & 1), bool(flags & 2), bool(flags & 4)
        delta = read_adaptive("map", "mapg", "mapa")
        if cont:
            d = (delta >> 1) if (delta & 1) == 0 else -((delta + 1) >> 1)
            pos = first_pos + d
        elif corner:
            pos = -1  # unmapped; delta is 0 by construction
        else:
            # base_pos == first mapped segment's pos and its delta == 0,
            # so plain accumulation is uniform across the block.
            acc += delta
            pos = acc
            first_pos = acc
        length = meta.fixed_read_len or read_adaptive("len", "leng", "lena")
        cnt = read_adaptive("cnt", "cntg", "cnta")
        if not cont:
            flush()
            cur_rev, cur_corner, cur_pos = rev, corner, (pos if not corner else -1)
        if corner:
            seq = np.empty(length, dtype=np.uint8)
            for i in range(length):
                seq[i] = rd["esc"].read(3)
            parts.append(seq)
            continue
        # reconstruct segment: walk consensus + mismatch records (RCU)
        seg = np.empty(length, dtype=np.uint8)
        cursor = pos
        ri = 0
        prev_p = 0
        for _ in range(cnt):
            p = prev_p + read_adaptive("mp", "mpg", "mpa")
            # copy matched bases up to p
            while ri < p:
                seg[ri] = cons[cursor]
                ri += 1
                cursor += 1
            prev_p = p
            code = rd["mbb"].read(2)
            if code < 3:  # substitution: rank among non-consensus bases
                cb = int(cons[cursor])
                seg[ri] = code + (1 if code >= cb else 0)
                ri += 1
                cursor += 1
            else:  # indel
                ig = rd["idg"].read(2)
                is_ins, is_multi = bool(ig & 1), bool(ig & 2)
                ln = rd["idl"].read(8) if is_multi else 1
                if is_ins:
                    for j in range(ln):
                        seg[ri] = rd["ibs"].read(2)
                        ri += 1
                else:
                    cursor += ln
        while ri < length:
            seg[ri] = cons[cursor]
            ri += 1
            cursor += 1
        parts.append(seg)
    flush()
    return out


def decode_all(sf: SageFile) -> list[DecodedRead]:
    cons = unpack_2bit(sf.consensus2b, sf.meta.cons_len)
    out: list[DecodedRead] = []
    for bi in range(sf.meta.n_blocks):
        out.extend(decode_block(sf, bi, cons))
    return out
