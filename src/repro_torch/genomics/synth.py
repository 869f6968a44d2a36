"""Synthetic genomic read-set generation.

Models the dataset features SAGe's encoding exploits (§5.1 / Fig. 6 of the
paper): mutation clustering (nearby mismatches), sequencing-technology error
profiles (Illumina short/accurate, PacBio HiFi long/accurate, ONT long/noisy),
indel-block length distributions dominated by single-base events with a heavy
tail, chimeric reads, and N-base dropouts.

Bases are coded 0=A 1=C 2=G 3=T 4=N throughout the repo.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)
CODE = np.full(256, 255, dtype=np.uint8)
for i, b in enumerate(b"ACGTN"):
    CODE[b] = i
CODE[ord("a")], CODE[ord("c")], CODE[ord("g")], CODE[ord("t")], CODE[ord("n")] = 0, 1, 2, 3, 4


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a coded sequence (N maps to N)."""
    out = codes[::-1].copy()
    acgt = out < 4
    out[acgt] = 3 - out[acgt]
    return out


@dataclasses.dataclass(frozen=True)
class SynthProfile:
    """Sequencing-technology profile."""

    name: str
    read_len_mean: int
    read_len_sd: int
    sub_rate: float
    ins_rate: float
    del_rate: float
    # geometric parameter for indel block length (P[L=1] high; heavy-ish tail)
    indel_len_p: float
    n_rate: float  # probability a read contains N dropouts
    chimera_rate: float
    kind: str  # "short" | "long"
    # probability of a local low-quality burst producing clustered errors
    burst_rate: float = 0.0
    burst_len: int = 12
    burst_sub_rate: float = 0.12


PROFILES: dict[str, SynthProfile] = {
    # Illumina-like: 150bp, ~0.1% errors, substitutions only (mostly)
    "illumina": SynthProfile(
        "illumina", 150, 0, 0.001, 0.0001, 0.0001, 0.7, 0.0015, 0.0005, "short",
        burst_rate=0.002, burst_len=10, burst_sub_rate=0.15,
    ),
    # PacBio HiFi-like: 10-20kb, ~1% errors
    "hifi": SynthProfile(
        "hifi", 12000, 2500, 0.004, 0.003, 0.003, 0.55, 0.001, 0.01, "long",
        burst_rate=0.0005, burst_len=20, burst_sub_rate=0.2,
    ),
    # ONT-like: long, 5-12% errors, indel heavy
    "ont": SynthProfile(
        "ont", 8000, 3000, 0.03, 0.025, 0.025, 0.45, 0.002, 0.02, "long",
        burst_rate=0.001, burst_len=30, burst_sub_rate=0.35,
    ),
}


@dataclasses.dataclass
class ReadSet:
    """A set of sequenced reads plus provenance (for tests/benchmarks)."""

    reads: list[np.ndarray]  # coded uint8 arrays (0..4)
    quals: list[np.ndarray]  # phred+33 ascii codes, same lengths
    kind: str  # "short" | "long"
    profile: str
    # ground truth (synthetic only; encoders must not read these)
    true_pos: Optional[list[int]] = None
    true_rev: Optional[list[bool]] = None

    @property
    def n_reads(self) -> int:
        return len(self.reads)

    @property
    def n_bases(self) -> int:
        return int(sum(r.size for r in self.reads))

    def uncompressed_fastq_bytes(self) -> int:
        """Approximate FASTQ size: header(~40) + seq + '+' line + quals."""
        return int(sum(2 * r.size + 46 for r in self.reads))


def make_reference(
    length: int,
    seed: int = 0,
    repeat_fraction: float = 0.15,
    repeat_unit: int = 300,
) -> np.ndarray:
    """Random reference genome with long-range repeats (tandem + dispersed).

    Repeats matter: they create the multi-mapping ambiguity that makes
    consensus-based compression (and chimera handling) non-trivial.
    """
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, length, dtype=np.int8).astype(np.uint8)
    n_rep = int(length * repeat_fraction / max(repeat_unit, 1))
    for _ in range(n_rep):
        src = int(rng.integers(0, max(1, length - repeat_unit)))
        dst = int(rng.integers(0, max(1, length - repeat_unit)))
        seg = ref[src : src + repeat_unit].copy()
        # light divergence between repeat copies
        nmut = rng.binomial(seg.size, 0.02)
        if nmut:
            at = rng.integers(0, seg.size, nmut)
            seg[at] = (seg[at] + rng.integers(1, 4, nmut)) % 4
        ref[dst : dst + seg.size] = seg
    return ref


def _mutate_individual(ref: np.ndarray, rng: np.random.Generator, snp_rate: float = 0.001) -> np.ndarray:
    """Donor genome: reference + clustered SNPs (mutation clustering, Fig 6a)."""
    donor = ref.copy()
    n_clusters = max(1, int(ref.size * snp_rate / 3))
    centers = rng.integers(0, ref.size, n_clusters)
    for c in centers:
        k = 1 + rng.geometric(0.45)
        offs = np.unique(rng.integers(-60, 61, k))
        idx = np.clip(c + offs, 0, ref.size - 1)
        donor[idx] = (donor[idx] + rng.integers(1, 4, idx.size)) % 4
    return donor


def _apply_errors(seq: np.ndarray, prof: SynthProfile, rng: np.random.Generator) -> np.ndarray:
    """Apply substitution / insertion / deletion errors with block lengths."""
    n = seq.size
    sub_p = np.full(n, prof.sub_rate)
    # low-quality bursts -> clustered substitutions (paper §5.1.1 factor 2)
    if prof.burst_rate > 0:
        nb = rng.binomial(n, prof.burst_rate)
        for s in rng.integers(0, max(1, n - prof.burst_len), nb):
            sub_p[s : s + prof.burst_len] = prof.burst_sub_rate
    sub_mask = rng.random(n) < sub_p
    out = seq.copy()
    k = int(sub_mask.sum())
    if k:
        out[sub_mask] = (out[sub_mask] + rng.integers(1, 4, k)) % 4
    # indels as blocks: choose event positions then expand lengths
    pieces: list[np.ndarray] = []
    cursor = 0
    n_ins = rng.binomial(n, prof.ins_rate)
    n_del = rng.binomial(n, prof.del_rate)
    events = []
    for _ in range(n_ins):
        events.append((int(rng.integers(1, max(2, n - 1))), "I", int(rng.geometric(prof.indel_len_p))))
    for _ in range(n_del):
        events.append((int(rng.integers(1, max(2, n - 1))), "D", int(rng.geometric(prof.indel_len_p))))
    events.sort()
    for pos, kind, length in events:
        if pos <= cursor:
            continue
        pieces.append(out[cursor:pos])
        if kind == "I":
            pieces.append(rng.integers(0, 4, min(length, 40)).astype(np.uint8))
            cursor = pos
        else:
            cursor = min(n, pos + min(length, 40))
    pieces.append(out[cursor:])
    res = np.concatenate(pieces) if pieces else out
    # N dropouts
    if rng.random() < prof.n_rate and res.size > 4:
        nn = 1 + rng.geometric(0.5)
        at = rng.integers(0, res.size, nn)
        res = res.copy()
        res[at] = 4
    return res


def _qual_for(seq: np.ndarray, prof: SynthProfile, rng: np.random.Generator) -> np.ndarray:
    base_q = {"illumina": 38, "hifi": 30, "ont": 14}.get(prof.name, 20)
    q = np.clip(rng.normal(base_q, 3, seq.size), 2, 41).astype(np.uint8) + 33
    return q


def sample_read_set(
    ref: np.ndarray,
    profile: str | SynthProfile,
    depth: float = 10.0,
    seed: int = 1,
    snp_rate: float = 0.001,
    max_reads: Optional[int] = None,
) -> ReadSet:
    """Sample a read set from a donor derived from ``ref`` at given depth."""
    prof = PROFILES[profile] if isinstance(profile, str) else profile
    rng = np.random.default_rng(seed)
    donor = _mutate_individual(ref, rng, snp_rate)
    target_bases = int(ref.size * depth)
    reads: list[np.ndarray] = []
    quals: list[np.ndarray] = []
    tpos: list[int] = []
    trev: list[bool] = []
    got = 0
    while got < target_bases:
        if max_reads is not None and len(reads) >= max_reads:
            break
        L = prof.read_len_mean if prof.read_len_sd == 0 else int(
            np.clip(rng.normal(prof.read_len_mean, prof.read_len_sd), 200, 4 * prof.read_len_mean)
        )
        L = min(L, ref.size - 1)
        if rng.random() < prof.chimera_rate and L >= 400:
            # chimeric: two segments joined from different loci
            l1 = int(rng.integers(L // 4, 3 * L // 4))
            p1 = int(rng.integers(0, ref.size - l1))
            p2 = int(rng.integers(0, ref.size - (L - l1)))
            frag = np.concatenate([donor[p1 : p1 + l1], donor[p2 : p2 + (L - l1)]])
            pos = p1
        else:
            pos = int(rng.integers(0, ref.size - L))
            frag = donor[pos : pos + L]
        rev = bool(rng.random() < 0.5)
        if rev:
            frag = revcomp(frag)
        read = _apply_errors(frag, prof, rng)
        if read.size < 20:
            continue
        reads.append(read)
        quals.append(_qual_for(read, prof, rng))
        tpos.append(pos)
        trev.append(rev)
        got += read.size
    return ReadSet(reads=reads, quals=quals, kind=prof.kind, profile=prof.name, true_pos=tpos, true_rev=trev)
