"""The benchmark's seeded read simulator (NumPy).

A frozen copy of the port's ``repro_torch/genomics/synth.py`` (reference
genome with repeats, a donor with clustered SNPs, sequencing-technology
error profiles with indel blocks, low-quality bursts, chimeras and N
dropouts), kept here so that the benchmark's inputs do not move when the
program's simulator does. Bases are coded 0=A 1=C 2=G 3=T 4=N.

``reads_for(recipe, seed)`` is the benchmark's entry: it makes the reference
and the read set that a traffic file's ``container`` recipe names, from the
run's seed. Every seed gets the same sizes: a fixed number of reads, and for
long reads the same set of lengths in another order.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
    indel_len_p: float  # geometric parameter of an indel block's length
    n_rate: float  # probability that a read holds N dropouts
    chimera_rate: float
    kind: str  # "short" | "long"
    burst_rate: float = 0.0
    burst_len: int = 12
    burst_sub_rate: float = 0.12


PROFILES: dict[str, SynthProfile] = {
    "illumina": SynthProfile(
        "illumina", 150, 0, 0.001, 0.0001, 0.0001, 0.7, 0.0015, 0.0005, "short",
        burst_rate=0.002, burst_len=10, burst_sub_rate=0.15,
    ),
    "hifi": SynthProfile(
        "hifi", 12000, 2500, 0.004, 0.003, 0.003, 0.55, 0.001, 0.01, "long",
        burst_rate=0.0005, burst_len=20, burst_sub_rate=0.2,
    ),
    "ont": SynthProfile(
        "ont", 8000, 3000, 0.03, 0.025, 0.025, 0.45, 0.002, 0.02, "long",
        burst_rate=0.001, burst_len=30, burst_sub_rate=0.35,
    ),
}


@dataclasses.dataclass
class ReadSet:
    """Reads as coded uint8 arrays, their qualities, and the profile's kind."""

    reads: list[np.ndarray]
    quals: list[np.ndarray]
    kind: str
    profile: str

    @property
    def n_bases(self) -> int:
        return int(sum(r.size for r in self.reads))


def make_reference(length: int, seed: int = 0, repeat_fraction: float = 0.15,
                   repeat_unit: int = 300) -> np.ndarray:
    """Random reference genome with long-range repeats (tandem + dispersed)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, length, dtype=np.int8).astype(np.uint8)
    n_rep = int(length * repeat_fraction / max(repeat_unit, 1))
    for _ in range(n_rep):
        src = int(rng.integers(0, max(1, length - repeat_unit)))
        dst = int(rng.integers(0, max(1, length - repeat_unit)))
        seg = ref[src:src + repeat_unit].copy()
        nmut = rng.binomial(seg.size, 0.02)
        if nmut:
            at = rng.integers(0, seg.size, nmut)
            seg[at] = (seg[at] + rng.integers(1, 4, nmut)) % 4
        ref[dst:dst + seg.size] = seg
    return ref


def _mutate_individual(ref: np.ndarray, rng: np.random.Generator, snp_rate: float = 0.001) -> np.ndarray:
    """Donor genome: reference + clustered SNPs."""
    donor = ref.copy()
    n_clusters = max(1, int(ref.size * snp_rate / 3))
    for c in rng.integers(0, ref.size, n_clusters):
        k = 1 + rng.geometric(0.45)
        offs = np.unique(rng.integers(-60, 61, k))
        idx = np.clip(c + offs, 0, ref.size - 1)
        donor[idx] = (donor[idx] + rng.integers(1, 4, idx.size)) % 4
    return donor


def _apply_errors(seq: np.ndarray, prof: SynthProfile, rng: np.random.Generator) -> np.ndarray:
    """Substitution / insertion / deletion errors with block lengths, then N dropouts."""
    n = seq.size
    sub_p = np.full(n, prof.sub_rate)
    if prof.burst_rate > 0:
        nb = rng.binomial(n, prof.burst_rate)
        for s in rng.integers(0, max(1, n - prof.burst_len), nb):
            sub_p[s:s + prof.burst_len] = prof.burst_sub_rate
    sub_mask = rng.random(n) < sub_p
    out = seq.copy()
    k = int(sub_mask.sum())
    if k:
        out[sub_mask] = (out[sub_mask] + rng.integers(1, 4, k)) % 4
    pieces: list[np.ndarray] = []
    cursor = 0
    events = []
    for _ in range(rng.binomial(n, prof.ins_rate)):
        events.append((int(rng.integers(1, max(2, n - 1))), "I", int(rng.geometric(prof.indel_len_p))))
    for _ in range(rng.binomial(n, prof.del_rate)):
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
    if rng.random() < prof.n_rate and res.size > 4:
        nn = 1 + rng.geometric(0.5)
        res = res.copy()
        res[rng.integers(0, res.size, nn)] = 4
    return res


def _qual_for(seq: np.ndarray, prof: SynthProfile, rng: np.random.Generator) -> np.ndarray:
    base_q = {"illumina": 38, "hifi": 30, "ont": 14}.get(prof.name, 20)
    return np.clip(rng.normal(base_q, 3, seq.size), 2, 41).astype(np.uint8) + 33


def sample_reads(ref: np.ndarray, prof: SynthProfile, lengths: np.ndarray, seed: int,
                 snp_rate: float = 0.001) -> ReadSet:
    """One read a fragment length in ``lengths``, from a donor of ``ref``: a
    random locus and strand (a chimera of two loci at the profile's rate),
    then the profile's errors. The sampling of the port's
    ``sample_read_set``, with the lengths given rather than drawn."""
    rng = np.random.default_rng(seed)
    donor = _mutate_individual(ref, rng, snp_rate)
    reads, quals = [], []
    for L in (int(x) for x in lengths):
        if rng.random() < prof.chimera_rate and L >= 400:
            l1 = int(rng.integers(L // 4, 3 * L // 4))
            p1 = int(rng.integers(0, ref.size - l1))
            p2 = int(rng.integers(0, ref.size - (L - l1)))
            frag = np.concatenate([donor[p1:p1 + l1], donor[p2:p2 + (L - l1)]])
        else:
            pos = int(rng.integers(0, ref.size - L))
            frag = donor[pos:pos + L]
        if rng.random() < 0.5:
            frag = revcomp(frag)
        read = _apply_errors(frag, prof, rng)
        reads.append(read)
        quals.append(_qual_for(read, prof, rng))
    return ReadSet(reads=reads, quals=quals, kind=prof.kind, profile=prof.name)


def reads_for(recipe: dict, seed: int) -> tuple[np.ndarray, ReadSet]:
    """(reference, reads) of a traffic file's ``container`` recipe:
    ``ref_len``, ``profile``, ``n_reads`` fragments of ``read_len`` bases."""
    rng = np.random.default_rng([seed, 0x5A6E])
    ref = make_reference(int(recipe["ref_len"]), seed=int(rng.integers(2**31)))
    lengths = np.full(int(recipe["n_reads"]), int(recipe["read_len"]), np.int64)
    return ref, sample_reads(ref, PROFILES[recipe["profile"]], lengths, seed=int(rng.integers(2**31)))
