"""Minimal FASTQ reader/writer for coded read sets."""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

from repro_torch.genomics.synth import BASES, CODE, ReadSet


def write_fastq(path: str | Path, rs: ReadSet, name_prefix: str = "read") -> None:
    path = Path(path)
    op = gzip.open if path.suffix == ".gz" else open
    with op(path, "wt") as f:
        for i, (r, q) in enumerate(zip(rs.reads, rs.quals)):
            f.write(f"@{name_prefix}.{i}\n")
            f.write(BASES[r].tobytes().decode())
            f.write("\n+\n")
            f.write(q.tobytes().decode())
            f.write("\n")


def read_fastq(path: str | Path, kind: str = "short") -> ReadSet:
    path = Path(path)
    op = gzip.open if path.suffix == ".gz" else open
    reads: list[np.ndarray] = []
    quals: list[np.ndarray] = []
    with op(path, "rt") as f:
        while True:
            h = f.readline()
            if not h:
                break
            seq = f.readline().strip()
            f.readline()  # +
            q = f.readline().strip()
            codes = CODE[np.frombuffer(seq.encode(), dtype=np.uint8)]
            if np.any(codes == 255):
                codes = np.where(codes == 255, 4, codes).astype(np.uint8)
            reads.append(codes.astype(np.uint8))
            quals.append(np.frombuffer(q.encode(), dtype=np.uint8).copy())
    return ReadSet(reads=reads, quals=quals, kind=kind, profile="file")
