"""The reference's k-mer tokens, worked out from the synthesized reads alone.

A k-mer token packs k bases (A=0 C=1 G=2 T=3) into one id, first base most
significant. A group that holds an N (code 4) inside a read is the N-block
id 4**k + 2; groups past a row's real bases are the pad id 4**k.

``parse_stream`` judges a training token stream: a container block holds
whole reads back to back, and the stream keeps each block's first
``n_tokens // k`` groups, so the stream's bases are the reads of each block
in turn with at most k - 1 bases cut from the end of each block. The parse
walks the stream and finds each read it holds among the synthesized reads,
so it needs neither the container nor the order in which the writer laid
the reads out.
"""

from __future__ import annotations

import numpy as np

KEY = 24  #: bases a read is looked up by


def special_ids(k: int) -> dict[str, int]:
    return {"pad": 4**k, "bos": 4**k + 1, "nblk": 4**k + 2}


def kmer_ids(bases: np.ndarray, k: int) -> np.ndarray:
    """The k-mer ids of a read's leading ``len // k`` groups (int64)."""
    g = np.asarray(bases[: (bases.size // k) * k], np.int64).reshape(-1, k)
    ids = (np.where(g > 3, 0, g) * 4 ** np.arange(k - 1, -1, -1)).sum(1)
    return np.where((g == 4).any(1), special_ids(k)["nblk"], ids)


def expand(tokens: np.ndarray, k: int) -> np.ndarray:
    """k-mer ids -> bases (uint8); every base of an N-block group is 255
    (unknown), and a pad or other out-of-range id raises."""
    t = np.asarray(tokens, np.int64).reshape(-1)
    nblk = t == special_ids(k)["nblk"]
    bad = ((t < 0) | (t >= 4**k)) & ~nblk
    if bad.any():
        raise ValueError(f"token {int(t[bad][0])} is not a k-mer of k={k}")
    digits = (np.where(nblk, 0, t)[:, None] // 4 ** np.arange(k - 1, -1, -1)) % 4
    out = digits.astype(np.uint8)
    out[nblk] = 255
    return out.reshape(-1)


def _match(stream: np.ndarray, at: int, read: np.ndarray) -> int:
    """How many leading bases of ``read`` the stream holds from ``at``; an
    unknown base (255, a group with an N) matches any base."""
    seg = stream[at:at + read.size]
    bad = np.flatnonzero((seg != read[: seg.size]) & (seg != 255))
    return int(bad[0]) if bad.size else int(seg.size)


class ReadIndex:
    """The synthesized reads, found by KEY bases at their start or, where
    those hold an N, at offset KEY (else by a scan of them all); ``k`` is
    the token width, so a read cut at a block's end is still found."""

    def __init__(self, reads: list, k: int) -> None:
        self.k = k
        self.reads = [np.asarray(r, np.uint8) for r in reads]
        self.at0: dict[bytes, list[int]] = {}
        self.at1: dict[bytes, list[int]] = {}
        for i, r in enumerate(self.reads):
            if r.size >= KEY and not (r[:KEY] == 4).any():
                self.at0.setdefault(r[:KEY].tobytes(), []).append(i)
            elif r.size >= 2 * KEY and not (r[KEY:2 * KEY] == 4).any():
                self.at1.setdefault(r[KEY:2 * KEY].tobytes(), []).append(i)

    def candidates(self, stream: np.ndarray, at: int) -> list[int]:
        """Reads that may start at ``at``: looked up by the KEY bases there,
        or by the KEY after them; scanned for only where both windows hold
        an unknown base."""
        head, nxt = stream[at:at + KEY], stream[at + KEY:at + 2 * KEY]
        head_ok = head.size == KEY and not (head == 255).any()
        nxt_ok = nxt.size == KEY and not (nxt == 255).any()
        if head_ok and head.tobytes() in self.at0:
            return self.at0[head.tobytes()]
        if nxt_ok and nxt.tobytes() in self.at1:
            return self.at1[nxt.tobytes()]
        if head_ok and (nxt_ok or nxt.size < KEY):
            return []
        left = stream.size - at
        return [i for i, r in enumerate(self.reads) if _match(stream, at, r) >= min(max(r.size - self.k + 1, KEY), left)]


def parse_stream(tokens: np.ndarray, index: ReadIndex, depth: int = 8) -> dict:
    """Walk a token stream (a training run's batches back to back) and
    account every base of it to a synthesized read. Returns {"taken":
    (read id, bases of it) in stream order, "bad_at": the furthest base
    offset reached where the parse failed, or None}.

    A read is whole, or cut by at most k - 1 bases (the end of its block),
    or cut anywhere by the stream's end; no read appears twice before every
    read has appeared once (an epoch). Neighbouring reads overlap (the
    writer orders them by locus), so a read can match at a wrong offset:
    the walk keeps the other choices of its last ``depth`` steps and goes
    back to them where it cannot go on (a bounded search)."""
    k = index.k
    s = expand(tokens, k)
    n = len(index.reads)
    used = np.zeros(n, np.int64)
    taken: list = []
    alts: list = []  # the untried choices of each step taken
    at = far = 0
    budget = 4 * (s.size // KEY) + 1000  # choices looked at

    def choices(pos: int) -> list:
        """Whole reads first; the cuts at a block's end are tried only
        when the walk goes back."""
        epoch = len(taken) // n
        whole, cut = [], []
        for i in index.candidates(s, pos):
            if used[i] != epoch:  # a read the synthesizer made twice is two reads
                continue
            r = index.reads[i]
            got = _match(s, pos, r)
            if pos + got == s.size or got == r.size:
                whole.append((i, got))
            cut += [(i, ln) for ln in range(min(got, r.size - 1), max(r.size - k, KEY - 1), -1)]
        return whole + cut

    while at < s.size:
        opts = choices(at)
        budget -= len(opts) + 1
        while not opts:
            if budget < 0 or not alts:
                return {"taken": taken, "bad_at": far}
            i, ln = taken.pop()
            used[i] -= 1
            at -= ln
            opts = alts.pop()
        i, ln = opts.pop(0)
        alts.append(opts)
        if len(alts) > depth:
            alts[-depth - 1] = []
        taken.append((i, ln))
        used[i] += 1
        at += ln
        far = max(far, at)
    return {"taken": taken, "bad_at": None}

