"""GF(256) erasure coding for SAGe parity extent groups.

The v2 container's self-healing layer (DESIGN.md §10) stripes parity over
each group of adjacent block extents so a damaged extent can be rebuilt
from the survivors instead of quarantining the group. Two schemes share
one code path:

  ``xor``  one parity shard per group — every coefficient is 1, so the
           parity row is the plain XOR of the group's payloads and repair
           of a single erasure is XOR of everything else (the classic
           RAID-5 layout, per extent group instead of per device stripe)
  ``rs``   ``m`` parity shards per group with Vandermonde coefficients
           ``alpha^(i*j)`` over GF(2^8) (Reed-Solomon-style striping) —
           up to ``m`` erased extents per group are recovered by solving
           the ``e x e`` linear system the surviving parity rows pin down

Payloads are treated as byte vectors; all arithmetic is vectorized numpy
over the field log/antilog tables (polynomial ``0x11D``). Encoding is
streaming-friendly: :func:`encode_parity` takes one complete group at a
time, so the writer never holds more than a chunk of parity state.

Only *erasures* are handled here — which rows are damaged is already
known exactly, because every extent carries a CRC32C (DESIGN.md §9); the
checksum layer turns corruptions into erasures and this module turns
erasures back into bytes.
"""

from __future__ import annotations

import numpy as np

#: supported parity schemes (`xor` == Reed-Solomon with one shard and
#: all-ones coefficients; kept as a named scheme for the on-disk header)
PARITY_SCHEMES = ("xor", "rs")

#: largest group size: coefficients alpha^i must be distinct, and GF(256)'s
#: multiplicative group has order 255
MAX_GROUP = 255

_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1, the AES-adjacent standard choice


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY
    exp[255:510] = exp[:255]  # wraparound so exp[log a + log b] never indexes out
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def gf_mul_row(row: np.ndarray, c: int) -> np.ndarray:
    """Multiply a uint8 vector by the scalar ``c`` in GF(256)."""
    if c == 0:
        return np.zeros_like(row)
    if c == 1:
        return row.copy()
    lc = int(GF_LOG[c])
    out = GF_EXP[GF_LOG[row] + lc]
    out[row == 0] = 0  # log(0) is undefined; 0 * c == 0
    return out


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(256) inverse of 0")
    return int(GF_EXP[255 - int(GF_LOG[a])])


def parity_coeff(j: int, i: int) -> int:
    """Coefficient of data row ``i`` in parity shard ``j``: ``alpha^(i*j)``
    (shard 0 is therefore the plain XOR row — the `xor` scheme is the
    ``m == 1`` special case of the same code)."""
    return int(GF_EXP[(i * j) % 255])


def n_shards(scheme: str, shards: int) -> int:
    """Parity shards per group for a scheme (validates the pair)."""
    if scheme not in PARITY_SCHEMES:
        raise ValueError(f"unknown parity scheme {scheme!r}; one of {PARITY_SCHEMES}")
    if scheme == "xor":
        return 1
    if not (1 <= shards <= 8):
        raise ValueError(f"rs parity needs 1 <= shards <= 8, got {shards}")
    return shards


def encode_parity(data: np.ndarray, m: int) -> np.ndarray:
    """Parity shards for one complete group.

    ``data`` is the group's payloads as a ``(k, L)`` uint8 matrix (k data
    rows of L bytes); returns the ``(m, L)`` parity matrix. A short tail
    group simply passes fewer rows — absent members contribute zeros, so
    the reader can treat every group as full-width."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if data.ndim != 2:
        raise ValueError(f"data must be (k, L), got shape {data.shape}")
    k, L = data.shape
    if k > MAX_GROUP:
        raise ValueError(f"parity group of {k} rows exceeds GF(256) limit {MAX_GROUP}")
    out = np.zeros((m, L), dtype=np.uint8)
    for j in range(m):
        acc = out[j]
        for i in range(k):
            acc ^= gf_mul_row(data[i], parity_coeff(j, i))
    return out


def recover_erasures(
    known: dict[int, np.ndarray],
    erased: list[int],
    parity: dict[int, np.ndarray],
    length: int,
) -> dict[int, np.ndarray]:
    """Rebuild erased data rows of one group from survivors + parity.

    ``known`` maps intact data row indices (position within the group) to
    their byte vectors; ``erased`` lists the missing positions; ``parity``
    maps intact parity shard indices to their byte vectors. Raises
    ``ValueError`` when the erasures exceed what the surviving shards can
    pin down (more erasures than intact parity rows, or a singular
    system). Returns ``{position: rebuilt row}``."""
    e = len(erased)
    if e == 0:
        return {}
    if e > len(parity):
        raise ValueError(
            f"{e} erasures exceed the {len(parity)} intact parity shard(s)"
        )
    # RHS of each surviving parity equation with the known rows folded in:
    #   sum_{i in erased} coeff(j, i) * D_i  =  P_j ^ sum_{known} coeff(j, i) * D_i
    rows = []
    for j in sorted(parity):
        rhs = parity[j].copy()
        for i, d in known.items():
            rhs ^= gf_mul_row(d, parity_coeff(j, i))
        rows.append((np.array([parity_coeff(j, i) for i in erased], np.uint8), rhs))
    A = np.stack([a for a, _ in rows])  # (r, e) coefficient matrix
    B = np.stack([b for _, b in rows]).astype(np.uint8)  # (r, L) byte RHS
    # Gaussian elimination over GF(256), RHS rows eliminated alongside
    r = A.shape[0]
    piv_rows: list[int] = []
    row = 0
    for col in range(e):
        p = next((i for i in range(row, r) if A[i, col]), None)
        if p is None:
            raise ValueError("singular parity system; cannot recover erasures")
        if p != row:
            A[[row, p]] = A[[p, row]]
            B[[row, p]] = B[[p, row]]
        inv = gf_inv(int(A[row, col]))
        A[row] = gf_mul_row(A[row], inv)
        B[row] = gf_mul_row(B[row], inv)
        for i in range(r):
            if i != row and A[i, col]:
                f = int(A[i, col])
                A[i] ^= gf_mul_row(A[row], f)
                B[i] ^= gf_mul_row(B[row], f)
        piv_rows.append(row)
        row += 1
    out = {}
    for k_, pos in enumerate(erased):
        rebuilt = B[piv_rows[k_]]
        if rebuilt.shape[0] != length:
            raise ValueError(
                f"parity row length {rebuilt.shape[0]} != payload length {length}"
            )
        out[pos] = rebuilt
    return out


__all__ = [
    "PARITY_SCHEMES",
    "MAX_GROUP",
    "GF_EXP",
    "GF_LOG",
    "gf_mul_row",
    "gf_inv",
    "parity_coeff",
    "n_shards",
    "encode_parity",
    "recover_erasures",
]
