"""Dataset-adaptive bit-width class tuning (paper §5.1, Fig. 5 step 4).

For each guide-coded stream kind, SAGe picks a small set of bit widths and a
unary guide code (0, 10, 110, ...) assigning the shortest codes to the most
frequent widths. The paper tunes (i) how many distinct widths and (ii) their
values per read set; we reproduce that with an exact search over width
subsets driven by the bit-length histogram of the values.
"""

from __future__ import annotations

import itertools

import numpy as np


def bitlen(values: np.ndarray) -> np.ndarray:
    """Minimal bits to represent each value (0 -> 0 bits)."""
    v = np.asarray(values, dtype=np.uint64)
    out = np.zeros(v.shape, dtype=np.int64)
    x = v.copy()
    for s in (32, 16, 8, 4, 2, 1):
        hi = x >= (np.uint64(1) << np.uint64(s))
        out += np.where(hi, s, 0)
        x = np.where(hi, x >> np.uint64(s), x)
    return out + (v > 0)


def tune_classes(values: np.ndarray, max_classes: int = 4) -> tuple[int, ...]:
    """Choose the width set minimizing total guide+value bits.

    Returns widths ordered by descending usage (class 0 = cheapest guide
    code), matching the paper's frequency-ordered unary refinement (§5.1.1).
    """
    values = np.asarray(values, dtype=np.uint64).ravel()
    if values.size == 0:
        return (8,)
    bl = bitlen(values)
    maxw = int(bl.max())
    hist = np.bincount(bl, minlength=maxw + 1).astype(np.int64)  # index=bitlen
    # candidate widths: all bitlens that occur, always including maxw
    cand = np.nonzero(hist)[0].tolist()
    if maxw not in cand:
        cand.append(maxw)
    cand = sorted(set(int(c) for c in cand))
    # value of width w covers all bitlens <= w; cost per value = guide + w
    best_cost, best = None, None
    ncand = len(cand)
    for k in range(1, min(max_classes, ncand) + 1):
        # widths chosen from cand; must include >= maxw coverage
        for subset in itertools.combinations(cand, k):
            if subset[-1] < maxw:
                continue
            widths = list(subset)
            # usage per class: values fall to smallest sufficient width
            usage = []
            lo = 0
            for w in widths:
                usage.append(int(hist[lo : w + 1].sum()))
                lo = w + 1
            order = np.argsort(-np.asarray(usage), kind="stable")
            cost = 0
            for ci, oi in enumerate(order):
                cost += usage[oi] * (ci + 1 + widths[oi])
            if best_cost is None or cost < best_cost:
                best_cost = cost
                best = tuple(int(widths[oi]) for oi in order)
        if ncand <= k:
            break
    assert best is not None
    return best


def assign_classes(values: np.ndarray, widths: tuple[int, ...]) -> np.ndarray:
    """Class index (into ``widths``) for each value: smallest sufficient
    width, breaking ties toward the cheaper guide code."""
    values = np.asarray(values, dtype=np.uint64).ravel()
    bl = bitlen(values)
    w = np.asarray(widths, dtype=np.int64)
    # cost of using class c for a value: guide (c+1) + width, but only classes
    # with width >= bitlen are feasible. Pick feasible class minimizing cost;
    # since widths are usage-ordered, first feasible is optimal in guide bits,
    # but a later class might have smaller width... total cost = c+1+w[c].
    feas = w[None, :] >= bl[:, None]  # (n, k)
    cost = np.where(feas, np.arange(w.size)[None, :] + 1 + w[None, :], 1 << 30)
    return np.argmin(cost, axis=1).astype(np.int64)


def guide_cost_bits(classes: np.ndarray) -> int:
    return int((classes + 1).sum())
