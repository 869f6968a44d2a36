"""Block decode (B2) of the PyTorch port against the JAX package, on the
illumina / ont / hifi cases of torch_cases.py.

The port's plain versions run here (CPU tensors); the JAX side runs its
vmap decoder and its Pallas kernels in interpret mode. Integer paths, so
the bar is bit identity. The CUDA kernels' token pass (events sorted by
token tile, their carries, segment-start prefixes, the int8 row and the
reverse-complement pass; csrc/sage_decode_body.cuh) cannot run here, so a
numpy model of it is held against the plain decode at several tile sizes."""

import jax
import numpy as np
import pytest
import torch

from repro.core.decode_jax import (
    DeviceBlocks as RefDeviceBlocks,
    decode_blocks_bucketed as ref_bucketed,
    decode_file_jax,
    pad_block_ids as ref_pad_block_ids,
    prepare_device_blocks as ref_prepare,
)
from repro.kernels.ref import sage_decode_ref
from repro.kernels.sage_decode import sage_decode_arrays as ref_pallas_decode

from repro_torch.convert import device_blocks_from_reference
from repro_torch.core import decode_torch as DT
from repro_torch.core.format import D
from repro_torch.distributed.sharding import BlockMesh
from repro_torch.kernels import sage_decode as SD

from conftest import multiset
from test_torch_kernels import assert_steps_down, stepping_cases, with_stepping_cumlen
from torch_cases import PROFILES, encoded_case

KEYS = ("tokens", "n_tokens", "read_pos", "read_rev", "read_start", "read_len",
        "read_corner", "n_reads")


def np_tree(d):
    return {k: np.asarray(v) for k, v in d.items()}


def assert_same(ours: dict, theirs: dict, keys=KEYS):
    for k in keys:
        a = ours[k].numpy() if isinstance(ours[k], torch.Tensor) else np.asarray(ours[k])
        b = np.asarray(theirs[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.fixture(scope="module", params=PROFILES)
def encoded(request):
    return encoded_case(request.param)


def test_plain_decode_matches_vmap_and_oracle(encoded):
    rs, sf = encoded
    db_ref = ref_prepare(sf)
    theirs = np_tree(decode_file_jax(db_ref))
    db = device_blocks_from_reference(db_ref, "cpu")
    ours = DT.decode_block_arrays(db.arrays, caps=db.caps, classes=db.classes, fixed_len=db.fixed_len)
    assert_same(ours, theirs)
    got = []
    for bi in range(db.n_blocks):
        toks = ours["tokens"][bi].numpy()
        for r in range(int(ours["n_reads"][bi])):
            st, ln = int(ours["read_start"][bi, r]), int(ours["read_len"][bi, r])
            got.append(toks[st : st + ln].astype(np.uint8))
    assert multiset(got) == multiset(rs.reads)


def test_padded_bucket_matches_pallas_with_invalid_lanes(encoded):
    _, sf = encoded
    db_ref = ref_prepare(sf)
    nb = db_ref.n_blocks
    ids = np.array([nb - 1, 0, nb // 2][: max(1, min(3, nb))], dtype=np.int64)
    padded, valid = ref_pad_block_ids(ids)
    assert (valid == 0).any()
    sub_ref = {k: v[padded] for k, v in db_ref.arrays.items()}
    sub_ref["valid"] = valid[:, None].astype(np.int32)
    theirs = np_tree(ref_pallas_decode(sub_ref, caps=db_ref.caps, classes=db_ref.classes,
                                       fixed_len=db_ref.fixed_len, interpret=True))
    db = device_blocks_from_reference(db_ref, "cpu")
    sub = DT.gather_lanes(db, padded, db.device, valid=valid)
    ours = SD.sage_decode_arrays(sub, caps=db.caps, classes=db.classes, fixed_len=db.fixed_len)
    assert_same(ours, theirs, SD.OUT_KEYS)
    lane = int(np.flatnonzero(valid == 0)[0])
    assert (ours["tokens"][lane] == DT.PAD_BASE).all()
    assert (ours["read_pos"][lane] == -1).all()


def test_invalid_lanes_do_not_depend_on_occupant(encoded):
    _, sf = encoded
    db = device_blocks_from_reference(ref_prepare(sf), "cpu")
    valid = np.array([1, 1, 0, 0], np.int32)
    outs = [DT.decode_blocks_sharded(db, np.array([0, 0, occ, occ]), valid, mesh=BlockMesh((db.device,)))
            for occ in (0, db.n_blocks - 1)]
    assert_same(outs[0], {k: v.numpy() for k, v in outs[1].items()})


def test_bucketed_decode_matches_reference(encoded):
    _, sf = encoded
    db_ref = ref_prepare(sf)
    db = device_blocks_from_reference(db_ref, "cpu")
    nb = db.n_blocks
    ids = (np.arange(5) * 7) % nb
    theirs = np_tree(ref_bucketed(db_ref.to_device(), ids))
    ours = DT.decode_blocks_bucketed(db, ids)
    assert_same(ours, theirs)
    empty = DT.decode_blocks_bucketed(db, np.array([], np.int64))
    assert_same(empty, np_tree(ref_bucketed(db_ref.to_device(), np.array([], np.int64))))


def test_substitution_scatter_targets_are_unique(encoded, monkeypatch):
    """sub_t is a scatter-SET: with two substitutions on one token the
    winner would be unspecified (and could differ between JAX, torch and
    CUDA). Assert the fixtures never hit that case."""
    _, sf = encoded
    db = device_blocks_from_reference(ref_prepare(sf), "cpu")
    orig = DT._scatter
    seen = []

    def checked(size, fill, idx, vals, reduce):
        if reduce == "set":
            for row in idx:
                kept = row[row < size]
                assert kept.unique().numel() == kept.numel()
            seen.append(int((idx < size).sum()))
        return orig(size, fill, idx, vals, reduce)

    monkeypatch.setattr(DT, "_scatter", checked)
    DT.decode_block_arrays(db.arrays, caps=db.caps, classes=db.classes, fixed_len=db.fixed_len)
    assert len(seen) == 1 and seen[0] > 0


def test_extract_fields_wraps_like_int32():
    """A 32-bit field >= 2**31 comes back negative (jnp int32 cast)."""
    import jax.numpy as jnp
    from repro.core.decode_jax import extract_fields as ref_extract

    words = np.array([0x89ABCDEF, 0xFEDCBA98, 0x01234567, 0x80000000], np.uint32)
    starts = np.array([0, 4, 31, 32, 64, 95, 96, 200, -5], np.int32)
    widths = np.array([32, 28, 32, 1, 32, 2, 0, 32, 32], np.int32)
    theirs = np.asarray(jax.jit(ref_extract)(jnp.asarray(words), jnp.asarray(starts), jnp.asarray(widths)))
    ours = DT.extract_fields(DT.host_to_tensor(words, "cpu"), torch.as_tensor(starts), torch.as_tensor(widths))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert (theirs < 0).any()


# --------------------------------------------------------------------------
# model of the CUDA kernels' token pass (sage_decode_body.cuh)
# --------------------------------------------------------------------------

def wrap32(x):
    """int32 two's-complement wraparound of int64 values."""
    return ((np.asarray(x, np.int64) + 2**31) % 2**32) - 2**31


def lane_quantities(blk, caps, classes, fixed_len) -> dict[str, np.ndarray]:
    """Per-segment, per-read and per-mismatch quantities of every lane: what
    the kernels' phases before the token pass compute (decode_block_arrays'
    own steps up to its token-axis scatters)."""
    I32 = torch.int32
    R, M = caps.segs, max(caps.mism, 1)
    I, U = max(caps.indel, 1), max(caps.multi, 1)
    row = blk["dir"].to(I32)
    nb = row.shape[0]
    col = lambda name: row[:, D[name]]  # noqa: E731
    v = blk["valid"].to(I32)[:, 0]
    n_segs, n_mism, n_tok, n_reads = (col(k) * v for k in ("n_segs", "n_mism", "n_tokens", "n_reads"))
    ar = lambda n: torch.arange(n, dtype=I32).expand(nb, n)  # noqa: E731
    seg_mask, mism_mask = ar(R) < n_segs[:, None], ar(M) < n_mism[:, None]
    seg_i = seg_mask.to(I32)
    cs, take, adaptive = DT._cumsum, DT._take, DT.decode_adaptive
    map_vals = adaptive(blk["mapg"], blk["mapa"], n_segs, classes["map"], R)
    if fixed_len:
        lens = torch.where(seg_mask, fixed_len, 0).to(I32)
    else:
        lens = torch.where(seg_mask, adaptive(blk["leng"], blk["lena"], n_segs, classes["len"], R), 0)
    cnts = torch.where(seg_mask, adaptive(blk["cntg"], blk["cnta"], n_segs, classes["cnt"], R), 0)
    rfl = DT.extract_fields(blk["rfl"], 3 * ar(R), 3)
    rev, cont, corner = (rfl & 1) & seg_i, ((rfl >> 1) & 1) & seg_i, ((rfl >> 2) & 1) & seg_i
    acc = col("base_pos")[:, None] + cs(torch.where(seg_mask & (cont == 0) & (corner == 0), map_vals, 0))
    pos = torch.where(cont == 1, acc + ((map_vals >> 1) ^ -(map_vals & 1)), acc)
    starts = cs(lens) - lens
    cnt_ends = cs(cnts)
    seg_m = torch.searchsorted(cnt_ends, ar(M).contiguous(), right=True).to(I32).clamp(0, R - 1)
    first_m = take(cnt_ends - cnts, seg_m)
    p_m = DT._seg_cumsum(adaptive(blk["mpg"], blk["mpa"], n_mism, classes["mp"], M), first_m)
    mbb = torch.where(mism_mask, DT.extract_fields(blk["mbb"], 2 * ar(M), 2), 0)
    is_ind = torch.where(mism_mask, (mbb == 3).to(I32), 0)
    idg_m = take(DT.extract_fields(blk["idg"], 2 * ar(I), 2), (cs(is_ind) - is_ind).clamp(0, I - 1))
    is_ins, is_multi = is_ind * (idg_m & 1), is_ind * ((idg_m >> 1) & 1)
    idl = take(DT.extract_fields(blk["idl"], 8 * ar(U), 8), (cs(is_multi) - is_multi).clamp(0, U - 1))
    ilen = torch.where(is_multi == 1, idl, 1) * is_ind
    ins_len = torch.where(is_ins == 1, ilen, 0)
    del_len = torch.where((is_ind == 1) & (is_ins == 0), ilen, 0)
    dshift = del_len - ins_len
    cursor = take(pos, seg_m) + p_m + DT._seg_cumsum(dshift, first_m) - dshift
    idx = cursor.clamp(0, caps.window - 1).to(torch.int64)
    cons_b = ((torch.gather(DT._u32(blk["cons"]), -1, idx >> 4) >> (2 * (idx & 15))) & 3).to(I32)
    esc_lens = torch.where(corner == 1, lens, 0)
    rf = (seg_mask & (cont == 0)).to(I32)
    rid = cs(rf) - rf
    rid_first = torch.where(rf == 1, rid, R)
    q = dict(
        n_tok=n_tok, n_reads=n_reads, n_mism=n_mism, cons_start=col("cons_start"),
        starts=starts, cum=cs(lens), pos=pos, corner=corner, esc_start=cs(esc_lens) - esc_lens, rid=rid,
        rd_rev=DT._scatter(R, 0, rid_first, rev, "amax"),
        rd_start=DT._scatter(R, 0, rid_first, starts, "amax"),
        rd_len=DT._scatter(R, 0, torch.where(seg_mask, rid, R), lens, "add"),
        rd_pos=DT._scatter(R, -1, rid_first, torch.where(corner == 1, -1, pos), "amax"),
        rd_corner=DT._scatter(R, 0, rid_first, corner, "amax"),
        t_m=take(starts, seg_m) + p_m, mbb=mbb, sub_base=mbb + (mbb >= cons_b).to(I32),
        is_ins=is_ins, ins_len=ins_len, del_len=del_len, ibs_off=cs(ins_len) - ins_len,
    )
    return {k: t.numpy().astype(np.int64) for k, t in q.items()}


def field(words, start, width):
    """extract_fields of one packed row at the int64 bit offsets ``start``."""
    w = np.asarray(words, np.int64) & 0xFFFFFFFF
    i = np.clip(start >> 5, 0, w.size - 2)
    sh = start & 31
    hi = np.where(sh == 0, 0, (w[i + 1] << (32 - np.maximum(sh, 1))) & 0xFFFFFFFF)
    return wrap32(((w[i] >> sh) | hi) & ((1 << width) - 1))


RUN = 8  # tokens a kernel thread decodes at once (sage_decode_body.cuh)


def tiled_token_pass(q, b, blk, caps, tile):
    """Lane ``b``'s outputs the way the kernels build them: the mismatches
    sorted by token in a counting sort over tiles of ``tile`` tokens, their
    carries (deletion shift before each event; insertion marks with the
    covered tokens before each), the carries at every segment's first token,
    the pre-complement int8 row in runs of RUN tokens, then the reverse
    complement gathered from that row. A run takes the kernels' shortcut
    where they do (consecutive consensus codes; whole-read pieces of the row)
    and the per-token closed forms elsewhere. Returns the outputs and the
    count of runs on each path."""
    R, M, C = caps.segs, max(caps.mism, 1), caps.tokens
    g = {k: v[b] for k, v in q.items()}
    n_tok = int(g["n_tok"])
    ms = np.arange(int(np.clip(g["n_mism"], 0, M)))
    tclip = np.clip(g["t_m"][ms], 0, C - 1)
    # counting sort by tile, then a rank by (token, m) inside each bucket
    bucket = tclip // tile
    first = np.concatenate([[0], np.cumsum(np.bincount(bucket, minlength=-(-C // tile)))])
    order = np.empty(ms.size, np.int64)
    for m in ms:
        mates = ms[bucket == bucket[m]]
        rank = ((tclip[mates] < tclip[m]) | ((tclip[mates] == tclip[m]) & (mates < m))).sum()
        order[first[bucket[m]] + rank] = m
    ev_pos = tclip[order]
    ev_dp = wrap32(np.concatenate([[0], np.cumsum(g["del_len"][order])]))
    ev_sub = np.where(g["mbb"][order] < 3, g["sub_base"][order], -1)
    marks = {}  # token -> (max t_m, max length, max offset) of its insertions
    for m in order[g["is_ins"][order] == 1]:
        v, ln, o = marks.get(int(tclip[m]), (-1, 0, 0))
        marks[int(tclip[m])] = (max(v, g["t_m"][m]), max(ln, g["ins_len"][m]), max(o, g["ibs_off"][m]))
    mk = np.array([(p, *x) for p, x in sorted(marks.items()) if x[0] >= 0], np.int64).reshape(-1, 4)
    mk_q, mk_v, mk_e, mk_o = mk[:, 0], mk[:, 1], mk[:, 1] + mk[:, 2], mk[:, 3]
    nxt = np.append(mk_q[1:], np.iinfo(np.int64).max)
    mk_ic = np.concatenate([[0], np.cumsum(np.maximum(0, np.minimum(nxt, mk_e) - mk_q))])
    pick = lambda a, j: a[np.maximum(j, 0)] if a.size else np.zeros_like(j)  # noqa: E731

    def excl_cons(x):  # tokens before x that consume a consensus base
        X = np.maximum(0, np.minimum(x, n_tok))
        j = np.searchsorted(mk_q, X, "left") - 1
        return X - np.where(j >= 0, pick(mk_ic, j) + np.maximum(0, np.minimum(X, pick(mk_e, j)) - pick(mk_q, j)), 0)

    f = np.clip(g["starts"], 0, C - 1)  # each segment's first token, wherever it lies
    seg_fd, seg_fc = ev_dp[np.searchsorted(ev_pos, f, "left")], excl_cons(f)
    cw = np.asarray(blk["cons"][b], np.int64) & 0xFFFFFFFF
    cons_at = lambda i: (cw[i >> 4] >> (2 * (i & 15))) & 3  # noqa: E731
    E = g["cum"]
    mono = bool((np.diff(E) >= 0).all())

    def upper_bound(x):  # the kernels' bisection, which on an unsorted E differs
        lo, hi = 0, R  # from numpy's (it narrows its bounds from key to key)
        while lo < hi:
            mid = (lo + hi) >> 1
            lo, hi = (mid + 1, hi) if E[mid] <= x else (lo, mid)
        return lo

    def seg_of(t):
        su = np.searchsorted(E, t, "right") if mono else np.array([upper_bound(x) for x in t])
        return np.clip(su, 0, R - 1)

    def row_tokens(t):  # the per-token closed forms
        seg = seg_of(t)
        k = np.searchsorted(mk_q, t, "right") - 1
        inside = (k >= 0) & (t < pick(mk_e, k)) & (t < n_tok)
        c = np.searchsorted(ev_pos, t, "right")
        sub = np.full(t.size, -1)
        for i in np.flatnonzero(c > 0):  # the last substitution at t (the highest m)
            j = c[i] - 1
            while j >= 0 and ev_pos[j] == t[i] and ev_sub[j] < 0:
                j -= 1
            if j >= 0 and ev_pos[j] == t[i]:
                sub[i] = ev_sub[j]
        cidx = wrap32(g["pos"][seg] + wrap32(excl_cons(t) - seg_fc[seg]) + wrap32(ev_dp[c] - seg_fd[seg]))
        cons = cons_at(np.clip(cidx, 0, caps.window - 1))
        esc = field(blk["esc"][b], 3 * np.clip(wrap32(g["esc_start"][seg] + t - g["starts"][seg]), 0, caps.escb), 3)
        ibs = field(blk["ibs"][b], 2 * np.clip(wrap32(pick(mk_o, k) + t - pick(mk_v, k)), 0, caps.insb), 2)
        return np.where(g["corner"][seg] == 1, esc, np.where(inside, ibs, np.where(sub >= 0, sub, cons)))

    def row_shortcut(a):  # a run of consecutive consensus codes, or None
        last = a + RUN - 1
        c, k = np.searchsorted(ev_pos, a, "left"), np.searchsorted(mk_q, a, "left")
        su = np.searchsorted(E, a, "right")
        sg = min(su, R - 1)
        if not (mono and last < C and (c == ev_pos.size or ev_pos[c] > last)
                and (k == mk_q.size or mk_q[k] > last) and (k == 0 or mk_e[k - 1] <= a)
                and (su == R or last < E[su]) and g["corner"][sg] == 0 and (last < n_tok or a >= n_tok)):
            return None
        past = a >= n_tok
        ec = excl_cons(n_tok) if past else a if k == 0 else a - (mk_ic[k - 1] + max(0, min(a, mk_e[k - 1]) - mk_q[k - 1]))
        idx = int(wrap32(g["pos"][sg] + wrap32(ec - seg_fc[sg]) + wrap32(ev_dp[c] - seg_fd[sg])))
        if past:
            return np.full(RUN, cons_at(np.clip(idx, 0, caps.window - 1)))
        return cons_at(idx + np.arange(RUN)) if 0 <= idx <= caps.window - RUN else None

    def out_tokens(t, row):  # the per-token reverse complement
        rid = g["rid"][seg_of(t)]
        rev, rs = g["rd_rev"][rid] == 1, g["rd_start"][rid]
        o = row[np.clip(np.where(rev, wrap32(rs + g["rd_len"][rid] - 1 - (t - rs)), t), 0, C - 1)].astype(np.int64)
        return np.where(t < n_tok, np.where(rev & (o < 4), 3 - o, o), 4)

    def out_shortcut(a, row):  # whole-read pieces of the row, or None
        last = a + RUN - 1
        if last >= C or not (a >= n_tok or (mono and last < n_tok)):
            return None
        if a >= n_tok:
            return np.full(RUN, 4)
        parts, t1 = [], a
        while t1 <= last:
            su = np.searchsorted(E, t1, "right")
            t2 = min(last, E[su] - 1) if su < R else last
            rid = g["rid"][min(su, R - 1)]
            if g["rd_rev"][rid] != 1:
                parts.append(row[t1:t2 + 1].astype(np.int64))
            else:
                k0 = int(wrap32(2 * g["rd_start"][rid] + wrap32(g["rd_len"][rid] - 1)))
                hi, lo = k0 - t1, k0 - t2
                if lo < 0 or hi > C - 1 or hi < RUN - 1:
                    return None
                o = row[lo:hi + 1][::-1].astype(np.int64)
                parts.append(np.where(o < 4, 3 - o, o))
            t1 = t2 + 1
        return np.concatenate(parts)

    runs = {"row_shortcut": 0, "row_per_token": 0, "out_shortcut": 0, "out_per_token": 0}
    row = np.zeros(C, np.int8)
    out = np.full(C, 4, np.int8)
    for name, arr, shortcut, per_token in (("row", row, row_shortcut, row_tokens),
                                           ("out", out, lambda a: out_shortcut(a, row),
                                            lambda t: out_tokens(t, row))):
        for a in range(0, C, RUN):
            t = np.arange(a, min(C, a + RUN))
            v = shortcut(a)
            runs[f"{name}_shortcut" if v is not None else f"{name}_per_token"] += 1
            arr[t] = v if v is not None else per_token(t)
    rm = np.arange(R) < g["n_reads"]
    return {"tokens": out,
            "read_pos": np.where(rm, wrap32(g["rd_pos"] + np.where(g["rd_pos"] >= 0, g["cons_start"], 0)), -1),
            "read_rev": np.where(rm, g["rd_rev"], 0), "read_start": np.where(rm, g["rd_start"], 0),
            "read_len": np.where(rm, g["rd_len"], 0), "read_corner": np.where(rm, g["rd_corner"], 0)}, runs


def model_runs(db, tile) -> dict[str, int]:
    """Hold :func:`tiled_token_pass` against decode_block_arrays on every
    block of ``db`` and two invalid lanes, at ``tile`` tokens a tile (None:
    one tile of C); returns the count of runs on each path."""
    nb = db.n_blocks
    ids = np.concatenate([np.arange(nb), [nb - 1, 0]])
    valid = np.concatenate([np.ones(nb, np.int32), [0, 0]])
    sub = DT.gather_lanes(db, ids, db.device, valid=valid)
    want = DT.decode_block_arrays(sub, caps=db.caps, classes=db.classes, fixed_len=db.fixed_len)
    q = lane_quantities(sub, db.caps, db.classes, db.fixed_len)
    blk = {k: v.numpy() for k, v in sub.items()}
    C = db.caps.tokens
    assert C % 64 and C % 1000
    runs = dict.fromkeys(("row_shortcut", "row_per_token", "out_shortcut", "out_per_token"), 0)
    for b in range(ids.size):
        got, lane_runs = tiled_token_pass(q, b, blk, db.caps, tile or C)
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[k][b].numpy(), err_msg=f"lane {b} {k}")
        runs = {k: runs[k] + lane_runs[k] for k in runs}
    return runs


TILES = pytest.mark.parametrize("tile", [64, 1000, None], ids=["tile64", "tile1000", "tileC"])


@TILES
def test_tiled_token_pass_matches_plain_decode(encoded, tile):
    """The kernels' token pass, modelled in numpy, equals decode_block_arrays
    bit for bit on every block and on invalid lanes, at tile sizes that do
    not divide C and at one tile of C tokens, with runs on both the
    kernels' shortcuts and their per-token path."""
    _, sf = encoded
    runs = model_runs(device_blocks_from_reference(ref_prepare(sf), "cpu"), tile)
    assert all(runs.values()), runs  # both paths of both walks ran


@TILES
def test_tiled_token_pass_matches_plain_decode_when_cumlen_steps_down(tile):
    """The same model on illumina blocks with negative decoded lengths, so
    that a block's cumlen steps down: its segment search for every token
    and its per-token path, as the kernels run them for such a block."""
    _, sf = encoded_case("illumina")
    db = device_blocks_from_reference(ref_prepare(sf), "cpu")
    n_segs = db.arrays["dir"][:, D["n_segs"]].numpy()
    steps = stepping_cases(n_segs)
    bad, lens = with_stepping_cumlen(db, steps)
    assert_steps_down(lens, n_segs, steps)
    assert model_runs(bad, tile)["row_per_token"] > 0


def test_plain_decode_matches_reference_when_cumlen_steps_down(monkeypatch):
    """The port's plain decode against the JAX package's vmap decoder
    (``repro.kernels.ref.sage_decode_ref``) on illumina blocks whose cumlen
    steps down, the same arrays handed to both as numpy: overlapping
    segments put substitutions with different bases on one token, so the
    two scatter-SETs must pick the same winner for every output bit to
    agree."""
    _, sf = encoded_case("illumina")
    db_ref = ref_prepare(sf)
    db = device_blocks_from_reference(db_ref, "cpu")
    n_segs = db.arrays["dir"][:, D["n_segs"]].numpy()
    steps = stepping_cases(n_segs)
    bad, lens = with_stepping_cumlen(db, steps)
    assert_steps_down(lens, n_segs, steps)
    arrays = {k: (v.numpy() if k == "dir" else v.numpy().view(np.uint32)) for k, v in bad.arrays.items()}
    theirs = np_tree(sage_decode_ref(RefDeviceBlocks(
        arrays=arrays, caps=db_ref.caps, classes=bad.classes, fixed_len=db_ref.fixed_len,
        n_blocks=db_ref.n_blocks)))
    orig = DT._scatter
    conflicts = []

    def counted(size, fill, idx, vals, reduce):
        if reduce == "set":
            for row, v in zip(idx.tolist(), vals.expand_as(idx).tolist()):
                bases = {}
                for t, x in zip(row, v):
                    if t < size:
                        bases.setdefault(t, set()).add(x)
                conflicts.append(sum(len(x) > 1 for x in bases.values()))
        return orig(size, fill, idx, vals, reduce)

    monkeypatch.setattr(DT, "_scatter", counted)
    ours = DT.decode_block_arrays(bad.arrays, caps=bad.caps, classes=bad.classes, fixed_len=bad.fixed_len)
    assert sum(conflicts) > 0  # some token has substitutions that disagree
    assert_same(ours, theirs)
