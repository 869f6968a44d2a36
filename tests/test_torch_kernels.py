"""The port's CUDA kernels against their plain torch versions, on the card
(and the fused kernel B5 also against B2 followed by B3 / B4).

Every test carries the ``cuda`` marker and takes the ``cuda`` fixture, which
skips when ``torch.cuda.is_available()`` is false (decided when the test
runs, never at import). The module imports only the port, so it also runs
where JAX is not installed; on a machine with an NVIDIA GPU:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py

The kernels are built from src/repro_torch/kernels/csrc at first use. The
banded-alignment DP's cases alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py -k align

B6 and its backward kernel (every SSD case, the determinism, allow_tf32 and
refusal tests, and ops.ssd's gradients against the CPU):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py -k ssd

B6's backward kernel and the training step on the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py -k "bwd or train"

The attention and the dense and hybrid families (qwen2-1.5b, zamba2-2.7b
depth cuts at full width) against the CPU:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py -k "flash or family"

The MoE layer and the moe family (deepseek-moe-16b at full width) against
the CPU, and the layer's determinism and host-sync freedom:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py -k moe
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import decode_torch as DT
from repro_torch.core.blocks import pad_block_ids
from repro_torch.core.encoder import SageEncoder
from repro_torch.core.format import D, STREAMS
from repro_torch.core.layout import SageContainerV2, write_v2
from repro_torch.genomics.synth import make_reference, sample_read_set
from repro_torch.kernels import cuda_lib, ops, ref
from repro_torch.kernels import sage_decode as SD
from repro_torch.kernels.banded_align import _bucket, align_plan, align_rows, align_scan

from dp_cases import CARD_DP_CASES, dp_case, kernel_cells_per_thread, scan_inputs

pytestmark = pytest.mark.cuda

PROFILES = {
    "illumina": (dict(depth=3, seed=12), 4096),
    "ont": (dict(depth=1, max_reads=5, seed=11), 8192),
    "hifi": (dict(depth=1, max_reads=4, seed=11), 8192),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    cuda_lib.build_all()  # builds count as `build`: done before any test reads the counts
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def encoded(profile: str):
    """The port's SageFile of a small read set of ``profile``."""
    ref_seq = make_reference(30_000, seed=3)
    kw, token_target = PROFILES[profile]
    return SageEncoder(ref_seq, token_target=token_target).encode(sample_read_set(ref_seq, profile, **kw))


def assert_equal_dicts(a, b, keys):
    for k in keys:
        assert torch.equal(a[k].cpu(), b[k].cpu()), k


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_unpack_kernel_matches_plain(cuda, profile, tmp_path):
    sf = encoded(profile)
    write_v2(sf, tmp_path / "ds.sage2")
    r = SageContainerV2.open(tmp_path / "ds.sage2")
    packed = DT.host_to_tensor(r.gather_packed(np.arange(sf.meta.n_blocks)), cuda)
    dicts = torch.as_tensor(np.asarray(r._codec_dicts, np.uint8), device=cuda)
    widths = tuple((s, int(dict(r.layout.widths)[s])) for s in STREAMS)
    got = ops.unpack(packed, dicts, widths)
    want = ref.sage_unpack_ref(packed, dicts, widths)
    torch.cuda.synchronize()
    assert_equal_dicts(got, want, [s for s, _ in widths])


# stream widths of the Illumina container at token_target 65536 (sum 538)
ILLUMINA_WIDTHS = dict(zip(STREAMS, (24, 81, 15, 111, 21, 13, 20, 64, 24, 3, 3, 3, 42, 114)))


def codec_payloads(rng, n, widths, escape_share):
    """(n, cap) int32 codec payloads of random stream rows, encoded by the
    port's writer (``core.codec``): each stream's bytes come from 15 values
    that make its dictionary, but ``escape_share`` of them are any byte
    (escapes, mostly; more than half makes the writer store a section raw).
    Every row is used in full but the last, which is truncated to half its
    width. Returns (payloads, dicts)."""
    from repro_torch.core import codec

    rows = {}
    for s, w in widths.items():
        alphabet = rng.permutation(256)[:15].astype(np.uint8)
        by = alphabet[rng.integers(0, 15, (n, 4 * w))]
        esc = rng.random((n, 4 * w)) < escape_share
        by[esc] = rng.integers(0, 256, int(esc.sum()))
        rows[s] = np.ascontiguousarray(by).view(np.uint32).reshape(n, w)
    dicts = codec.build_stream_dicts({s: r.ravel() for s, r in rows.items()})
    used = np.array([[widths[s]] * n for s in STREAMS]).T
    used[-1] = used[-1] // 2
    words, starts, nwords = codec.encode_blocks(rows, used, codec.nibble_luts(dicts))
    cap = int(nwords.max()) + 3
    packed = np.zeros((n, cap), np.uint32)
    for b in range(n):
        packed[b, : nwords[b]] = words[starts[b] : starts[b] + nwords[b]]
    return packed.view(np.int32), dicts


def all_escape_payloads(rng, n, widths, stream):
    """Payloads whose ``stream`` section is nibble coded with every nibble an
    escape (4 * used escape bytes), the other sections raw and random."""
    ns = len(STREAMS)
    rows = []
    for _ in range(n):
        desc, nesc, body = [], [], []
        for s in STREAMS:
            u = widths[s]
            if s == stream:
                desc.append(u | (1 << 20))
                nesc.append(4 * u)
                body += [0xFFFFFFFF] * ((u + 1) // 2) + list(rng.integers(0, 2**32, u))
            else:
                desc.append(u)
                nesc.append(0)
                body += list(rng.integers(0, 2**32, u))
        rows.append(desc + nesc + body)
    assert len(rows[0]) == 2 * ns + sum(widths.values()) + (widths[stream] + 1) // 2
    return np.array(rows, np.uint64).astype(np.uint32).view(np.int32)


def hostile_payloads(rng, n):
    """Random 32-bit payloads: descriptors give used words past W_s, every
    mode (2 and 3 read as raw), escape counts past cap and negative, so
    section offsets run past cap and wrap. Several rows have every section
    nibble coded."""
    cap = 200
    packed = rng.integers(0, 2**32, (n, cap), dtype=np.uint64).astype(np.uint32)
    packed[: n // 2, : len(STREAMS)] = (packed[: n // 2, : len(STREAMS)] & 0xFFFFF) | (1 << 20)
    packed[0, len(STREAMS):2 * len(STREAMS)] = 2**31 - 1
    return packed.view(np.int32)


UNPACK_CASES = ("n1", "wide_section", "all_escapes", "all_raw", "hostile")


@pytest.mark.parametrize("case", UNPACK_CASES)
def test_unpack_kernel_matches_plain_on_edge_payloads(cuda, case):
    """B1 bit for bit against its plain version: one extent; a nibble
    section of 300 words (more than one warp's 128-word step) with
    escapes; a section of nothing but escapes; rows the writer stores all
    raw; hostile payloads of random words. One launch each."""
    rng = np.random.default_rng(UNPACK_CASES.index(case))
    widths = dict(ILLUMINA_WIDTHS)
    dicts = rng.integers(0, 256, (len(STREAMS), 16)).astype(np.uint8)
    if case == "n1":
        packed, dicts = codec_payloads(rng, 1, widths, 0.1)
    elif case == "wide_section":
        widths["lena"] = 300
        packed, dicts = codec_payloads(rng, 5, widths, 0.2)
        assert (packed[:, 3] >> 20 == 1).all()  # lena is nibble coded
    elif case == "all_escapes":
        widths["lena"] = 300
        packed = all_escape_payloads(rng, 3, widths, "lena")
    elif case == "all_raw":
        packed, dicts = codec_payloads(rng, 4, widths, 0.9)
        assert not (packed[:, : len(STREAMS)] >> 20).any()
    else:
        packed = hostile_payloads(rng, 64)
    wt = tuple(widths.items())
    packed = torch.as_tensor(packed, device=cuda)
    dicts = torch.as_tensor(dicts, device=cuda)
    DT.reset_trace_counts()
    got = ops.unpack(packed, dicts, wt)
    assert DT.trace_counts() == {"launch:sage_unpack": 1}
    want = ref.sage_unpack_ref(packed.cpu(), dicts.cpu(), wt)
    torch.cuda.synchronize()
    assert_equal_dicts(got, want, list(widths))


def test_unpack_kernel_spreads_a_group_over_the_card(cuda):
    """A 32-extent group runs as one warp per (extent, stream) on more CTAs
    than extents, with no shared memory."""
    plan = SD.unpack_plan(32)
    assert plan["grid"] * plan["threads"] // 32 >= 32 * len(STREAMS) and plan["grid"] > 32, plan
    assert plan["smem_bytes"] == 0


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_decode_kernel_matches_plain_with_invalid_lanes(cuda, profile):
    db = DT.prepare_device_blocks(encoded(profile)).to(cuda)
    padded, valid = pad_block_ids(np.arange(db.n_blocks)[::-1][:3])
    sub = DT.gather_block_arrays(db, padded, valid)
    DT.reset_trace_counts()
    got = ops.sage_decode(DT.DeviceBlocks(sub, db.caps, db.classes, db.fixed_len, len(padded), cuda))
    assert DT.trace_counts()["launch:sage_decode"] == 1
    want = DT.decode_block_arrays(sub, caps=db.caps, classes=db.classes, fixed_len=db.fixed_len)
    torch.cuda.synchronize()
    assert_equal_dicts(got, want, ("tokens", "read_pos", "read_rev", "read_start", "read_len", "read_corner"))


@pytest.mark.parametrize("k", range(1, 16))
def test_kmer_kernel_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    toks = torch.as_tensor(rng.integers(0, 5, (5, 1001)).astype(np.int8), device=cuda)
    ntok = torch.as_tensor([1001, 900, 3, 0, 64], dtype=torch.int32, device=cuda)
    for nt in (None, ntok):
        assert torch.equal(ops.kmer_tokens(toks, k, nt), ref.kmer_pack_ref(toks, k, nt))
    assert ops.kmer_tokens(toks[:0], k, ntok[:0]).shape == (0, 1001 // k)


@pytest.mark.parametrize("C", [1001, 65558, 64, 17])
@pytest.mark.parametrize("k", range(1, 16))
def test_kmer_kernel_matches_plain_on_any_int8(cuda, k, C):
    """B3 on tokens over the whole int8 range (4s and negatives included),
    rows whose length is not a multiple of k and starts at every byte
    alignment, with and without n_tokens (real counts, 0, past C): one row
    and a 256-row bucket."""
    rng = np.random.default_rng(1000 * k + C)
    for nb in (1, 256):
        toks = torch.as_tensor(rng.integers(-128, 128, (nb, C)).astype(np.int8), device=cuda)
        toks[:, rng.integers(0, C, max(1, C // 9))] = 4
        ntok = torch.as_tensor(rng.integers(0, C + k + 1, nb), dtype=torch.int32, device=cuda)
        for nt in (None, ntok):
            DT.reset_trace_counts()
            got = ops.kmer_tokens(toks, k, nt)
            assert DT.trace_counts() == {"launch:kmer_pack": 1}
            assert torch.equal(got, ref.kmer_pack_ref(toks, k, nt)), (nb, nt is None)


def test_kmer_kernel_tiles_rows_on_a_2d_grid(cuda):
    from repro_torch.kernels.reformat import kmer_plan

    plan = kmer_plan(256, 65558, 4)
    assert plan["grid"] == [-(-(65558 // 4) // plan["tile_ids"]), 256], plan
    assert plan["smem_bytes"] >= plan["tile_ids"] * 4 + 16, plan


def test_one_hot_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(-2, 7, (3, 4097)).astype(np.int8), device=cuda)
    assert torch.equal(ops.one_hot(toks), ref.one_hot_ref(toks))
    assert ops.one_hot(toks[:0]).shape == (0, 4097, 4)


def test_second_bucket_of_a_shape_builds_nothing(cuda):
    db = DT.prepare_device_blocks(encoded("illumina")).to(cuda)
    DT.decode_blocks_bucketed(db, np.arange(3))
    DT.reset_trace_counts()
    DT.decode_blocks_bucketed(db, np.arange(1, 4))
    assert DT.trace_counts() == {"launch:sage_decode": 1}


FUSED_CASES = [("2bit", None), ("kmer", 3), ("kmer", 4), ("kmer", 5), ("kmer", 15), ("onehot", None)]


@pytest.mark.parametrize("fmt,k", FUSED_CASES, ids=[f"{f}{k or ''}" for f, k in FUSED_CASES])
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_fused_kernel_matches_plain_and_two_step(cuda, profile, fmt, k):
    """B5 on permuted, repeated and invalid lanes against its plain version
    and against B2 followed by B3 / B4 on the same lanes (k = 3 and 5 leave
    a ragged tail of C % k tokens)."""
    db = DT.prepare_device_blocks(encoded(profile)).to(cuda)
    n = db.n_blocks
    lanes = np.random.default_rng(n).permutation(n)[: max(1, n - 1)]
    padded, valid = pad_block_ids(np.concatenate([lanes, lanes[:2]]))
    DT.reset_trace_counts()
    got = ops.sage_fused(db, padded, valid, fmt, k)
    assert DT.trace_counts() == {"launch:sage_fused": 1}
    want = ref.sage_fused_ref(db, padded, valid, fmt, k)
    sub = DT.gather_block_arrays(db, padded, valid)
    two = DT._fill_counts(dict(ops.sage_decode(
        DT.DeviceBlocks(sub, db.caps, db.classes, db.fixed_len, len(padded), cuda))), sub)
    if fmt == "kmer":
        two["kmer"] = ops.kmer_tokens(two["tokens"], k, two["n_tokens"])
    elif fmt == "onehot":
        two["onehot"] = ops.one_hot(two["tokens"])
    torch.cuda.synchronize()
    assert sorted(got) == sorted(want) == sorted(two)
    assert_equal_dicts(got, want, list(want))
    assert_equal_dicts(got, two, list(two))
    assert not got["n_tokens"][torch.as_tensor(valid == 0, device=cuda)].any()


def test_fused_kernel_refuses_out_of_range_ids(cuda):
    db = DT.prepare_device_blocks(encoded("illumina")).to(cuda)
    for ids in ([0, db.n_blocks], [-1, 0]):
        with pytest.raises(IndexError, match="ids must lie in"):
            ops.sage_fused(db, np.array(ids), np.ones(2, np.int32), "2bit")


def test_fused_session_read_launches_only_b5(cuda):
    from repro_torch.core import SageStore

    store = SageStore(device=cuda)
    store.register("ds", encoded("ont"))
    sess = store.session(fused=True)
    n = store.n_blocks("ds")
    for fmt in ("2bit", "kmer", "onehot"):
        sess.read("ds", (0, n), fmt, kmer_k=4)  # warm residency
        DT.reset_trace_counts()
        out = sess.read("ds", (0, n), fmt, kmer_k=4)
        torch.cuda.synchronize()
        assert DT.trace_counts() == {"launch:sage_fused": 1}, fmt
        two = store.session().read("ds", (0, n), fmt, kmer_k=4)
        assert_equal_dicts(out, two, [k for k in two if k != "block_ids"])


@functools.lru_cache(maxsize=None)
def full_width():
    """Illumina blocks at the main path's width (token_target 65536: C ~ 65 K
    tokens, hundreds of segments and mismatches a block)."""
    ref_seq = make_reference(40_000, seed=5)
    sf = SageEncoder(ref_seq, token_target=65536).encode(
        sample_read_set(ref_seq, "illumina", depth=4, seed=6))
    assert sf.meta.caps.tokens > 60_000 and sf.meta.caps.tokens % 8, sf.meta.caps
    return sf


def decode_and_fused(db, padded, valid, dev, cases, plain_db=None):
    """B2 and B5 in each (fmt, k) of ``cases`` on the same lanes, each
    against its plain version run on ``plain_db`` (default: ``db`` itself);
    B5 also against B2 -> B3 / B4."""
    plain_db = plain_db or db
    sub = DT.gather_block_arrays(db, padded, valid)
    two = ops.sage_decode(DT.DeviceBlocks(sub, db.caps, db.classes, db.fixed_len, len(padded), dev))
    psub = DT.gather_block_arrays(plain_db, padded, valid)
    want = DT.decode_block_arrays(psub, caps=db.caps, classes=db.classes, fixed_len=db.fixed_len)
    torch.cuda.synchronize()
    assert_equal_dicts(two, want, SD.OUT_KEYS)
    two = DT._fill_counts(dict(two), sub)
    for fmt, k in cases:
        got = ops.sage_fused(db, padded, valid, fmt, k)
        plain = ref.sage_fused_ref(plain_db, padded, valid, fmt, k)
        chain = dict(two)
        if fmt == "kmer":
            chain["kmer"] = ops.kmer_tokens(two["tokens"], k, two["n_tokens"])
        elif fmt == "onehot":
            chain["onehot"] = ops.one_hot(two["tokens"])
        torch.cuda.synchronize()
        assert sorted(got) == sorted(plain) == sorted(chain), fmt
        assert_equal_dicts(got, plain, list(plain))
        assert_equal_dicts(got, chain, list(chain))


FULL_CASES = [("2bit", None), ("kmer", 3), ("kmer", 4), ("kmer", 15), ("onehot", None)]


def test_decode_kernels_match_plain_on_full_width_blocks(cuda):
    """B2 and B5 (every format, k = 3, 4, 15) at C ~ 65 K with permuted,
    repeated and invalid lanes: the token walks' many runs, the ragged last
    run (C % 8 != 0) and the fast and per-token paths all land in one row."""
    db = DT.prepare_device_blocks(full_width()).to(cuda)
    n = db.n_blocks
    padded, valid = pad_block_ids(np.concatenate([np.arange(n)[::-1], [0, n - 1]]))
    assert (valid == 0).any()
    decode_and_fused(db, padded, valid, cuda, FULL_CASES)


def with_stepping_cumlen(db, steps):
    """A copy of ``db`` whose segment lengths are re-packed in one 32-bit
    width class, with length ``v`` put at segment ``j`` of block ``b`` for
    each ``(b, j, v)`` of ``steps``. A negative ``v`` makes the block's
    running token offsets (cumlen) step down, which the encoder never
    writes: the kernels then find each token's segment by a search instead
    of a cursor and take no shortcut. Returns the copy and its lengths."""
    assert not db.fixed_len
    a = dict(db.arrays)
    n_segs = a["dir"][:, D["n_segs"]].to(torch.int32)
    lens = DT.decode_adaptive(a["leng"], a["lena"], n_segs, db.classes["len"], db.caps.segs).clone()
    for b, j, v in steps:
        lens[b, j] = v
    a["lena"] = lens.contiguous()
    return dataclasses.replace(db, arrays=a, classes={**db.classes, "len": (32,)}), lens


def stepping_cases(n_segs) -> list[tuple[int, int, int]]:
    """(block, segment, length) steps of a cumlen down, at the second, a
    middle and the last segment of a block, by 1 up to nearly 2**31,
    spread over the blocks (``n_segs`` holds each block's segment count)."""
    picks = [(1, -5), ("middle", -400), ("last", -70), (2, -(2**31 - 1)), ("last", -1)]
    out = []
    for i, (where, v) in enumerate(picks):
        b = i % len(n_segs)
        n = int(n_segs[b])
        out.append((b, {"middle": n // 2, "last": n - 1}.get(where, where), v))
    return out


def assert_steps_down(lens, n_segs, steps) -> None:
    """Every block that ``steps`` touched has a cumlen that steps down."""
    for b in {s[0] for s in steps}:
        cum = np.cumsum(np.asarray(lens[b, : n_segs[b]].cpu(), np.int64))
        assert (np.diff(cum) < 0).any(), b


def test_decode_kernels_match_plain_when_cumlen_steps_down(cuda):
    """B2 and B5 (every format) on full-width blocks with negative decoded
    lengths, lanes permuted, repeated and invalid: the kernels' path for a
    cumlen that is not non-decreasing (a segment search for every token, no
    shortcut) against the plain versions. Segments that step back overlap,
    so several substitutions can land on one token; the plain versions run
    on the CPU, whose scatter applies them in order (the highest m wins, as
    in the kernels), where the card's leaves the winner unspecified."""
    host = DT.prepare_device_blocks(full_width())
    n = host.n_blocks
    n_segs = np.asarray(host.arrays["dir"])[:, D["n_segs"]]
    steps = stepping_cases(n_segs)
    bad, lens = with_stepping_cumlen(host.to(cuda), steps)
    bad_cpu, _ = with_stepping_cumlen(host.to("cpu"), steps)
    assert_steps_down(lens, n_segs, steps)
    padded, valid = pad_block_ids(np.concatenate([np.arange(n)[::-1], [0, n - 1]]))
    assert (valid == 0).any()
    decode_and_fused(bad, padded, valid, cuda, FULL_CASES, plain_db=bad_cpu)


def test_decode_kernels_are_deterministic(cuda):
    """Two launches of B2 and of B5 in each format on the same inputs give
    the same bits."""
    db = DT.prepare_device_blocks(full_width()).to(cuda)
    padded, valid = pad_block_ids(np.arange(db.n_blocks))
    sub = DT.gather_block_arrays(db, padded, valid)
    dbs = DT.DeviceBlocks(sub, db.caps, db.classes, db.fixed_len, len(padded), cuda)
    one, again = ops.sage_decode(dbs), ops.sage_decode(dbs)
    assert_equal_dicts(one, again, SD.OUT_KEYS)
    for fmt, k in (("2bit", None), ("kmer", 4), ("onehot", None)):
        one, again = (ops.sage_fused(db, padded, valid, fmt, k) for _ in range(2))
        assert_equal_dicts(one, again, list(one))


def test_decode_kernels_use_a_global_slot_when_shared_memory_is_short(cuda):
    """With caps too large for shared memory (mismatch cap raised to 20000),
    the kernels keep a block's arrays in a per-CTA slot of global scratch and
    still match their plain versions; at the fixtures' own caps they need no
    scratch."""
    db = DT.prepare_device_blocks(encoded("ont")).to(cuda)
    cons_w = db.arrays["cons"].shape[1]
    assert SD.launch_plan(db.caps, cons_w, 4, "decode", cuda)["scratch_bytes"] == 0
    big = dataclasses.replace(db, caps=dataclasses.replace(db.caps, mism=20_000))
    for kernel in SD.PLAN_KERNELS:
        plan = SD.launch_plan(big.caps, cons_w, 4, kernel, cuda)
        assert plan["slot_bytes"] > 0 and plan["scratch_bytes"] == plan["grid"] * plan["slot_bytes"], plan
    padded, valid = pad_block_ids(np.arange(big.n_blocks))
    decode_and_fused(big, padded, valid, cuda, [("2bit", None), ("kmer", 5), ("onehot", None)])


# ------------------------------------------------------------------ B6 (SSD)
# (B, nc, Q, H, P, N): mamba2-370m's serving prefill (8 prompts of 512
# tokens) and decode step (Q = 1); chunks of 2, 17 and 127 steps (the
# prefill route's tails); zamba2-2.7b's N = 64; a ragged chunk with P and N
# past one tile; odd P and N (the kernels' 4-byte copy and scalar store
# paths) on both routes
SSD_SHAPES = {"prefill": (8, 4, 128, 32, 64, 128), "decode": (8, 1, 1, 32, 64, 128),
              "q2": (2, 3, 2, 4, 64, 128), "q17": (2, 3, 17, 4, 64, 128),
              "q127": (2, 2, 127, 4, 64, 128), "zamba2": (2, 2, 128, 8, 64, 64),
              "ragged": (2, 3, 37, 3, 96, 200), "odd": (1, 2, 45, 2, 33, 27),
              "odd1": (1, 3, 1, 2, 33, 27)}
SSD_CASES = [("prefill", torch.float32, "mild"), ("prefill", torch.bfloat16, "mild"),
             ("decode", torch.float32, "mild"), ("decode", torch.bfloat16, "mild"),
             ("prefill", torch.float32, "large"), ("prefill", torch.bfloat16, "large"),
             ("ragged", torch.float32, "mild"), ("ragged", torch.bfloat16, "mild"),
             ("q2", torch.float32, "mild"), ("q17", torch.float32, "mild"),
             ("q127", torch.float32, "large"), ("zamba2", torch.float32, "mild"),
             ("zamba2", torch.bfloat16, "mild"), ("odd", torch.bfloat16, "mild"),
             ("odd1", torch.float32, "mild")]


def ssd_inputs(shape, dtype, decay, dev, seed=0):
    """x, dt, a, B, C of the intra-chunk kernel. ``large``: A down to -16 and
    dt near 2, so exp of the upper triangle overflows to +inf."""
    Bb, nc, Q, H, P, N = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((Bb, nc, Q, H, P), generator=g, device=dev).to(dtype)
    shift = 2.0 if decay == "large" else 0.0
    dt = torch.nn.functional.softplus(torch.randn((Bb, nc, Q, H), generator=g, device=dev) + shift)
    if decay == "large":
        A = -torch.linspace(1.0, 16.0, H, device=dev)
    else:
        A = -torch.exp(torch.randn((H,), generator=g, device=dev) * 0.3)
    B = torch.randn((Bb, nc, Q, H, N), generator=g, device=dev) * 0.3
    C = torch.randn((Bb, nc, Q, H, N), generator=g, device=dev) * 0.3
    return x, dt, dt * A, B, C


@pytest.mark.parametrize("name,dtype,decay", SSD_CASES,
                         ids=[f"{n}-{str(d)[6:]}-{c}" for n, d, c in SSD_CASES])
def test_ssd_intra_kernel_matches_plain(cuda, name, dtype, decay):
    """y within 1e-5 (f32) or one bf16 ulp past that (bf16: rtol 8e-3 =
    2^-7 of the value; kernel and plain round an f32 sum once), the chunk
    state within 1e-4, the total log-decay within 1e-5, no NaN."""
    from repro_torch.kernels.ssd_chunk import ssd_intra, ssd_intra_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    args = ssd_inputs(SSD_SHAPES[name], dtype, decay, cuda)
    DT.reset_trace_counts()
    with torch.no_grad():
        y, st, tot = ssd_intra(*args)
        assert DT.trace_counts() == {"launch:ssd_intra": 1}
        yp, sp, tp = ssd_intra_plain(*args)
    torch.cuda.synchronize()
    assert y.dtype == dtype and st.dtype == tot.dtype == torch.float32
    assert all(bool(torch.isfinite(t.float()).all()) for t in (y, st, tot))
    rtol = 1e-5 if dtype == torch.float32 else 8e-3
    torch.testing.assert_close(y.float(), yp.float(), rtol=rtol, atol=1e-5)
    torch.testing.assert_close(st, sp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(tot, tp, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["prefill", "decode"])
def test_ssd_intra_kernel_is_deterministic(cuda, name):
    """No atomics: two launches on the same inputs give the same bits."""
    from repro_torch.kernels.ssd_chunk import ssd_intra

    args = ssd_inputs(SSD_SHAPES[name], torch.bfloat16, "mild", cuda, seed=3)
    with torch.no_grad():
        one, two = ssd_intra(*args), ssd_intra(*args)
    for a, b in zip(one, two):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["prefill", "decode"])
def test_ssd_intra_kernel_ignores_allow_tf32(cuda, name):
    """The kernel's precision is its own: the same bits with PyTorch's TF32
    switch for matmul on and off."""
    from repro_torch.kernels.ssd_chunk import ssd_intra

    args = ssd_inputs(SSD_SHAPES[name], torch.float32, "mild", cuda, seed=4)
    was = torch.backends.cuda.matmul.allow_tf32
    try:
        outs = []
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            with torch.no_grad():
                outs.append(ssd_intra(*args))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_ssd_intra_kernel_refuses_what_it_cannot_take(cuda):
    from repro_torch.kernels.ssd_chunk import ssd_intra

    x, dt, a, B, C = ssd_inputs((1, 1, 16, 2, 8, 8), torch.float32, "mild", cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ssd_intra(x.half(), dt, a, B, C)
    with pytest.raises(ValueError, match="must be float32"):
        ssd_intra(x, dt, a, B.double(), C)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_intra(x.transpose(3, 4).contiguous().transpose(3, 4), dt, a, B, C)
    long = ssd_inputs((1, 1, 129, 2, 8, 8), torch.float32, "mild", cuda)
    with pytest.raises(ValueError, match="exceeds"):
        ssd_intra(*long)


def ssd_bwd_grads(shape, dtype, dev, seed=0):
    """dy (x's dtype), dst and dtotal of the backward kernel."""
    Bb, nc, Q, H, P, N = shape
    g = torch.Generator(device=dev).manual_seed(seed + 1000)
    dy = torch.randn((Bb, nc, Q, H, P), generator=g, device=dev).to(dtype)
    dst = torch.randn((Bb, nc, H, P, N), generator=g, device=dev)
    dtot = torch.randn((Bb, nc, H), generator=g, device=dev)
    return dy, dst, dtot


# the backward's causal tile edges inside a 16 x 8 tile: a chunk of one step,
# of 64 (half the strips) and of 120 (the last strip cut mid-tile); its
# widest launch (P 128: two head-dim chunks of du and dx, the most shared
# memory in f32), P 96 in bf16 (the second chunk re-streams B and dst), and
# heads wider than one launch holds (P 129 and 200: head-dim chunks summed)
SSD_BWD_SHAPES = dict(SSD_SHAPES, train=SSD_SHAPES["prefill"], q1=(2, 3, 1, 4, 64, 128),
                      q64=(2, 2, 64, 4, 64, 128), q120=(2, 2, 120, 4, 64, 128),
                      p128=(2, 2, 128, 2, 128, 64), p96=(2, 2, 70, 3, 96, 128),
                      p129=(1, 2, 16, 2, 129, 8), p200=(2, 2, 128, 2, 200, 64))
SSD_BWD_CASES = [("train", torch.bfloat16, "mild"), ("train", torch.float32, "mild"),
                 ("train", torch.float32, "large"), ("train", torch.bfloat16, "large"),
                 ("q2", torch.float32, "mild"), ("q17", torch.float32, "mild"),
                 ("q127", torch.float32, "large"), ("zamba2", torch.float32, "mild"),
                 ("zamba2", torch.bfloat16, "mild"), ("ragged", torch.float32, "mild"),
                 ("odd", torch.bfloat16, "mild"), ("odd1", torch.float32, "mild"),
                 ("q1", torch.bfloat16, "mild"), ("q64", torch.bfloat16, "mild"),
                 ("q64", torch.float32, "mild"), ("q120", torch.float32, "large"),
                 ("q120", torch.bfloat16, "large"), ("p128", torch.float32, "mild"),
                 ("p128", torch.bfloat16, "mild"), ("p96", torch.bfloat16, "mild"),
                 ("p129", torch.bfloat16, "mild"), ("p200", torch.float32, "large"),
                 ("p200", torch.bfloat16, "mild")]


@pytest.mark.parametrize("name,dtype,decay", SSD_BWD_CASES,
                         ids=[f"{n}-{str(d)[6:]}-{c}" for n, d, c in SSD_BWD_CASES])
def test_ssd_intra_bwd_kernel_matches_plain(cuda, name, dtype, decay):
    """B6's backward kernel against ssd_intra_bwd_plain on the card: chunks
    of 1, 2, 17, 64, 120, 127 and 128 steps, P from 33 to 200 (past 128 in
    head-dim chunks, still one counted launch), N = 8 to 200, bf16 and f32
    x, and large decay (exp of the upper triangle overflows). The f32 gradients
    within rtol 1e-5 and 1e-5·max|grad| (sums of up to Q·N products in
    another order); dx in bf16 within one bf16 ulp (rtol 8e-3); all finite."""
    from repro_torch.kernels.ssd_chunk import ssd_intra_bwd, ssd_intra_bwd_plain

    args = ssd_inputs(SSD_BWD_SHAPES[name], dtype, decay, cuda) + ssd_bwd_grads(SSD_BWD_SHAPES[name], dtype, cuda)
    DT.reset_trace_counts()
    got = ssd_intra_bwd(*args)
    assert DT.trace_counts() == {"launch:ssd_intra_bwd": 1}
    want = ssd_intra_bwd_plain(*args)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and all(t.dtype == torch.float32 for t in got[1:])
    for nm, a, b in zip(("dx", "ddt", "da", "dB", "dC"), got, want):
        assert bool(torch.isfinite(a.float()).all()), nm
        rtol = 8e-3 if a.dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=1e-5 * float(b.float().abs().max()),
                                   msg=lambda m, nm=nm: f"{nm}: {m}")


def test_ssd_intra_bwd_kernel_is_deterministic(cuda):
    """No atomics: two launches on the same inputs give the same bits."""
    from repro_torch.kernels.ssd_chunk import ssd_intra_bwd

    shape = SSD_BWD_SHAPES["train"]
    args = ssd_inputs(shape, torch.bfloat16, "mild", cuda, seed=3) + ssd_bwd_grads(shape, torch.bfloat16, cuda)
    for a, b in zip(ssd_intra_bwd(*args), ssd_intra_bwd(*args)):
        assert torch.equal(a, b)


def test_ssd_intra_bwd_kernel_ignores_allow_tf32(cuda):
    """The gradient kernel's precision is its own: the same bits with
    PyTorch's TF32 switch for matmul on and off."""
    from repro_torch.kernels.ssd_chunk import ssd_intra_bwd

    shape = SSD_BWD_SHAPES["train"]
    args = ssd_inputs(shape, torch.float32, "mild", cuda, seed=4) + ssd_bwd_grads(shape, torch.float32, cuda)
    was = torch.backends.cuda.matmul.allow_tf32
    try:
        outs = []
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            outs.append(ssd_intra_bwd(*args))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_ssd_intra_bwd_kernel_refuses_what_it_cannot_take(cuda):
    from repro_torch.kernels.ssd_chunk import ssd_intra_bwd

    shape = (1, 1, 16, 2, 8, 8)
    x, dt, a, B, C = ssd_inputs(shape, torch.float32, "mild", cuda)
    dy, dst, dtot = ssd_bwd_grads(shape, torch.float32, cuda)
    with pytest.raises(ValueError, match="dy must be"):
        ssd_intra_bwd(x, dt, a, B, C, dy.bfloat16(), dst, dtot)
    with pytest.raises(ValueError, match="dst must be"):
        ssd_intra_bwd(x, dt, a, B, C, dy, dst[..., :4], dtot)
    with pytest.raises(ValueError, match="must be float32"):
        ssd_intra_bwd(x, dt, a, B, C, dy, dst.double(), dtot)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_intra_bwd(x, dt, a, B, C, dy.transpose(3, 4).contiguous().transpose(3, 4), dst, dtot)
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        ssd_intra_bwd(x, dt, a, B, C, dy.cpu(), dst, dtot)


def test_ssd_gradients_on_card_match_cpu(cuda):
    """Gradients of ops.ssd (B6 forward and backward kernels and the
    recurrence under autograd) for x, dt, A, B, C and state0 on the card
    against the same on the CPU (plain versions): a ragged last chunk,
    within 1e-4·max|grad| (f32 sums in another order on each device, and
    the forward's 3xTF32 products)."""
    g = torch.Generator().manual_seed(6)
    Bb, S, H, P, N = 2, 300, 8, 64, 128
    ins = [torch.randn((Bb, S, H, P), generator=g),
           torch.nn.functional.softplus(torch.randn((Bb, S, H), generator=g) - 2.0),
           -torch.linspace(1.0, 16.0, H),
           torch.randn((Bb, S, H, N), generator=g) * 0.3,
           torch.randn((Bb, S, H, N), generator=g) * 0.3,
           torch.randn((Bb, H, P, N), generator=g) * 0.1]
    gy, gs = torch.randn((Bb, S, H, P), generator=g), torch.randn((Bb, H, P, N), generator=g)

    def grads(dev):
        t = [x.to(dev).requires_grad_() for x in ins]
        y, s = ops.ssd(*t[:5], 128, t[5])
        return torch.autograd.grad((y * gy.to(dev)).sum() + (s * gs.to(dev)).sum(), t)

    want = grads("cpu")
    DT.reset_trace_counts()
    got = grads(cuda)
    assert DT.trace_counts() == {"launch:ssd_intra": 1, "launch:ssd_intra_bwd": 1}
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


def test_train_step_on_card_matches_cpu(cuda):
    """One make_train_step of a 2-layer cut of mamba2-370m at full width
    (d_model 1024, vocab 50280; 2 x 256 tokens, remat on, f32 activations,
    matmul TF32 off) on the card against the CPU: loss, grad_norm and every
    leaf of the state within tests/train_cases.py's bounds. The card's path
    launches B6 forward 2 x 2 times and backward 2 times, no plain version."""
    from repro_torch.configs import get_arch

    from train_cases import compare_step, cut_batch, cut_models, one_step

    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cut, m_dev, m_cpu = cut_models(get_arch("mamba2-370m"), 2, cuda, seed=1)
        batch = cut_batch(cut, 2, 256, seed=2)
        DT.reset_trace_counts()
        card = one_step(cut, m_dev, batch, cuda)
        assert DT.trace_counts() == {"launch:ssd_intra": 4, "launch:ssd_intra_bwd": 2}
        compare_step(card, one_step(cut, m_cpu, batch, "cpu"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def test_global_norm_on_card_is_accurate_and_the_cpus(cuda):
    """The card's global norm (one multi-tensor ``_foreach_norm``) lies
    within 1e-6 of the float64 value on a leaf of 2^25 elements beside
    many small leaves, and within 1e-6 of the CPU's on the same leaves."""
    from repro_torch.training import optimizer as TO

    r = np.random.default_rng(13)
    tree = {"embed": (r.standard_normal(1 << 25) * 1e-3).astype(np.float32)}
    tree.update({f"l{i}": r.standard_normal(1 + 97 * i).astype(np.float32) for i in range(300)})
    exact = np.sqrt(sum(float(np.square(v.astype(np.float64)).sum()) for v in tree.values()))
    card = float(TO.global_norm({k: torch.from_numpy(v).to(cuda) for k, v in tree.items()}))
    cpu = float(TO.global_norm({k: torch.from_numpy(v) for k, v in tree.items()}))
    assert abs(card - exact) <= 1e-6 * exact, (card, exact)
    assert abs(card - cpu) <= 1e-6 * exact, (card, cpu)


def test_ssd_on_card_matches_cpu(cuda):
    """ops.ssd (B6 + the recurrence across chunks) on the card against the
    same call on the CPU (plain): a ragged last chunk and an initial state.
    1e-4: the recurrence's f32 cumsum and products run in another order on
    each device."""
    g = torch.Generator().manual_seed(5)
    Bb, S, H, P, N = 2, 300, 8, 64, 128
    x = torch.randn((Bb, S, H, P), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((Bb, S, H), generator=g) - 2.0)
    A = -torch.linspace(1.0, 16.0, H)
    B = torch.randn((Bb, S, H, N), generator=g) * 0.3
    C = torch.randn((Bb, S, H, N), generator=g) * 0.3
    s0 = torch.randn((Bb, H, P, N), generator=g) * 0.1
    want = ops.ssd(x, dt, A, B, C, 128, s0)
    DT.reset_trace_counts()
    with torch.no_grad():
        got = ops.ssd(*(t.to(cuda) for t in (x, dt, A, B, C)), 128, s0.to(cuda))
    assert DT.trace_counts() == {"launch:ssd_intra": 1}
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


# ------------------------------------- the dense and hybrid families on the card
@pytest.mark.parametrize("bidirectional", [False, True], ids=["causal", "bidir"])
def test_causal_flash_on_card_matches_cpu(cuda, bidirectional):
    """The attention (plain torch ops, the same code on both devices) on the
    card against the CPU at qwen2-1.5b's head shape (12 / 2 heads of 128,
    f32, 2 x 300 tokens in KV blocks of 100): the output and dq, dk, dv
    within 1e-4·max (f32 sums in another order; TF32 off)."""
    from repro_torch.models import layers as L

    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g = torch.Generator().manual_seed(7)
        q, dout = (torch.randn((2, 300, 12, 128), generator=g) for _ in range(2))
        k, v = (torch.randn((2, 300, 2, 128), generator=g) for _ in range(2))

        def run(dev):
            t = [x.to(dev).requires_grad_() for x in (q, k, v)]
            out = L.causal_flash(*t, 128, bidirectional)
            return (out.detach(), *torch.autograd.grad(out, t, dout.to(dev)))

        for a, b in zip(run(cuda), run("cpu")):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


@pytest.mark.parametrize("arch,layers", [("qwen2-1.5b", 2), ("zamba2-2.7b", 6)])
def test_family_prefill_and_decode_on_card_match_cpu(cuda, arch, layers):
    """A depth cut of qwen2-1.5b (2 layers) and zamba2-2.7b (one group of 6
    Mamba2 layers and the shared block) at full width: f32 prefill of
    2 x 96 tokens into 100 slots and four decode steps, logits and every
    cache tensor within 1e-3 of the CPU's (TF32 off; B6 on the card, its
    plain version on the CPU)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm

    from train_cases import cut_models

    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cut, m_dev, m_cpu = cut_models(get_arch(arch), layers, cuda, seed=3)
        toks = torch.as_tensor(np.random.default_rng(4).integers(0, cut.vocab, (2, 100)))
        outs = []
        for m, dev in ((m_dev, cuda), (m_cpu, "cpu")):
            lg, cache = lm.prefill(m, cut, toks[:, :96].to(dev), 100, dtype=torch.float32)
            got = [lg]
            for t in range(96, 100):
                lg, cache = lm.decode_step(m, cut, toks[:, t:t + 1].to(dev), cache, t, dtype=torch.float32)
                got.append(lg)
            got += [cache["k"], cache["v"]] + [cache["ssm"][kk] for kk in sorted(cache.get("ssm", {}))]
            outs.append(got)
        for a, b in zip(*outs):
            torch.testing.assert_close(a.cpu().float(), b.float(), rtol=1e-3, atol=1e-3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


@pytest.mark.parametrize("arch,layers", [("qwen2-1.5b", 2), ("zamba2-2.7b", 6)])
def test_family_train_step_on_card_matches_cpu(cuda, arch, layers):
    """One make_train_step of a full-width depth cut (2 x 256 tokens, remat
    on, f32 activations, TF32 off) on the card against the CPU within
    tests/train_cases.py's bounds; the hybrid's card path launches B6
    forward twice a Mamba2 layer and backward once, the dense one no
    kernel, and neither a plain version."""
    from repro_torch.configs import get_arch

    from train_cases import compare_step, cut_batch, cut_models, one_step

    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cut, m_dev, m_cpu = cut_models(get_arch(arch), layers, cuda, seed=1)
        batch = cut_batch(cut, 2, 256, seed=2)
        DT.reset_trace_counts()
        card = one_step(cut, m_dev, batch, cuda)
        n = layers if cut.family == "hybrid" else 0
        assert DT.trace_counts() == ({"launch:ssd_intra": 2 * n, "launch:ssd_intra_bwd": n} if n else {})
        compare_step(card, one_step(cut, m_cpu, batch, "cpu"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


# ------------------------------------------- the moe family (deepseek-moe-16b)
def moe_layer(dev, seed: int):
    """deepseek-moe-16b's MoE layer at full width (64 experts of d_ff 1408,
    top-6, 2 shared) as f32 parameters on ``dev``, drawn on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe as M

    cfg = get_arch("deepseek-moe-16b")
    p = M.moe_init(torch.Generator().manual_seed(seed), cfg)
    return cfg, map_tree(lambda t: t.to(dev), p)


def map_tree(fn, tree):
    """``fn`` of every tensor of a nested dict."""
    return {k: map_tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def test_moe_apply_on_card_matches_cpu(cuda):
    """moe_apply at full width, f32 (TF32 off), 2 x 256 tokens at the
    default capacity factor (pairs dropped): y within 1e-4·max|y| and aux
    within 1e-5 of the CPU's; the card routes as the CPU did, every
    difference a near tie (tests/moe_cases.py; expected: none)."""
    from repro_torch.models import moe as M

    from moe_cases import recorded, replayed

    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg, p = moe_layer("cpu", seed=5)
        x = torch.randn((2, 256, cfg.d_model), generator=torch.Generator().manual_seed(6))
        log, stats = [], {}
        with recorded(log):
            y_cpu, aux_cpu = M.moe_apply(p, x, cfg)
        assert int(M.dropped_pairs(log[0][1], cfg)) > 0
        with replayed(log, stats):
            y, aux = M.moe_apply(map_tree(lambda t: t.to(cuda), p), x.to(cuda), cfg)
        print("routing agreed", stats)
        torch.testing.assert_close(y.cpu(), y_cpu, rtol=1e-4, atol=1e-4 * float(y_cpu.abs().max()))
        assert abs(float(aux) - float(aux_cpu)) <= 1e-5
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def test_moe_apply_on_card_is_deterministic_and_never_syncs(cuda):
    """Two bf16 calls of moe_apply on the card at full width (8 x 512
    tokens, the serving prefill's shape) give the same bits: the combine
    adds each token's outputs in a fixed order, with no atomics. Neither
    call synchronizes with the host (``set_sync_debug_mode("error")``)."""
    from repro_torch.models import moe as M

    cfg, p = moe_layer(cuda, seed=7)
    pb = map_tree(lambda t: t.to(torch.bfloat16), p)
    x = torch.randn((8, 512, cfg.d_model), device=cuda, generator=torch.Generator(device=cuda).manual_seed(8))
    x = x.to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = M.moe_apply(pb, x, cfg)
        b = M.moe_apply(pb, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert bool(torch.isfinite(a[0].float()).all())


def test_moe_prefill_and_decode_on_card_match_cpu(cuda):
    """A 2-layer cut of deepseek-moe-16b at full width: f32 prefill of
    2 x 96 tokens into 100 slots and four decode steps (TF32 off), logits
    and K and V within 1e-3 of the CPU's, the card routed as the CPU was
    (every difference a near tie)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm

    from moe_cases import recorded, replayed
    from train_cases import cut_models

    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cut, m_dev, m_cpu = cut_models(get_arch("deepseek-moe-16b"), 2, cuda, seed=3)
        toks = torch.as_tensor(np.random.default_rng(4).integers(0, cut.vocab, (2, 100)))
        log, stats, outs = [], {}, []
        for m, dev, ctx in ((m_cpu, "cpu", recorded(log)), (m_dev, cuda, replayed(log, stats))):
            with ctx:
                lg, cache = lm.prefill(m, cut, toks[:, :96].to(dev), 100, dtype=torch.float32)
                got = [lg]
                for t in range(96, 100):
                    lg, cache = lm.decode_step(m, cut, toks[:, t:t + 1].to(dev), cache, t, dtype=torch.float32)
                    got.append(lg)
            outs.append(got + [cache["k"], cache["v"]])
        print("routing agreed", stats)
        for ours, cpu in zip(outs[1], outs[0]):
            torch.testing.assert_close(ours.cpu().float(), cpu.float(), rtol=1e-3, atol=1e-3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


# ------------------------------------------------------- banded-alignment DP
@pytest.mark.parametrize("case", sorted(CARD_DP_CASES))
def test_align_scan_kernel_matches_plain(cuda, case):
    """The DP kernel bit for bit against its plain version on the card, on
    every cell of moves and the last row (padded lanes included): widths
    49, 289 and 641 (the shared-memory ring) and 1023 (moves straight to
    device memory), a read shorter than the width, windows clipped at both
    consensus ends, code 4 in reads and consensus."""
    arrs, band = scan_inputs(case)
    t = [torch.from_numpy(a).to(cuda) for a in arrs]
    DT.reset_trace_counts()
    mv, last = ops.banded_align(*t, band=band)
    assert DT.trace_counts() == {"launch:align_scan": 1}
    want_mv, want_last = ref.banded_align_ref(*t, band=band)
    torch.cuda.synchronize()
    assert mv.shape == want_mv.shape and last.shape == want_last.shape
    assert torch.equal(mv, want_mv) and torch.equal(last, want_last)


def test_align_rows_on_card_matches_cpu(cuda):
    """The host wrapper on the card against the CPU: two chunks of lanes
    (one full 1024-lane bucket and a padded tail)."""
    rows, cons, cand, band = dp_case("l150_b24")
    rows, cand = np.tile(rows, (20, 1)), np.tile(cand, 20)  # 1280 lanes
    DT.reset_trace_counts()
    got = align_rows(rows, cons, cand, band, device=cuda)
    assert DT.trace_counts() == {"launch:align_scan": 2}
    want = align_rows(rows, cons, cand, band, device="cpu")
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_align_scan_kernel_plans_wavefront_layout_and_store_route(cuda):
    """The plan of the encode chunk and of every card case: a lane's band
    in one warp (threads a lane x cells a thread covers the width), the
    moves in a shared-memory ring up to width 641 and straight to device
    memory at width 1023, every lane in the grid, as the emulation's layout
    (tests/dp_cases.py kernel_cells_per_thread)."""
    plan = align_plan(1024, 150, 24, 198)
    assert plan["route"] == "ring" and plan["cells_per_thread"] == kernel_cells_per_thread(49)
    assert plan["ring_rows"] % 16 == 0 and plan["ring_rows"] >= plan["flush_steps"] + plan["cells_per_thread"] * plan["threads_per_lane"] // 2 - 1
    assert plan["double_steps"] == 150 + plan["cells_per_thread"] * plan["threads_per_lane"] // 2 - 1
    routes = {}
    for name, (L, band, lanes) in CARD_DP_CASES.items():
        width, B = 2 * band + 1, _bucket(lanes)
        plan = align_plan(B, L, band, L + 2 * band)
        assert plan["threads_per_lane"] * plan["cells_per_thread"] >= width > (plan["threads_per_lane"] - 1) * plan["cells_per_thread"]
        assert plan["threads_per_lane"] * plan["lanes_per_warp"] <= 32
        assert plan["grid"] * plan["lanes_per_cta"] >= B > (plan["grid"] - 1) * plan["lanes_per_cta"]
        assert plan["threads"] == 32 * plan["lanes_per_cta"] // plan["lanes_per_warp"]
        assert plan["smem_bytes"] == plan["lanes_per_cta"] * plan["lane_smem_bytes"] <= 232448
        routes[width] = plan["route"]
    assert routes == {49: "ring", 289: "ring", 641: "ring", 1023: "direct"}
    assert align_plan(4, 150, 600, 1350)["route"] is None  # width 1201 > 1024


def test_align_scan_kernel_refuses_what_it_cannot_take(cuda):
    arrs, band = scan_inputs("bucket5")
    t = [torch.from_numpy(a).to(cuda) for a in arrs]
    with pytest.raises(ValueError, match="int32"):
        align_scan(t[0].long(), *t[1:], band=band)
    with pytest.raises(ValueError, match="does not take"):
        align_scan(*t, band=600)  # width 1201 > 1024
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        align_scan(t[0].cpu(), *t[1:], band=band)


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_batched_encoder_on_card_writes_the_sequential_file(cuda, profile):
    """SAGe_Write's batched path on the card (DP kernel, B2 verify) writes
    the sequential encoder's SageFile."""
    ref_seq = make_reference(30_000, seed=3)
    kw, token_target = PROFILES[profile]
    rs = sample_read_set(ref_seq, profile, **kw)
    DT.reset_trace_counts()
    sf = SageEncoder(ref_seq, token_target=token_target, device=cuda).encode(rs)
    counts = DT.trace_counts()
    assert counts.get("launch:sage_decode", 0) > 0 and not any(k.startswith("plain:") for k in counts)
    if profile == "illumina":
        assert counts.get("launch:align_scan", 0) > 0
    assert sf.diff(SageEncoder(ref_seq, token_target=token_target, batched=False).encode(rs)) == []


def _refdec_multisets(sf):
    """refdec's read multiset of every block of ``sf``."""
    from repro_torch.core.bitio import unpack_2bit
    from repro_torch.core.refdec import decode_block

    cons = unpack_2bit(sf.consensus2b, sf.meta.cons_len)
    return [sorted(bytes(np.asarray(r.seq, np.uint8)) for r in decode_block(sf, b, cons))
            for b in range(sf.meta.n_blocks)]


def _assert_refdec(out, ids, want):
    toks = np.asarray(out["tokens"].cpu() if isinstance(out["tokens"], torch.Tensor) else out["tokens"])
    host = {k: np.asarray(out[k].cpu() if isinstance(out[k], torch.Tensor) else out[k])
            for k in ("read_start", "read_len", "n_reads")}
    for i, b in enumerate(np.asarray(ids)):
        n = int(host["n_reads"][i])
        got = sorted(bytes(toks[i, s:s + ln].astype(np.uint8))
                     for s, ln in zip(host["read_start"][i, :n], host["read_len"][i, :n]))
        assert got == want[int(b)], f"block {int(b)} disagrees with refdec"


def test_server_on_card_serves_what_a_cpu_server_serves(cuda, tmp_path):
    """SageServer over a CUDA store and over a CPU store, one burst of reads
    in three formats and a stream: the same chunks (numpy, or host bf16 for
    onehot), the same batcher stats, and the card's run launched kernels
    and no plain version."""
    from repro_torch.serving import SageServer, SessionPool

    sf = encoded("illumina")
    path = tmp_path / "ds.sage2"
    write_v2(sf, path)
    runs = []
    for dev in (cuda, "cpu"):
        pool = SessionPool(device=dev, group_blocks=4)
        pool.register("ds", str(path))
        srv = SageServer(pool)
        nb = pool.store.n_blocks("ds")
        hs = [srv.read("ds", (i, i + 4), fmt=f, kmer_k=k)
              for i, (f, k) in enumerate([("2bit", None), ("kmer", 4), ("onehot", None)] * 2)]
        hs.append(srv.stream("ds", (0, nb), fmt="kmer", kmer_k=4, blocks_per_fetch=3))
        DT.reset_trace_counts()
        srv.run_until_idle()
        counts = DT.trace_counts()
        srv.stop()
        runs.append(([list(h.chunks(timeout=0)) for h in hs], counts, dict(srv.batcher.stats)))
    (card, counts, st_card), (cpu, _, st_cpu) = runs
    assert not any(k.startswith("plain:") for k in counts), counts
    for k in ("launch:sage_unpack", "launch:sage_decode", "launch:kmer_pack", "launch:one_hot"):
        assert counts.get(k), (k, counts)
    for key in ("rounds", "fused_reads", "fused_read_requests", "fused_blocks"):
        assert st_card[key] == st_cpu[key], key
    want = _refdec_multisets(sf)
    for mine, theirs in zip(card, cpu):
        assert len(mine) == len(theirs) >= 1
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a["block_ids"], b["block_ids"])
            assert sorted(a["data"]) == sorted(b["data"])
            for key, v in a["data"].items():
                if isinstance(v, torch.Tensor):  # bf16 onehot: a host tensor
                    assert v.device.type == "cpu" and torch.equal(v, b["data"][key]), key
                else:
                    np.testing.assert_array_equal(v, b["data"][key], err_msg=key)
            _assert_refdec(a["data"], a["block_ids"], want)


def test_scrub_and_repair_heal_a_parity_container_behind_a_card_store(cuda, tmp_path):
    """At-rest damage in two parity groups of an xor container: a CUDA
    store's reads reconstruct in flight (two-step and fused) and equal
    refdec; the scrubber then repairs the medium, and reads after the
    repair (fresh reader, re-uploaded codec dictionaries) equal refdec."""
    from repro_torch.core import SageStore, Scrubber
    from repro_torch.testing import corrupt_extents

    sf = encoded("illumina")
    path = tmp_path / "p.sage2"
    write_v2(sf, path, parity="xor", parity_group=4)
    corrupt_extents(path, [1, 9], byte=7, bit=5)
    store = SageStore(device=cuda, group_blocks=4)
    store.register("ds", str(path))
    want = _refdec_multisets(sf)
    DT.reset_trace_counts()
    for fused in (False, True):
        out = store.session(fused=fused).read("ds", None, "kmer", kmer_k=4)
        _assert_refdec(out, out["block_ids"], want)
    assert not any(k.startswith("plain:") for k in DT.trace_counts())
    assert store.io_stats["reconstructions"] >= 2 and store.health("ds")["ok"]
    r = Scrubber(store, chunk_blocks=4).run_once("ds")
    assert r["complete"] and sorted(b for f in r["findings"] for b in f["repaired_blocks"]) == [1, 9]
    assert SageContainerV2.open(path).verify_blocks() == []
    store.evict()
    before = store.io_stats["reconstructions"]
    for fused in (False, True):
        out = store.session(fused=fused).read("ds", None, "onehot")
        _assert_refdec(out, out["block_ids"], want)
    assert store.io_stats["reconstructions"] == before  # the medium is clean now
