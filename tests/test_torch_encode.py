"""Batched SAGe_Write of the PyTorch port against the JAX package, on the CPU:
the banded DP's plain version and host wrapper, the batched mapper, and the
batched encoder (every opt_level, fallback reads, verify demotion), bit for
bit on the same seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.encoder as ref_enc_mod
from repro.core import SageStore as RefStore
from repro.core.encoder import SageEncoder as RefEncoder
from repro.genomics.batch_map import batch_map_reads as ref_batch_map
from repro.genomics.mapper import ReadMapper as RefMapper
from repro.genomics.synth import ReadSet as RefReadSet
from repro.genomics.synth import make_reference, sample_read_set
from repro.kernels.banded_align import _align_scan
from repro.kernels.banded_align import align_rows as ref_align_rows

import repro_torch.core.encoder as pt_enc_mod
from repro_torch.core import SageStore
from repro_torch.core.decode_torch import reset_trace_counts, trace_counts
from repro_torch.core.encoder import SageEncoder
from repro_torch.genomics.batch_map import batch_map_reads
from repro_torch.genomics.mapper import ReadMapper
from repro_torch.genomics.synth import ReadSet
from repro_torch.kernels.banded_align import align_rows, align_scan, align_scan_plain

from dp_cases import DP_CASES, WAVEFRONT_CASES, dp_case, kernel_cells_per_thread, scan_inputs, wavefront_scan
from test_encode_batch_parity import _mixed_read_set
from torch_cases import encoded_case, reference

INT_STATS = ("n_escaped", "verify_rounds", "n_batch_mapped", "n_fallback")


def pt_read_set(rs) -> ReadSet:
    return ReadSet(reads=rs.reads, quals=rs.quals, kind=rs.kind, profile=rs.profile)


# ------------------------------------------------------------- banded DP
@pytest.mark.parametrize("case", sorted(DP_CASES))
def test_align_scan_plain_matches_reference(case):
    arrs, band = scan_inputs(case)
    want_mv, want_last = _align_scan(*(jnp.asarray(a) for a in arrs), band=band)
    reset_trace_counts()
    mv, last = align_scan(*(torch.from_numpy(a) for a in arrs), band=band)
    assert trace_counts() == {"plain:align_scan": 1}
    assert mv.dtype == torch.uint8 and last.dtype == torch.int32
    np.testing.assert_array_equal(mv.numpy(), np.asarray(want_mv))
    np.testing.assert_array_equal(last.numpy(), np.asarray(want_last))


@pytest.mark.parametrize("case", sorted(WAVEFRONT_CASES))
def test_align_wavefront_order_matches_plain_and_reference(case):
    """The DP kernel's own schedule, emulated in numpy (tests/dp_cases.py
    ``wavefront_scan``: anti-diagonal double steps, each cell reading only
    values made one or two steps before it as the kernel's registers and
    shuffles hold them, the kernel's staged codes and its ring of moves), bit
    for bit against the plain version, and against the JAX package's
    ``_align_scan`` on its DP cases."""
    arrs, band = scan_inputs(case)
    mv, last = wavefront_scan(*arrs, band=band, cpt=kernel_cells_per_thread(2 * band + 1))
    want_mv, want_last = align_scan_plain(*(torch.from_numpy(a) for a in arrs), band=band)
    np.testing.assert_array_equal(mv, want_mv.numpy())
    np.testing.assert_array_equal(last, want_last.numpy())
    if case in DP_CASES:
        ref_mv, ref_last = _align_scan(*(jnp.asarray(a) for a in arrs), band=band)
        np.testing.assert_array_equal(mv, np.asarray(ref_mv))
        np.testing.assert_array_equal(last, np.asarray(ref_last))


@pytest.mark.parametrize("case", sorted(DP_CASES))
def test_align_rows_matches_reference(case):
    rows, cons, cand, band = dp_case(case)
    ours = align_rows(rows, cons, cand, band, device="cpu")
    theirs = ref_align_rows(rows, cons, cand, band)
    assert len(ours) == len(theirs) == 5
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_batch_map_needs_a_card_unless_told_cpu(monkeypatch):
    rows, cons, cand, band = dp_case("bucket5")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        batch_map_reads(ReadMapper(cons), list(rows))


# ---------------------------------------------------------- batched mapper
def assert_same_segments(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert len(a) == len(b)
        for sa, sb in zip(a, b):
            assert (sa.read_start, sa.read_end) == (sb.read_start, sb.read_end)
            x, y = sa.aln, sb.aln
            assert (x.pos, x.rev, x.n_edits, x.read_len) == (y.pos, y.rev, y.n_edits, y.read_len)
            assert len(x.ops) == len(y.ops)
            for oa, ob in zip(x.ops, y.ops):
                assert oa[0] == ob[0] and int(oa[1]) == int(ob[1])
                np.testing.assert_array_equal(np.asarray(oa[2]), np.asarray(ob[2]))


def mapping_sets():
    rs, _ = encoded_case("illumina")
    ref, mixed = _mixed_read_set(seed=7, n=40)
    return {"illumina": (reference(), rs.reads), "mixed": (ref, mixed.reads)}


@pytest.mark.parametrize("name", ["illumina", "mixed"])
def test_batch_map_matches_reference(name):
    cons, reads = mapping_sets()[name]
    st_ours, st_theirs = {}, {}
    reset_trace_counts()
    ours = batch_map_reads(ReadMapper(cons), reads, min_batch=2, stats=st_ours, device="cpu")
    theirs = ref_batch_map(RefMapper(cons), reads, min_batch=2, stats=st_theirs)
    assert st_ours == st_theirs
    assert trace_counts().get("plain:align_scan", 0) > 0
    if name == "illumina":
        assert st_ours["n_batch_mapped"] > 0.5 * len(reads)
    assert_same_segments(ours, theirs)


# --------------------------------------------------------- batched encoder
def encode_both(ref, rs, opt_level=4, **kw):
    ours_enc = SageEncoder(ref, device="cpu", **kw)
    theirs_enc = RefEncoder(ref, **kw)
    ours = ours_enc.encode(pt_read_set(rs), opt_level=opt_level)
    theirs = theirs_enc.encode(rs, opt_level=opt_level)
    assert ours.diff(theirs) == []
    assert {k: ours_enc.stats[k] for k in INT_STATS} == {k: theirs_enc.stats[k] for k in INT_STATS}
    assert set(ours_enc.stats) == set(theirs_enc.stats)
    return ours_enc, theirs_enc, ours


@pytest.mark.parametrize("opt_level", [0, 1, 2, 3, 4])
def test_batched_encoder_matches_reference_all_opt_levels(opt_level):
    ref, rs = _mixed_read_set(seed=7)
    ours_enc, _, _ = encode_both(ref, rs, opt_level, token_target=4096, batch_min=2)
    assert ours_enc.stats["n_escaped"] > 0


@pytest.mark.parametrize("opt_level", [0, 4])
def test_batched_encoder_matches_reference_on_illumina(opt_level):
    rs, _ = encoded_case("illumina")
    reset_trace_counts()
    ours_enc, _, sf = encode_both(reference(), rs, opt_level, token_target=4096)
    counts = trace_counts()
    assert counts["plain:align_scan"] > 0 and counts["plain:sage_decode"] > 0
    assert ours_enc.stats["n_batch_mapped"] > 0.5 * len(rs.reads)
    seq = SageEncoder(reference(), token_target=4096, batched=False).encode(pt_read_set(rs), opt_level)
    assert sf.diff(seq) == []


def test_batched_encoder_variable_length_fallback():
    ref = make_reference(40_000, seed=5)
    rs = sample_read_set(ref, "ont", depth=1, max_reads=8, seed=6)
    ours_enc, _, _ = encode_both(ref, rs, token_target=8192)
    assert ours_enc.stats["n_fallback"] > 0


def test_batched_encoder_empty_read_set():
    ref = make_reference(4000, seed=1)
    rs = RefReadSet(reads=[], quals=[], kind="short", profile="x")
    _, _, sf = encode_both(ref, rs)
    assert sf.meta.n_blocks == 0 and sf.meta.n_reads == 0


def _corrupting(real):
    """``_segment_records`` that breaks the third read's records, as
    tests/test_encode_batch_parity.py::test_verify_demotes_corrupted_mapping
    does."""
    n = [0]

    def corrupt(read, segs, cons):
        recs = real(read, segs, cons)
        n[0] += 1
        if n[0] == 3 and recs and recs[0].length > 1:
            recs[0].mbb = [(m + 1) % 3 if k == "S" else m for m, k in zip(recs[0].mbb, recs[0].kinds)]
            if not recs[0].mp:
                recs[0].mp = [0]
                recs[0].mbb = [0]
                recs[0].kinds = ["S"]
        return recs

    return corrupt


def test_verify_demotes_corrupted_mapping_as_reference(monkeypatch):
    ref = make_reference(12_000, seed=3)
    rs = sample_read_set(ref, "illumina", depth=1, seed=4)
    monkeypatch.setattr(pt_enc_mod, "_segment_records", _corrupting(pt_enc_mod._segment_records))
    monkeypatch.setattr(ref_enc_mod, "_segment_records", _corrupting(ref_enc_mod._segment_records))
    ours_enc, theirs_enc, _ = encode_both(ref, rs, token_target=4096)
    assert ours_enc.stats["verify_rounds"] >= 2
    assert ours_enc.stats["n_escaped"] >= 1


def test_store_write_defaults_to_batched_and_matches_reference():
    ref = make_reference(12_000, seed=3)
    rs = sample_read_set(ref, "illumina", depth=2, seed=9)
    ours, theirs = SageStore(device="cpu"), RefStore()
    reset_trace_counts()
    sf_o = ours.write("d", pt_read_set(rs), ref, token_target=4096)
    sf_t = theirs.write("d", rs, ref, token_target=4096)
    assert sf_o.diff(sf_t) == []
    assert trace_counts().get("plain:align_scan", 0) > 0  # the batched path ran
    for k in INT_STATS:
        assert ours.last_write_stats[k] == theirs.last_write_stats[k], k
