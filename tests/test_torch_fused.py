"""The port's fused gather+decode+format path on the CPU (the plain version
of kernel B5), held bit for bit against the JAX package's fused decode —
its vmap path and its Pallas kernel in interpret mode — and against the
port's own two-step read. Mirrors tests/test_fused_decode.py."""

import numpy as np
import pytest
import torch

import repro.core.api as ref_api
import repro.kernels.sage_decode  # noqa: F401  (registers the fused Pallas path)
from repro.core import SageStore as RefStore
from repro.core.decode_jax import _FORMAT_FUSERS as REF_FUSERS
from repro.core.decode_jax import fused_decode_blocks_bucketed as ref_fused_bucketed
from repro.core.decode_jax import prepare_device_blocks as ref_prepare
from repro.core.layout import write_v2

import repro_torch.core.api as api
from repro_torch.convert import sage_file_from_reference
from repro_torch.core import SageStore
from repro_torch.core.api import FormatSpec, register_format
from repro_torch.core.decode_torch import (
    _FORMAT_FUSERS,
    decode_blocks_bucketed,
    fused_decode_blocks_bucketed,
    fused_format_supported,
    prepare_device_blocks,
    register_format_fuser,
    reset_trace_counts,
    trace_counts,
)
from repro_torch.kernels import ref
from repro_torch.kernels.sage_decode import sage_fused_decode

from torch_cases import assert_same, encoded_case

GROUP = 4
FMTS = ("2bit", "kmer", "onehot")
SPAN = (3, 8)  # straddles a group edge; bucket 8 with 3 invalid lanes
IDS = np.array([9, 2, 2, 17, 0, 5])  # permuted and repeated; bucket 8


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """The same dataset as an eager SageFile and a codec v2 container."""
    _, sf = encoded_case("illumina")
    path = tmp_path_factory.mktemp("fused") / "ds.sage2"
    write_v2(sf, path)
    return sf, str(path)


def port_store(src, **kw):
    store = SageStore(device="cpu", group_blocks=GROUP, **kw)
    store.register("ds", src if isinstance(src, str) else sage_file_from_reference(src))
    return store


def ref_store(src):
    store = RefStore(group_blocks=GROUP)
    store.register("ds", src)
    return store


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("source", ["eager", "v2"])
def test_fused_read_matches_reference_and_two_step(sources, source, fmt):
    sf, path = sources
    src = sf if source == "eager" else path
    got = port_store(src).session(fused=True).read("ds", SPAN, fmt, kmer_k=4)
    assert_same(got, ref_store(src).session(fused=True).read("ds", SPAN, fmt, kmer_k=4))
    assert_same(got, port_store(src).session().read("ds", SPAN, fmt, kmer_k=4))


@pytest.mark.parametrize("fmt", FMTS)
def test_fused_bucketed_matches_reference_pallas_kernel(sources, fmt):
    """The port's fused_decode_blocks_bucketed against the JAX package's
    fused Pallas kernel (interpret mode) and its vmap path, on permuted,
    repeated ids padded with invalid lanes."""
    sf, _ = sources
    db = prepare_device_blocks(sage_file_from_reference(sf)).to("cpu")
    got = fused_decode_blocks_bucketed(db, IDS, fmt_name=fmt, kmer_k=4)
    rdb = ref_prepare(sf)
    for path_key in (None, ("pallas", (("interpret", True),))):
        want = ref_fused_bucketed(rdb, IDS, fmt_name=fmt, kmer_k=4, path_key=path_key)
        assert_same(got, want)


@pytest.mark.parametrize("fmt", FMTS)
def test_fused_plain_equals_two_step_on_invalid_lanes(sources, fmt):
    """B5's plain version equals B2's followed by B3/B4 on a padded bucket;
    invalid lanes decode to PAD, zero counts and pad k-mer ids whatever
    block occupies them."""
    sf, _ = sources
    db = prepare_device_blocks(sage_file_from_reference(sf)).to("cpu")
    ids = np.array([4, 11, 4, 0, 4, 4, 4, 4])
    valid = np.array([1, 1, 1, 1, 0, 0, 0, 0], np.int32)
    got = ref.sage_fused_ref(db, ids, valid, fmt, kmer_k=5)
    two = decode_blocks_bucketed(db, ids[:4])
    for k, v in two.items():
        assert torch.equal(got[k][:4], v), k
    dead = slice(4, None)
    assert (got["tokens"][dead] == 4).all() and not got["n_tokens"][dead].any()
    assert not got["n_reads"][dead].any() and (got["read_pos"][dead] == -1).all()
    if fmt == "kmer":
        assert torch.equal(got["kmer"], ref.kmer_pack_ref(got["tokens"], 5, got["n_tokens"]))
        assert (got["kmer"][dead] == api.kmer_special_ids(5)["pad"]).all()
        assert got["kmer"].shape[1] == db.caps.tokens // 5 and db.caps.tokens % 5
    elif fmt == "onehot":
        assert torch.equal(got["onehot"], ref.one_hot_ref(got["tokens"]))
        assert not got["onehot"][dead].any()


def test_one_plain_fused_call_per_read(sources):
    _, path = sources
    sess = port_store(path, max_prepared=8).session(fused=True)
    sess.read("ds", (0, 3 * GROUP))  # warm the groups: unpacks happen here
    for fmt in FMTS:
        reset_trace_counts()
        sess.read("ds", (1, 2 * GROUP + 1), fmt, kmer_k=4)
        assert trace_counts() == {"plain:sage_fused": 1}, fmt


def test_fused_requires_k_error_matches_two_step(sources):
    sf, _ = sources
    with pytest.raises(ValueError, match="requires kmer_k"):
        port_store(sf).session(fused=True).read("ds", (0, 2), fmt="kmer")
    with pytest.raises(ValueError, match="requires kmer_k"):
        port_store(sf).session().read("ds", (0, 2), fmt="kmer")
    with pytest.raises(ValueError, match="requires kmer_k"):
        ref_store(sf).session(fused=True).read("ds", (0, 2), fmt="kmer")


def test_unregistered_format_falls_back_to_two_step(sources):
    """A custom format without a fuser takes the two-step path on a fused
    session; one with a fuser runs it on B5's 2bit output. Both match a
    plain session and the JAX package."""
    sf, _ = sources

    def apply_rc(tokens, *, kmer_k=None, n_tokens=None, **_kw):
        return tokens.flip(-1) if isinstance(tokens, torch.Tensor) else tokens[..., ::-1]

    register_format(FormatSpec("revtok", "revtok", apply_rc, doc="test-only"))
    ref_api.register_format(ref_api.FormatSpec("revtok", "revtok", apply_rc, doc="test-only"))
    try:
        assert not fused_format_supported("revtok")
        plain = port_store(sf).session().read("ds", (0, 2), fmt="revtok")
        reset_trace_counts()
        fused = port_store(sf).session(fused=True).read("ds", (0, 2), fmt="revtok")
        assert "plain:sage_fused" not in trace_counts()
        assert_same(plain, fused)
        assert_same(fused, ref_store(sf).session(fused=True).read("ds", (0, 2), fmt="revtok"))
        register_format_fuser("revtok", "revtok", lambda dec, kmer_k: dec["tokens"].flip(-1))
        reset_trace_counts()
        fused = port_store(sf).session(fused=True).read("ds", (0, 2), fmt="revtok")
        assert trace_counts() == {"plain:sage_fused": 1}
        assert_same(plain, fused)
    finally:
        for reg in (api._FORMATS, ref_api._FORMATS, _FORMAT_FUSERS, REF_FUSERS):
            reg.pop("revtok", None)


def test_builtin_fusers_state_the_epilogues(sources):
    """Each built-in format has a fuser, and the fuser applied to the
    two-step decode gives what B5's epilogue writes."""
    sf, _ = sources
    db = prepare_device_blocks(sage_file_from_reference(sf)).to("cpu")
    two = decode_blocks_bucketed(db, IDS)
    for fmt in FMTS:
        assert fused_format_supported(fmt)
        out_key, fn = _FORMAT_FUSERS[fmt]
        fused = fused_decode_blocks_bucketed(db, IDS, fmt_name=fmt, kmer_k=4)
        want = two["tokens"] if fn is None else fn(two, 4)
        assert torch.equal(fused[out_key], want), fmt


def test_fused_zero_blocks_and_argument_checks(sources):
    sf, _ = sources
    db = prepare_device_blocks(sage_file_from_reference(sf)).to("cpu")
    rdb = ref_prepare(sf)
    for fmt in FMTS:
        assert_same(fused_decode_blocks_bucketed(db, [], fmt_name=fmt, kmer_k=4),
                    ref_fused_bucketed(rdb, [], fmt_name=fmt, kmer_k=4))
    with pytest.raises(KeyError, match="no registered fuser"):
        fused_decode_blocks_bucketed(db, [0], fmt_name="nope")
    kw = dict(caps=db.caps, classes=db.classes, fixed_len=db.fixed_len)
    with pytest.raises(IndexError, match="ids must lie in"):
        sage_fused_decode(db.arrays, [0, db.n_blocks], [1, 1], fmt="2bit", **kw)
    with pytest.raises(IndexError, match="ids must lie in"):
        sage_fused_decode(db.arrays, [-1], [1], fmt="2bit", **kw)
    with pytest.raises(ValueError, match="kmer_k"):
        sage_fused_decode(db.arrays, [0], [1], fmt="kmer", **kw)
    with pytest.raises(ValueError, match="fmt must be one of"):
        sage_fused_decode(db.arrays, [0], [1], fmt="revtok", **kw)
    with pytest.raises(ValueError, match="0/1"):
        sage_fused_decode(db.arrays, [0], [2], fmt="2bit", **kw)
