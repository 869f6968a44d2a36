"""The port's CUDA kernels against their plain torch versions, on the card
(and the fused kernel B5 also against B2 followed by B3 / B4).

Every test carries the ``cuda`` marker and takes the ``cuda`` fixture, which
skips when ``torch.cuda.is_available()`` is false (decided when the test
runs, never at import). The module imports only the port, so it also runs
where JAX is not installed; on a machine with an NVIDIA GPU:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py

The kernels are built from src/repro_torch/kernels/csrc at first use."""

import functools

import numpy as np
import pytest
import torch

from repro_torch.core import decode_torch as DT
from repro_torch.core.blocks import pad_block_ids
from repro_torch.core.encoder import SageEncoder
from repro_torch.core.format import STREAMS
from repro_torch.core.layout import SageContainerV2, write_v2
from repro_torch.genomics.synth import make_reference, sample_read_set
from repro_torch.kernels import ops, ref

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


@pytest.mark.parametrize("k", range(1, 9))
def test_kmer_kernel_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    toks = torch.as_tensor(rng.integers(0, 5, (5, 1001)).astype(np.int8), device=cuda)
    ntok = torch.as_tensor([1001, 900, 3, 0, 64], dtype=torch.int32, device=cuda)
    for nt in (None, ntok):
        assert torch.equal(ops.kmer_tokens(toks, k, nt), ref.kmer_pack_ref(toks, k, nt))
    assert ops.kmer_tokens(toks[:0], k, ntok[:0]).shape == (0, 1001 // k)


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


FUSED_CASES = [("2bit", None), ("kmer", 3), ("kmer", 4), ("kmer", 5), ("onehot", None)]


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
