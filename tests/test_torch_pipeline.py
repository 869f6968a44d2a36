"""The port's SageTokenPipeline on the CPU: the same (tokens, labels)
batches and restored cursors as the JAX package's pipeline, one host
transfer per batch, worker teardown and cursor restore across fetch and
epoch boundaries. Mirrors tests/test_substrate.py and
tests/test_pipeline_stream.py."""

import functools

import numpy as np
import pytest
import torch

from repro.core import SageStore as RefStore
from repro.data.pipeline import SageTokenPipeline as RefPipeline

from repro_torch.convert import sage_file_from_reference
from repro_torch.core import SageEncoder, SageStore
from repro_torch.core.api import kmer_special_ids, pick_k
from repro_torch.data import SageTokenPipeline
from repro_torch.genomics.synth import make_reference, sample_read_set

from torch_cases import encoded_case

VOCAB = 256  # k = 3


@pytest.fixture(scope="module")
def sagefiles():
    """(JAX package SageFile, the port's SageFile) of one read set."""
    _, sf = encoded_case("illumina")
    return sf, sage_file_from_reference(sf)


def pipe(sagefiles, **kw):
    kw.setdefault("vocab_size", VOCAB)
    kw.setdefault("batch", 2)
    kw.setdefault("seq_len", 16)
    return SageTokenPipeline(sagefiles[1], store=SageStore(device="cpu"), **kw)


@functools.lru_cache(maxsize=None)
def _flat_stream(k: int) -> np.ndarray:
    """Ground-truth flat k-mer stream of one epoch (blocks in order, PAD
    groups dropped), from the JAX package's store."""
    _, sf = encoded_case("illumina")
    store = RefStore()
    store.register("d", sf)
    out = store.session().read("d", fmt="kmer", kmer_k=k)
    km, nt = np.asarray(out["kmer"]), np.asarray(out["n_tokens"])
    return np.concatenate([km[b, : nt[b] // k] for b in range(km.shape[0])])


def expected(consumed: int, need: int, k: int = pick_k(VOCAB)) -> np.ndarray:
    flat = _flat_stream(k)
    reps = (consumed + need) // flat.size + 2
    return np.tile(flat, reps)[consumed : consumed + need]


def assert_batch(got, consumed, batch=2, seq_len=16):
    want = expected(consumed, batch * (seq_len + 1)).reshape(batch, seq_len + 1)
    np.testing.assert_array_equal(got["tokens"], want[:, :-1])
    np.testing.assert_array_equal(got["labels"], want[:, 1:])


# ------------------------------------------------------- parity with repro
@pytest.mark.parametrize("stream_mode", ["dispatch", "pipelined"])
def test_batches_and_restore_match_reference_pipeline(sagefiles, stream_mode):
    kw = dict(vocab_size=259, batch=2, seq_len=700, blocks_per_fetch=3, stream_mode=stream_mode)
    ours = pipe(sagefiles, **kw)
    theirs = RefPipeline(sagefiles[0], **kw)
    a, b = ours.batches(), theirs.batches()
    for i in range(6):
        x, y = next(a), next(b)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(x[key], y[key])
        if i == 2:
            assert ours.state() == theirs.state()
            state = ours.state()
    assert ours.state() == theirs.state()
    assert ours.transfer_stats["host_transfers"] == 6
    restored, ref_restored = pipe(sagefiles, **kw), RefPipeline(sagefiles[0], **kw)
    restored.restore(state)
    ref_restored.restore(state)
    assert restored.cursor.to_json() == ref_restored.cursor.to_json()
    assert restored._skip == ref_restored._skip
    c, d = restored.batches(), ref_restored.batches()
    for _ in range(3):
        np.testing.assert_array_equal(next(c)["tokens"], next(d)["tokens"])
    for p in (ours, theirs, restored, ref_restored):
        p.close()


def test_pipeline_deterministic_and_resumable(sagefiles):
    p1 = pipe(sagefiles, seq_len=64)
    it = p1.batches()
    first = [next(it) for _ in range(4)]
    state = p1.state()
    fifth = next(it)
    p2 = pipe(sagefiles, seq_len=64)
    p2.restore(state)
    np.testing.assert_array_equal(fifth["tokens"], next(p2.batches())["tokens"])
    sp = kmer_special_ids(pick_k(VOCAB))
    for i, b in enumerate(first):
        assert b["tokens"].max() < VOCAB and (b["tokens"] != sp["pad"]).all()
        assert_batch(b, i * 2 * 65, seq_len=64)


# ------------------------------------------------------------ restore paths
def test_pipeline_restore_at_exact_block_boundary(sagefiles):
    p = pipe(sagefiles)
    boundary = int(p._kpb[:3].sum())  # consumed count ending exactly at block 3
    p.restore({"cursor": {"epoch": 0, "block": 0, "consumed": boundary}})
    assert p.cursor.block == 3 and p._skip == 0  # boundary maps to next block, no skip
    assert_batch(next(p.batches()), boundary)


def test_pipeline_restore_after_full_epoch(sagefiles):
    p = pipe(sagefiles)
    total = int(p._kpb.sum())
    consumed = 2 * total + int(p._kpb[0] // 2)  # two full epochs + mid-block
    p.restore({"cursor": {"epoch": 0, "block": 0, "consumed": consumed}})
    assert p.cursor.epoch == 2
    assert_batch(next(p.batches()), consumed)


def test_restore_mid_block_with_single_block_fetches(sagefiles):
    p = pipe(sagefiles, blocks_per_fetch=1)
    total = int(p._kpb.sum())
    consumed = total + int(p._kpb[:2].sum()) + max(1, int(p._kpb[2]) // 2)
    p.restore({"cursor": {"epoch": 0, "block": 0, "consumed": consumed}})
    assert p.cursor.epoch == 1
    assert_batch(next(p.batches()), consumed)


def test_pipeline_blocks_per_fetch_exceeding_n_blocks(sagefiles):
    nb = sagefiles[1].meta.n_blocks
    big = pipe(sagefiles, blocks_per_fetch=nb + 3)
    small = pipe(sagefiles, blocks_per_fetch=2)
    bit, sit = big.batches(), small.batches()
    for _ in range(3):
        np.testing.assert_array_equal(next(bit)["tokens"], next(sit)["tokens"])
    # restore still replays the exact stream when one fetch spans >1 epoch
    state = big.state()
    nxt = next(bit)
    big2 = pipe(sagefiles, blocks_per_fetch=nb + 3)
    big2.restore(state)
    np.testing.assert_array_equal(next(big2.batches())["tokens"], nxt["tokens"])


def test_skip_spanning_multiple_fetches_drains_correctly(sagefiles):
    """A skip larger than several fetch groups drains across fetches, then
    yields the exact stream suffix."""
    p = pipe(sagefiles, blocks_per_fetch=1)
    skip = int(p._kpb[:5].sum()) + 3  # spans >5 single-block fetches
    p._skip = skip
    assert_batch(next(p.batches()), skip)
    assert p._skip == 0


# --------------------------------------------------- transfers and devices
def test_one_host_transfer_per_batch_not_per_fetch(sagefiles):
    # one batch needs more k-mers than any single block holds -> several
    # fetches per batch, none of which may copy to the host
    kpb_max = int(pipe(sagefiles)._kpb.max())
    p = pipe(sagefiles, seq_len=kpb_max + 100, blocks_per_fetch=1)
    it = p.batches()
    for _ in range(3):
        next(it)
    assert p.transfer_stats["host_transfers"] == 3
    assert p.transfer_stats["fetches"] > p.transfer_stats["host_transfers"]


def test_fetch_tokens_stays_on_device(sagefiles):
    p = pipe(sagefiles)
    chunk = p._fetch_tokens()
    assert isinstance(chunk, torch.Tensor) and chunk.device == p.store.device
    n = int(p._kpb[: p.blocks_per_fetch].sum())
    np.testing.assert_array_equal(chunk.numpy(), expected(0, n))
    assert (chunk != p.sp["pad"]).all()
    p.close()


# ------------------------------------------------------------ worker leak
def test_abandoned_prefetched_iterator_terminates_worker(sagefiles):
    p = pipe(sagefiles, prefetch=1)
    it = p.prefetched()
    next(it)  # worker running; queue (maxsize=1) fills behind the consumer
    t = p._prefetch_thread
    assert t is not None and t.is_alive()
    it.close()  # abandon: generator finally -> stop.set()
    t.join(timeout=5.0)
    assert not t.is_alive(), "prefetch worker leaked after iterator abandon"
    p.close()


def test_prefetched_matches_sync(sagefiles):
    p1, p2 = pipe(sagefiles, seq_len=32), pipe(sagefiles, seq_len=32)
    sync = [next(p1.batches()) for _ in range(3)]
    pre = p2.prefetched()
    try:
        got = [next(pre) for _ in range(3)]
    finally:
        pre.close()
    for a, b in zip(sync, got):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    p1.close()
    p2.close()


def test_pipeline_refuses_to_clobber_shared_store_dataset(sagefiles):
    store = SageStore(device="cpu")
    store.register("train", sagefiles[1])
    other_ref = make_reference(10_000, seed=9)
    other = SageEncoder(other_ref, token_target=2048, device="cpu").encode(
        sample_read_set(other_ref, "illumina", depth=1, seed=10)
    )
    with pytest.raises(ValueError, match="already registered"):
        SageTokenPipeline(other, vocab_size=VOCAB, batch=2, seq_len=16, store=store)
    # same SageFile or a unique name are both fine
    SageTokenPipeline(sagefiles[1], vocab_size=VOCAB, batch=2, seq_len=16, store=store)
    SageTokenPipeline(other, vocab_size=VOCAB, batch=2, seq_len=16, store=store, name="other")
    assert set(store.names()) == {"train", "other"}
