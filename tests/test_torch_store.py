"""The port's slice end to end on the CPU: SageStore over containers written
by the JAX package, SAGe_Read in every format and SAGe_ISP in every ported
stream mode, held bit for bit against the JAX package's store."""

import shutil

import numpy as np
import pytest
import torch

from repro.core import SageStore as RefStore
from repro.core.layout import write_v2
from repro.testing.faults import corrupt_extent

from repro_torch.convert import sage_file_from_reference
from repro_torch.core import SageStore
from repro_torch.core.decode_torch import reset_trace_counts, trace_counts
from repro_torch.core.errors import IntegrityError
from repro_torch.data import SageTokenPipeline
from repro_torch.distributed import BlockMesh

from torch_cases import assert_same, encoded_case, reference

GROUP = 4
FMTS = [("2bit", None), ("kmer", 4), ("onehot", None)]
RANGES = [(2, 11), [5, 1, 13, 2], (0, 3)]  # cross group edges; buckets 16 and 4


@pytest.fixture(scope="module")
def codec_path(tmp_path_factory):
    _, sf = encoded_case("illumina")
    path = tmp_path_factory.mktemp("store") / "ds.sage2"
    write_v2(sf, path)
    assert sf.meta.n_blocks > 4 * GROUP
    return str(path)


def stores(path, **kw):
    ours = SageStore(device="cpu", group_blocks=GROUP, **kw)
    theirs = RefStore(group_blocks=GROUP, **kw)
    ours.register("ds", path)
    theirs.register("ds", path)
    return ours, theirs


@pytest.mark.parametrize("fmt,k", FMTS, ids=[f for f, _ in FMTS])
def test_session_read_matches_reference(codec_path, fmt, k):
    ours, theirs = stores(codec_path, max_prepared=8)
    so, st = ours.session(), theirs.session()
    for rng in RANGES:
        assert_same(so.read("ds", rng, fmt, kmer_k=k), st.read("ds", rng, fmt, kmer_k=k))


def test_eager_sources_match_reference(codec_path, tmp_path):
    _, sf = encoded_case("illumina")
    v1 = tmp_path / "ds.npz"
    sf.save(v1)
    ours = SageStore(device="cpu")
    theirs = RefStore()
    ours.register("mem", sage_file_from_reference(sf))
    theirs.register("mem", sf)
    ours.register("v1", str(v1))
    theirs.register("v1", str(v1))
    for name in ("mem", "v1"):
        for fmt, k in FMTS:
            for rng in RANGES[1:]:
                assert_same(ours.session().read(name, rng, fmt, kmer_k=k),
                            theirs.session().read(name, rng, fmt, kmer_k=k))


@pytest.mark.parametrize("mode", ["sync", "prefetch", "dispatch"])
def test_read_stream_matches_reference(codec_path, mode):
    ours, theirs = stores(codec_path)
    kw = dict(fmt="kmer", kmer_k=4, blocks_per_fetch=3, mode=mode, start_block=2)
    got = list(ours.session().read_stream("ds", **kw))
    want = list(theirs.session().read_stream("ds", **kw))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        assert (a.epoch, a.next_block, a.next_epoch) == (b.epoch, b.next_block, b.next_epoch)
        np.testing.assert_array_equal(a.block_ids, b.block_ids)
        assert_same(a.data, b.data)
    wrap = dict(kw, wrap=True, max_fetches=9)
    got = ours.session().read_stream("ds", lambda b: (b.epoch, b.block_ids.tolist()), **wrap)
    want = theirs.session().read_stream("ds", lambda b: (b.epoch, b.block_ids.tolist()), **wrap)
    assert got == want


def test_io_stats_and_residency_match_reference(codec_path):
    ours, theirs = stores(codec_path, max_prepared=3)
    for rng in [(0, 3), (2, 11), (3, 4), [19, 0]]:
        ours.session().read("ds", rng)
        theirs.session().read("ds", rng)
    a, b = ours.io_stats, theirs.io_stats
    for key in ("extent_reads", "extent_bytes_read", "consensus_bytes_read", "blocks_fetched",
                "blocks_verified", "extent_bytes_stored", "extent_bytes_decoded", "group_uploads",
                "cache_bytes", "cache_hits", "cache_misses"):
        assert a[key] == b[key], key
    assert a["extent_bytes_read"] > 0
    assert ours.cache_stats() == theirs.cache_stats()
    assert ours.prepared_keys == theirs.prepared_keys
    assert ours.resident_fraction("ds", [0, 1, 8]) == theirs.resident_fraction("ds", [0, 1, 8])
    wa, sa = ours.consensus_windows("ds", [3, 9])
    wb, sb = theirs.consensus_windows("ds", [3, 9])
    np.testing.assert_array_equal(wa, wb)
    np.testing.assert_array_equal(sa, sb)


def test_residency_controls_match_reference(codec_path):
    ours, theirs = stores(codec_path, max_prepared=8)
    for s in (ours, theirs):
        s.session().read("ds", (0, 9))
    assert ours.block_nbytes("ds") == theirs.block_nbytes("ds")
    assert ours.prefetch_group_host("ds", 4) == theirs.prefetch_group_host("ds", 4) is True
    assert ours.release_group("ds", 0) == theirs.release_group("ds", 0) is True
    assert ours.prepared_keys == theirs.prepared_keys
    for s in (ours, theirs):
        s.reset_cache_stats()
        s.evict("ds")
    assert ours.prepared_keys == theirs.prepared_keys == ()
    assert ours.prepared_names == theirs.prepared_names
    assert ours.cache_stats() == theirs.cache_stats()
    assert ours.io_stats["extent_reads"] == theirs.io_stats["extent_reads"]


def test_corrupt_extent_quarantines_group(codec_path, tmp_path):
    path = tmp_path / "bad.sage2"
    shutil.copy(codec_path, path)
    corrupt_extent(str(path), 1 * GROUP + 1, byte=5)
    ours = SageStore(device="cpu", group_blocks=GROUP)
    ours.register("ds", str(path))
    sess = ours.session()
    sess.read("ds", (0, GROUP))  # a healthy group reads
    with pytest.raises(IntegrityError, match="checksum"):
        sess.read("ds", (GROUP, 2 * GROUP))
    assert ours.health("ds") == {"ok": False, "quarantined_groups": (1,)}
    with pytest.raises(IntegrityError, match="quarantined"):
        sess.read("ds", (GROUP + 2, GROUP + 3))
    assert ours.io_stats["checksum_failures"] == 1
    sess.read("ds", (2 * GROUP, 3 * GROUP))  # other groups keep serving


def test_read_path_runs_each_plain_kernel_once_per_read(codec_path):
    ours, _ = stores(codec_path)
    sess = ours.session()
    sess.read("ds", (0, 2))  # warm group 0
    reset_trace_counts()
    sess.read("ds", (0, 3), "kmer", kmer_k=4)
    sess.read("ds", (1, 4), "onehot")
    assert trace_counts() == {"plain:sage_decode": 2, "plain:kmer_pack": 1, "plain:one_hot": 1}
    sess.read("ds", (GROUP, GROUP + 1))  # a cold group unpacks once
    assert trace_counts()["plain:sage_unpack"] == 1


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        SageStore()
    with pytest.raises(RuntimeError, match="cuda"):
        SageStore(device="cuda:0")


def test_unported_options_raise_with_roadmap_item(codec_path):
    """Slice 7's block-sharded residency is ported: a store builds on a
    BlockMesh, ``shards=2`` raises as ``repro``'s does with one visible
    device, a session on another mesh than the store's raises ``repro``'s
    mismatch error, and mesh/shards on a pipeline over a shared store raise
    ``repro``'s "pass mesh/shards on the shared store" error."""
    ours, theirs = stores(codec_path)
    cpu = torch.device("cpu")
    sharded = SageStore(device="cpu", group_blocks=GROUP, mesh=BlockMesh([cpu] * 2))
    sharded.register("ds", codec_path)
    assert sharded.mesh.shards == 2 and sharded.session().mesh == sharded.mesh
    with pytest.raises(ValueError, match="visible cpu device"):
        SageStore(device="cpu", shards=2)
    with pytest.raises(ValueError, match="residency mesh"):
        sharded.session(mesh=BlockMesh([cpu] * 4))
    with pytest.raises(ValueError, match="pass mesh/shards on the shared SageStore"):
        SageTokenPipeline("ds", vocab_size=259, batch=1, seq_len=8, store=ours, mesh=BlockMesh([cpu] * 2))
    # slice 3 (batched SAGe_Write) is ported: the CPU store writes repro's SageFile
    rs, _ = encoded_case("illumina")
    cons = reference()
    sf = ours.write("x", rs, cons, token_target=4096, batched=True)
    assert sf.diff(theirs.write("x", rs, cons, token_target=4096, batched=True)) == []
    assert ours.last_write_stats["n_batch_mapped"] > 0
    # slice 4 (scrub, faults, repair) is ported: a full-sweep repair of a
    # clean container returns repro's summary
    assert ours.repair("ds") == theirs.repair("ds")
    assert ours.repair("ds")["damaged_blocks"] == []
