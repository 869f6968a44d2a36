"""Block-sharded SAGe residency and decode in the port, on the CPU, held
against the JAX package's single-device reads in this process.

The port's BlockMesh takes a list of devices, repeats included: here
``BlockMesh([cpu] * N)`` for N in {1, 2, 4} stands where ``repro``'s tests
force N host devices. The contracts are ``repro``'s
(``tests/test_sharded_decode.py``): sharded reads are bit-identical to the
single-device reads in every format, on the two-step and the ``fused=True``
path (a mesh session takes the two-step path), over an in-memory source
(whole-file residency) and a codec v2 container (block-group residency,
groups padded to the shard count and unpacked shard by shard); pad lanes
change nothing (the mask contract); the k-mer token stream is the same for
every shard count. Integer paths: bit for bit, no tolerance."""

import numpy as np
import pytest
import torch

from repro.core import SageStore as RefStore
from repro.core.decode_jax import pad_block_ids as ref_pad_block_ids
from repro.core.encoder import SageEncoder
from repro.core.layout import write_v2
from repro.data.pipeline import SageTokenPipeline as RefPipeline
from repro.genomics import filter_jax as FJ
from repro.genomics.synth import make_reference, sample_read_set

from repro_torch.convert import sage_file_from_reference
from repro_torch.core import SageStore
from repro_torch.core.blocks import pad_block_ids
from repro_torch.core.decode_torch import (
    decode_blocks_bucketed,
    decode_blocks_sharded,
    prepare_device_blocks,
    reset_trace_counts,
    trace_counts,
)
from repro_torch.data import SageTokenPipeline
from repro_torch.distributed import BlockMesh, block_shard_count, block_sharding, make_block_mesh
from repro_torch.genomics import filter_torch as FT

from torch_cases import assert_same

CPU = torch.device("cpu")
SHARDS = (1, 2, 4)
GROUP = 3  # v2 block groups of 3 rows: 2 and 4 shards pad them to 4
FMTS = ("2bit", "kmer", "onehot")
IDS = [6, 0, 3, 11, 12]  # a fancy read across groups and shards


@pytest.fixture(scope="module")
def sharded_case(tmp_path_factory):
    """(JAX SageFile, port SageFile, v2 container path, JAX store): seed
    41's read set carries in-read N dropouts (the k-mer stream's
    N-block-vs-PAD case across shard counts)."""
    ref = make_reference(30_000, seed=41)
    rs = sample_read_set(ref, "illumina", depth=3, seed=42)
    sf = SageEncoder(ref, token_target=3072, batched=False).encode(rs)
    assert sf.meta.n_blocks >= 9
    path = tmp_path_factory.mktemp("sharded") / "ds.sage2"
    write_v2(sf, path)
    theirs = RefStore(max_prepared=2)
    theirs.register("ds", sf)
    return sf, sage_file_from_reference(sf), str(path), theirs


def port_store(case, shards, source, **kw):
    _sf, psf, path, _t = case
    st = SageStore(device="cpu", mesh=BlockMesh([CPU] * shards), group_blocks=GROUP, **kw)
    st.register("ds", psf if source == "memory" else path)
    return st


_REF_READS: dict = {}


def ref_read(case, fmt, ids=None):
    key = (fmt, None if ids is None else tuple(ids))
    if key not in _REF_READS:
        out = case[3].session().read("ds", ids, fmt, kmer_k=4)
        _REF_READS[key] = {k: v for k, v in out.items() if k != "block_ids"}
    return _REF_READS[key]


# ------------------------------------------------------------- bucket math
def test_pad_block_ids_matches_reference():
    """``pad_block_ids(ids, shards)`` pads to bucket(ceil(n / shards)) x
    shards with repro's ids and mask, over a sweep of sizes and counts."""
    for n in range(1, 21):
        ids = np.arange(100, 100 + n)[::-1]
        for shards in range(1, 6):
            got, want = pad_block_ids(ids, shards), ref_pad_block_ids(ids, shards)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="shards"):
        pad_block_ids(np.arange(3), shards=0)


def test_make_block_mesh_rejects_oversubscription():
    """More shards than visible devices raise ValueError (on a machine with
    no card, any CUDA mesh); the CPU counts as one device; a mesh that
    repeats a device is built from a list."""
    n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="visible cuda device"):
        make_block_mesh(n_cuda + 1)
    if n_cuda == 0:
        with pytest.raises(ValueError, match="0 visible cuda"):
            make_block_mesh(2)
    with pytest.raises(ValueError, match="visible cpu device"):
        make_block_mesh(2, device_type="cpu")
    mesh = make_block_mesh(1, device_type="cpu")
    assert block_shard_count(mesh) == 1 and mesh.axis == "blocks"
    assert block_shard_count(None) == 1
    assert BlockMesh([CPU] * 4).shards == 4 and BlockMesh(["cpu"] * 2) == BlockMesh([CPU] * 2)
    assert block_sharding(BlockMesh([CPU] * 4), 9) == (range(0, 3), range(3, 6), range(6, 9), range(9, 12))


def test_session_mesh_must_match_store_residency(sharded_case):
    """A session mesh other than the store's is rejected (repro's error);
    the store's own mesh and shards=1 are taken; mesh= and shards= together
    raise; decode_blocks_bucketed takes only a BlockMesh."""
    st = port_store(sharded_case, 4, "memory")
    with pytest.raises(ValueError, match="residency mesh"):
        st.session(mesh=BlockMesh([CPU] * 2))
    assert st.session(shards=1).mesh is None
    assert st.session(mesh=BlockMesh([CPU] * 4)).mesh == st.mesh
    with pytest.raises(ValueError, match="not both"):
        st.session(mesh=st.mesh, shards=4)
    with pytest.raises(TypeError, match="BlockMesh"):
        decode_blocks_bucketed(st.prepared("ds"), np.arange(2), mesh=object())


# ------------------------------------------------- residency + bit-identity
@pytest.mark.parametrize("shards", (2, 4))
@pytest.mark.parametrize("source", ("memory", "v2"))
def test_residency_is_block_sharded(sharded_case, shards, source):
    """Each shard's rows sit in its list entry, a run of equal length; a v2
    group's stride pads to a multiple of the shard count; the shards'
    concatenation is the one-device residency (the host layout, or the
    group's rows) with zero rows past the real blocks."""
    st = port_store(sharded_case, shards, source)
    if source == "memory":
        db = st.prepared("ds")
        host = {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v)
                for k, v in prepare_device_blocks(sharded_case[1]).arrays.items()}
    else:
        db, _ = st.prepared_for("ds", [4])  # group 1: blocks 3..5
        one, _ = port_store(sharded_case, 1, source).prepared_for("ds", [4])
        host = {k: torch.cat(v) for k, v in one.arrays.items()}
    n_real = host["dir"].shape[0]
    assert db.mesh == st.mesh
    for k, parts in db.arrays.items():
        assert len(parts) == shards, k
        lens = {p.shape[0] for p in parts}
        assert len(lens) == 1, (k, lens)
        stride = shards * lens.pop()
        assert stride - n_real < shards, (k, stride, n_real)
        whole = torch.cat(parts)
        assert torch.equal(whole[:n_real], host[k]), k
        assert not whole[n_real:].any(), k


@pytest.mark.parametrize("fused", (False, True), ids=("two_step", "fused"))
@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("source", ("memory", "v2"))
@pytest.mark.parametrize("fmt", FMTS)
def test_sharded_read_bit_identical(sharded_case, fmt, source, shards, fused):
    """A whole-dataset read and a fancy-id read across groups and shards
    equal repro's single-device reads bit for bit."""
    sess = port_store(sharded_case, shards, source).session(fused=fused)
    assert sess.mesh.shards == shards
    out = sess.read("ds", None, fmt, kmer_k=4)
    assert_same({k: v for k, v in out.items() if k != "block_ids"}, ref_read(sharded_case, fmt))
    part = sess.read("ds", IDS, fmt, kmer_k=4)
    assert_same({k: v for k, v in part.items() if k != "block_ids"}, ref_read(sharded_case, fmt, IDS))


@pytest.mark.parametrize("shards", (2, 4))
def test_sharded_kernels_run_once_a_shard(sharded_case, shards):
    """Each lane shard decodes and formats on its own (one block-decode and
    one format call a shard, here their plain versions on CPU tensors), a
    codec group unpacks shard by shard, and a fused mesh session takes the
    two-step path."""
    st = port_store(sharded_case, shards, "v2")
    reset_trace_counts()
    st.session().read("ds", (0, 3 * GROUP), "kmer", kmer_k=4)
    c = trace_counts()
    assert c.get("plain:sage_unpack") == 3 * shards and c.get("plain:sage_decode") == shards, c
    assert c.get("plain:kmer_pack") == shards, c
    reset_trace_counts()
    st.session(fused=True).read("ds", (0, 3 * GROUP), "onehot")
    c = trace_counts()
    assert c == {"plain:sage_decode": shards, "plain:one_hot": shards}, c


def test_sharded_mask_contract_pad_occupant_invariance(sharded_case):
    """Invalid lanes decode to the same PAD outputs whatever block sits in
    them, on each lane shard (each with its own mask tail)."""
    st = port_store(sharded_case, 2, "memory")
    db = st.prepared("ds")
    ids_a = np.asarray([2, 4, 1, 0, 5, 3], dtype=np.int64)
    ids_b = np.asarray([2, 4, 1, 7, 8, 6], dtype=np.int64)
    valid = np.asarray([1, 1, 1, 0, 0, 0], dtype=np.int32)
    out_a = decode_blocks_sharded(db, ids_a, valid, mesh=st.mesh)
    out_b = decode_blocks_sharded(db, ids_b, valid, mesh=st.mesh)
    assert_same(out_a, out_b)
    assert (out_a["n_reads"][3:] == 0).all() and (out_a["read_pos"][3:] == -1).all()
    want = ref_read(sharded_case, "2bit", [2, 4, 1])
    assert_same({k: v[:3] for k, v in out_a.items()}, want)
    with pytest.raises(ValueError, match="do not split"):
        decode_blocks_sharded(db, ids_a[:5], valid[:5], mesh=st.mesh)


# ------------------------------------------------ SAGe_ISP over the shards
@pytest.mark.parametrize("mode", ("dispatch", "pipelined"))
def test_sharded_stream_and_isp_match_reference(sharded_case, mode):
    """A sharded session's kmer stream, consensus windows and exact-match
    filter equal repro's single-device ones."""
    st = port_store(sharded_case, 2, "v2")
    theirs = sharded_case[3]
    kw = dict(fmt="kmer", kmer_k=4, blocks_per_fetch=4, start_block=1, max_fetches=3)
    got = list(st.session().read_stream("ds", mode=mode, **kw))
    want = list(theirs.session().read_stream("ds", mode="dispatch", **kw))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.block_ids, b.block_ids)
        assert_same(a.data, b.data)
    w_o, s_o = st.consensus_windows("ds", IDS)
    w_t, s_t = theirs.consensus_windows("ds", IDS)
    np.testing.assert_array_equal(w_o, w_t)
    np.testing.assert_array_equal(s_o, s_t)
    m_o, p_o, t_o = FT.filter_store_blocks(st.session(), "ds", (2, 9))
    m_t, p_t, t_t = FJ.filter_store_blocks(theirs.session(), "ds", (2, 9))
    np.testing.assert_array_equal(m_o, m_t)
    assert (p_o, t_o) == (p_t, t_t)


# ------------------------------------------- k-mer stream shard invariance
def test_kmer_stream_invariant_across_shards(sharded_case):
    """Same cursor -> same tokens, bit for bit, for shards in {1, 2, 4}
    (pipelines of their own sharded stores, ``mesh=``) and a one-device
    store, all equal to repro's single-device stream."""
    sf, psf, _path, _t = sharded_case

    def fetch(p, n_fetches=6):
        chunks = [np.asarray(p._fetch_tokens()) for _ in range(n_fetches)]
        return np.concatenate(chunks), p.cursor

    want, want_cursor = fetch(RefPipeline(sf, vocab_size=256, batch=2, seq_len=16, blocks_per_fetch=3))
    assert want.size > 0
    runs = {"one_device": SageTokenPipeline(psf, vocab_size=256, batch=2, seq_len=16, blocks_per_fetch=3,
                                            store=SageStore(device="cpu"))}
    for shards in SHARDS:
        runs[shards] = SageTokenPipeline(psf, vocab_size=256, batch=2, seq_len=16, blocks_per_fetch=3,
                                         mesh=BlockMesh([CPU] * shards))
        assert runs[shards].store.mesh.shards == shards
    for what, p in runs.items():
        got, cursor = fetch(p)
        np.testing.assert_array_equal(got, want, err_msg=f"shards={what}")
        assert cursor.to_json() == want_cursor.to_json(), what
