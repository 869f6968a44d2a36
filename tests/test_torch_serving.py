"""The port's SageServer frontend on a CPU pool: everything it returns for
the read path equals a direct ``session.read`` of the same blocks, bit for
bit; streams deliver every chunk in order; the session pool keeps ONE
device residency across tenants; generate rows equal a direct engine call;
and one mixed burst through the JAX package's SageServer and through the
port's gives the same chunks and the same batcher stats (generate on the
reduced mamba2-370m, JAX's weights carried across by ``convert``)."""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.core import SageStore as RefStore
from repro.core.layout import write_v2
from repro.models import lm as JLM
from repro.serving import SageServer as RefServer
from repro.serving import ServeConfig as RefServeConfig
from repro.serving import ServingEngine as RefEngine
from repro.serving import SessionPool as RefPool

from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_reference, sage_file_from_reference
from repro_torch.core import SageStore
from repro_torch.data import SageTokenPipeline
from repro_torch.models import lm
from repro_torch.serving import (
    Request,
    RequestState,
    SageServer,
    ServeConfig,
    ServingEngine,
    SessionPool,
    prompts_from_store,
)

from torch_cases import assert_same, encoded_case

FMTS = [("2bit", None), ("kmer", 4), ("onehot", None)]
SC = dict(max_prompt=16, max_new=8)


@pytest.fixture(scope="module")
def pool():
    _, sf = encoded_case("illumina")
    p = SessionPool(device="cpu", max_prepared=4)
    p.register("ds", sage_file_from_reference(sf))
    return p


@pytest.fixture(scope="module")
def v2_path(tmp_path_factory):
    """The same read set as a codec v2 container (out-of-core, ranged)."""
    _, sf = encoded_case("illumina")
    path = tmp_path_factory.mktemp("serve_v2") / "ds.sage2"
    write_v2(sf, path)
    return str(path)


@pytest.fixture(scope="module")
def v2_pool(v2_path):
    p = SessionPool(device="cpu", max_prepared=4, group_blocks=2)
    p.register("ds", v2_path)
    return p


@pytest.fixture(scope="module")
def models():
    """Both packages' reduced mamba2-370m with the same weights: JAX's init,
    the tied embedding scaled x50 so greedy choices are separated as a
    trained model's are (``tests/test_torch_engine.py`` explains why)."""
    jcfg = jax_arch("mamba2-370m").reduced()
    cfg = get_arch("mamba2-370m").reduced()
    params = JLM.init_params(jax.random.PRNGKey(11), jcfg)
    params = {**params, "embed": params["embed"] * 50.0}
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    return jcfg, params, cfg, model


@pytest.fixture(scope="module")
def engine(models):
    _, _, cfg, model = models
    return ServingEngine(cfg, model, ServeConfig(**SC))


def _np(v):
    return v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()


def assert_chunk_equals_direct(data: dict, direct: dict):
    """A served chunk's arrays equal a direct session read, key for key,
    dtype and value (block_ids are checked by the caller)."""
    assert sorted(data) == sorted(k for k in direct if k != "block_ids")
    for key, v in data.items():
        want = direct[key]
        if want.dtype == torch.bfloat16:  # numpy has no bfloat16: a host tensor
            assert isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16 and v.device.type == "cpu"
            assert torch.equal(v, want), key
        else:
            assert isinstance(v, np.ndarray), key
            assert v.dtype == _np(want).dtype, key
            np.testing.assert_array_equal(v, _np(want), err_msg=key)


# ------------------------------------------------------------------ parity
@pytest.mark.parametrize("fmt,k", FMTS, ids=[f for f, _ in FMTS])
def test_server_read_parity_with_direct_session(pool, fmt, k):
    srv = SageServer(pool)
    h = srv.read("ds", (0, 3), fmt=fmt, kmer_k=k)
    srv.run_until_idle()
    got = h.result(timeout=0)
    np.testing.assert_array_equal(got["block_ids"], np.arange(3))
    assert_chunk_equals_direct(got["data"], pool.session().read("ds", (0, 3), fmt, kmer_k=k))


def test_fused_batch_parity_each_request_gets_its_own_slice(pool):
    """Overlapping concurrent requests fuse into one decode; every tenant
    still receives exactly its own blocks."""
    srv = SageServer(pool)
    ranges = [(0, 2), (1, 4), (2, 3), (0, 4)]
    hs = [srv.read("ds", r) for r in ranges]
    srv.run_until_idle()
    assert srv.batcher.stats["fused_reads"] == 1  # one decode for all four
    assert srv.batcher.stats["fused_blocks"] == 4
    sess = pool.session()
    for h, r in zip(hs, ranges):
        got = h.result(timeout=0)
        np.testing.assert_array_equal(got["block_ids"], np.arange(*r))
        assert_chunk_equals_direct(got["data"], sess.read("ds", r))


def test_isp_stream_chunks_match_direct_reads(pool):
    srv = SageServer(pool)
    h = srv.stream("ds", (0, 4), blocks_per_fetch=2, fmt="kmer", kmer_k=4)
    srv.run_until_idle()
    chunks = list(h.chunks(timeout=0))
    assert [c["fetch"] for c in chunks] == [0, 1]
    sess = pool.session()
    for c in chunks:
        assert_chunk_equals_direct(c["data"], sess.read("ds", c["block_ids"], "kmer", kmer_k=4))


def test_consensus_parity(pool):
    srv = SageServer(pool)
    h = srv.consensus("ds", (1, 4))
    srv.run_until_idle()
    wins, starts = pool.store.consensus_windows("ds", np.arange(1, 4))
    out = h.result(timeout=0)
    np.testing.assert_array_equal(out["windows"], wins)
    np.testing.assert_array_equal(out["starts"], starts)


def test_v2_store_served_block_granular(v2_pool):
    """Out-of-core datasets serve through the same frontend: residency is
    block-group granular and reads touch only covering groups."""
    store = v2_pool.store
    store.evict()
    store.reset_io_stats()
    srv = SageServer(v2_pool)
    h = srv.read("ds", (0, 2))
    srv.run_until_idle()
    assert_chunk_equals_direct(h.result(timeout=0)["data"], v2_pool.session().read("ds", (0, 2)))
    assert 0.0 < store.resident_fraction("ds") < 1.0  # only group 0 resident
    assert store.resident_fraction("ds", [0, 1]) == 1.0


def test_isp_stream_prefetches_next_chunk_on_the_host(v2_pool):
    """A stream over a lazy dataset stages its next chunk's groups disk ->
    host cache in the background (HostPrefetcher) and still serves every
    chunk equal to a direct read."""
    srv = SageServer(v2_pool)
    v2_pool.store.evict()
    h = srv.stream("ds", (0, 8), blocks_per_fetch=2)
    srv.run_until_idle()
    srv.stop()  # joins the prefetch worker and folds its counters in
    chunks = list(h.chunks(timeout=0))
    assert [c["block_ids"].tolist() for c in chunks] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    st = srv.batcher.stats
    assert st["isp_prefetched_groups"] + st["isp_prefetch_errors"] >= 1
    assert st["isp_prefetch_errors"] == 0
    for c in chunks:
        assert_chunk_equals_direct(c["data"], v2_pool.session().read("ds", c["block_ids"]))


def test_multi_tenant_requests_share_one_residency(pool):
    """N concurrent tenants on one dataset = ONE prepare+upload."""
    store = pool.store
    store.evict()
    store.reset_cache_stats()
    srv = SageServer(pool)
    hs = [srv.read("ds", (0, 2)) for _ in range(6)]
    srv.run_until_idle()
    assert all(h.state is RequestState.FINISHED for h in hs)
    assert store.cache_stats("ds")["misses"] == 1  # single preparation


def test_background_server_thread(pool):
    with SageServer(pool) as srv:
        done = []

        def client(i):
            h = srv.read("ds", (i % 3, i % 3 + 2))
            out = h.result(timeout=60)
            done.append((i, out is not None, h.state))

        ts = [threading.Thread(target=client, args=(i,)) for i in range(5)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
            assert not t.is_alive()
    assert len(done) == 5
    assert all(ok and st is RequestState.FINISHED for _, ok, st in done)


# ---------------------------------------------------------------- generate
def test_generate_through_server_matches_engine(pool, engine):
    srv = SageServer(pool, engine=engine)
    prompt = np.arange(1, 9, dtype=np.int32)
    h1 = srv.generate(prompt=prompt)
    h2 = srv.generate(dataset="ds", block_range=(0, 1), max_prompt=12, kmer_k=3)
    srv.run_until_idle()
    assert srv.batcher.stats["generate_batches"] == 1  # one padded batch
    # greedy decoding is row-independent: the fused batch row equals a solo
    # engine call on the same prompt
    np.testing.assert_array_equal(h1.result(timeout=0)["tokens"], engine.generate([prompt])[0])
    expect_p = prompts_from_store(pool.session(), "ds", vocab=engine.cfg.vocab, n_prompts=1,
                                  max_prompt=12, kmer_k=3, block_range=(0, 1))[0]
    np.testing.assert_array_equal(h2.result(timeout=0)["tokens"], engine.generate([expect_p])[0])


def test_generate_empty_prompt_range_aborts_cleanly(pool, engine):
    srv = SageServer(pool, engine=engine)
    h = srv.generate(dataset="ds", block_range=(0, 1), kmer_k=15, max_prompt=4)
    srv.run_until_idle()
    if h.state is RequestState.ABORTED:  # reads shorter than 15-mers only
        with pytest.raises(ValueError, match="no prompts"):
            list(h.chunks(timeout=0))
    else:  # the block has reads of >= 15 bases: it generated
        assert h.result(timeout=0)["tokens"].shape == (SC["max_new"],)


# ------------------------------------------------------- session pool glue
def test_session_pool_shares_sessions_and_store(pool):
    s1, s2, s3 = pool.session(), pool.session(), pool.session(fused=True)
    assert s1 is s2 and s1 is not s3
    assert not s1.fused and s3.fused
    assert pool.n_sessions == 2
    assert s1.store is pool.store


def test_pipeline_reuses_pooled_session(pool):
    pipe = pool.pipeline("ds", vocab_size=259, batch=2, seq_len=16)
    assert pipe.session is pool.session()
    assert pipe.store is pool.store
    batch = next(pipe.batches())
    assert batch["tokens"].shape == (2, 16)


def test_pipeline_rejects_foreign_session(pool):
    other = SageStore(device="cpu")
    with pytest.raises(ValueError, match="different store"):
        SageTokenPipeline("ds", 259, 2, 16, store=other, session=pool.session())


def test_cache_stats_reset(pool):
    pool.session().read("ds", (0, 1))
    tot = pool.store.cache_stats()["total"]
    assert tot["misses"] + tot["hits"] > 0
    pool.store.reset_cache_stats()
    assert pool.store.cache_stats() == {
        "per_dataset": {}, "total": {"hits": 0, "misses": 0, "evictions": 0}
    }
    assert pool.store.cache_stats("ds") == {"hits": 0, "misses": 0, "evictions": 0}


def test_residency_scoring_errors_counted_not_swallowed_silently(pool):
    before = pool.residency_score_errors
    assert pool.request_residency(Request(kind="read", dataset="nope")) == 0.0
    assert pool.residency_score_errors == before
    bad = Request(kind="read", dataset="ds", block_range=(0, 10_000))
    assert pool.request_residency(bad) == 0.0
    assert pool.residency_score_errors == before + 1
    assert pool.stats()["residency_score_errors"] == before + 1
    ok = Request(kind="read", dataset="ds", block_range=(0, 1))
    assert 0.0 <= pool.request_residency(ok) <= 1.0
    assert pool.residency_score_errors == before + 1


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        SessionPool()
    with pytest.raises(RuntimeError, match="cuda"):
        SageServer()


# ------------------------------------------------ against the JAX package
def _burst(srv, nb):
    """One mixed burst, the same for either package's server: overlapping
    reads in every format, a stream, consensus windows and two generates
    (distinct priorities fix their admission order)."""
    hs = [srv.read("ds", (i, i + 3), fmt=f, kmer_k=k) for i in range(0, 9, 2) for f, k in FMTS]
    hs.append(srv.stream("ds", (nb - 7, nb), fmt="kmer", kmer_k=4, blocks_per_fetch=3))
    hs.append(srv.consensus("ds", (2, 6)))
    hs.append(srv.generate(prompt=np.arange(3, 12, dtype=np.int32), priority=1))
    hs.append(srv.generate(dataset="ds", block_range=(5, 6), max_prompt=12, kmer_k=3, priority=2))
    return hs


def test_mixed_burst_matches_reference_server(v2_path, models):
    jcfg, params, cfg, model = models
    ours = SageServer(SessionPool(device="cpu", max_prepared=8, group_blocks=4),
                      engine=ServingEngine(cfg, model, ServeConfig(**SC)))
    theirs = RefServer(RefPool(store=RefStore(max_prepared=8, group_blocks=4)),
                       engine=RefEngine(jcfg, params, RefServeConfig(**SC)))
    results, stats = [], []
    for srv in (ours, theirs):
        srv.pool.store.register("ds", v2_path)
        hs = _burst(srv, srv.pool.store.n_blocks("ds"))
        srv.run_until_idle()
        assert all(h.state.value == "finished" for h in hs)
        results.append([list(h.chunks(timeout=0)) for h in hs])
        stats.append(dict(srv.batcher.stats))
    for mine, want in zip(*results):
        assert len(mine) == len(want) >= 1
        for a, b in zip(mine, want):
            assert sorted(a) == sorted(b)
            for key in a:
                if key == "data":
                    assert_same(a["data"], b["data"])
                else:
                    np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)
    for key in ("rounds", "fused_reads", "fused_read_requests", "fused_blocks",
                "consensus_calls", "generate_batches", "deferred", "isolated_failures"):
        assert stats[0][key] == stats[1][key], key
    assert stats[0]["fused_reads"] < stats[0]["fused_read_requests"]  # the burst fused
    assert stats[0]["generate_batches"] == 1


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-2.7b"])
def test_generate_through_both_servers_matches_reference(arch, monkeypatch):
    """The dense (qwen2-1.5b) and hybrid (zamba2-2.7b) families served
    through both packages' SageServers: a prompt and a store-derived
    prompt in one padded batch each, f32 activations on both sides
    (prefill and decode_step patched), JAX's weights carried across; the
    greedy tokens equal the reference's, token for token."""
    _, sf = encoded_case("illumina")
    jcfg, cfg = jax_arch(arch).reduced(), get_arch(arch).reduced()
    params = JLM.init_params(jax.random.PRNGKey(13), jcfg)
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    for mod, dt in ((JLM, jnp.float32), (lm, torch.float32)):
        monkeypatch.setattr(mod, "prefill", functools.partial(mod.prefill, dtype=dt))
        monkeypatch.setattr(mod, "decode_step", functools.partial(mod.decode_step, dtype=dt))
    ours = SageServer(SessionPool(device="cpu"), engine=ServingEngine(cfg, model, ServeConfig(**SC)))
    theirs = RefServer(RefPool(store=RefStore()), engine=RefEngine(jcfg, params, RefServeConfig(**SC)))
    tokens = []
    for srv, sfile in ((ours, sage_file_from_reference(sf)), (theirs, sf)):
        srv.pool.store.register("ds", sfile)
        hs = [srv.generate(prompt=np.arange(3, 14, dtype=np.int32), priority=1),
              srv.generate(dataset="ds", block_range=(1, 2), max_prompt=12, kmer_k=3, priority=2)]
        srv.run_until_idle()
        assert srv.batcher.stats["generate_batches"] == 1
        tokens.append([h.result(timeout=0)["tokens"] for h in hs])
    for mine, want in zip(*tokens):
        assert mine.shape == (SC["max_new"],)
        np.testing.assert_array_equal(mine, want)


def test_launch_serve_runs_on_the_cpu_and_names_slice_6b(capsys):
    """The launcher serves mamba2-370m, qwen2-1.5b (dense),
    deepseek-moe-16b (moe) and zamba2-2.7b (hybrid) reduced on the CPU; an
    encdec configuration raises, naming slice 6b part 3."""
    from repro_torch.launch import serve

    for arch in ("mamba2-370m", "qwen2-1.5b", "deepseek-moe-16b", "zamba2-2.7b"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "2", "--max-new", "4"])
        out = capsys.readouterr().out
        assert "served 4 mixed requests (2 generate / 8 tokens, 2 reads)" in out and "req/s on cpu" in out, arch
    with pytest.raises(NotImplementedError, match="slice 6b part 3"):
        serve.main(["--arch", "whisper-small", "--smoke", "--device", "cpu"])
