"""The port's request scheduler and continuous batcher on a CPU store: the
serving lifecycle (waiting -> running -> finished/aborted, aborts from both
live states), FCFS vs priority ordering, cache-aware admission preferring
device-resident block groups, eviction fairness under a tiny device LRU,
ingestion and stream backpressure, the memory budget, the union cap, the
oversized request, validation and deadlines; and the same submissions
admitted in the same order, with the same batcher stats, by the JAX
package's scheduler."""

import threading
import time

import numpy as np
import pytest

from repro.core import SageStore as RefStore
from repro.serving import SageServer as RefServer
from repro.serving import SessionPool as RefPool

from repro_torch.convert import sage_file_from_reference
from repro_torch.core import SageStore
from repro_torch.serving import (
    ContinuousBatcher,
    DeadlineExceededError,
    QueueFullError,
    Request,
    RequestState,
    SageServer,
    Scheduler,
    SessionPool,
)

from torch_cases import encoded_case


def _store(max_prepared=4):
    """One encoded read set registered under two names (independent
    residency keys, shared bytes — cheap multi-dataset traffic)."""
    _, sf = encoded_case("illumina")
    store = SageStore(device="cpu", max_prepared=max_prepared)
    ours = sage_file_from_reference(sf)
    store.register("a", ours)
    store.register("b", ours)
    return store


@pytest.fixture(scope="module")
def two_datasets():
    return _store()


def _server(store, **kw):
    kw.setdefault("policy", "fcfs")
    return SageServer(SessionPool(store=store), **kw)


# --------------------------------------------------------------- lifecycle
def test_lifecycle_waiting_running_finished(two_datasets):
    srv = _server(two_datasets)
    h = srv.read("a", (0, 2))
    assert h.state is RequestState.WAITING
    srv.scheduler.admit(4)
    assert h.state is RequestState.RUNNING
    srv.run_until_idle()
    assert h.state is RequestState.FINISHED
    out = h.result(timeout=0)
    assert out is not None and isinstance(out["data"]["tokens"], np.ndarray)
    assert h.latency is not None and h.latency >= 0


def test_abort_from_waiting(two_datasets):
    srv = _server(two_datasets)
    h = srv.read("a", (0, 1))
    assert h.abort() is True
    assert h.state is RequestState.ABORTED
    assert h.abort() is False  # idempotent once terminal
    assert list(h.chunks(timeout=0)) == []  # never ran, channel just closes
    srv.run_until_idle()
    assert srv.scheduler.stats["aborted"] == 1
    assert srv.scheduler.stats["finished"] == 0


def test_abort_from_running_stops_stream(two_datasets):
    srv = _server(two_datasets)
    nb = two_datasets.n_blocks("a")
    h = srv.stream("a", blocks_per_fetch=1, max_fetches=nb)
    assert srv.step() >= 1  # one chunk delivered, stream still running
    assert h.state is RequestState.RUNNING
    assert h.abort() is True
    assert h.state is RequestState.ABORTED
    delivered_before = srv.scheduler.stats["chunks"]
    srv.run_until_idle()
    assert srv.scheduler.stats["chunks"] == delivered_before  # nothing more
    assert len(list(h.chunks(timeout=0))) == 1  # the pre-abort chunk still drains


def test_finish_and_abort_counts(two_datasets):
    srv = _server(two_datasets)
    hs = [srv.read("a", (0, 1)) for _ in range(3)]
    hs[1].abort()
    srv.run_until_idle()
    assert [h.state for h in hs] == [
        RequestState.FINISHED, RequestState.ABORTED, RequestState.FINISHED
    ]
    st = srv.scheduler.stats
    assert (st["finished"], st["aborted"], st["submitted"]) == (2, 1, 3)


# ---------------------------------------------------------------- ordering
def test_fcfs_orders_by_priority_then_arrival():
    sched = Scheduler(policy="fcfs", max_waiting=8)
    hs = [sched.submit(Request(kind="read", dataset="d", priority=p)) for p in (1, 0, 1, 0)]
    order = [e.rid for e in sched.admit(4)]
    assert order == [hs[1].id, hs[3].id, hs[0].id, hs[2].id]


def test_cache_aware_prefers_resident_then_arrival():
    resident = {"hot": 1.0, "cold": 0.0}
    sched = Scheduler(policy="cache_aware", max_waiting=8, residency=lambda r: resident[r.dataset])
    h_cold = sched.submit(Request(kind="read", dataset="cold"))
    h_hot = sched.submit(Request(kind="read", dataset="hot"))
    h_pri = sched.submit(Request(kind="read", dataset="cold", priority=-1))
    order = [e.rid for e in sched.admit(3)]
    # priority beats residency; residency beats arrival
    assert order == [h_pri.id, h_hot.id, h_cold.id]


def test_cache_aware_rescoring_between_rounds():
    """A request whose groups became resident after submission jumps ahead
    at the NEXT admission round (scoring is per-round, not per-submit)."""
    resident = {"x": 0.0, "y": 0.0}
    sched = Scheduler(policy="cache_aware", residency=lambda r: resident[r.dataset])
    sched.submit(Request(kind="read", dataset="x"))
    h_y = sched.submit(Request(kind="read", dataset="y"))
    resident["y"] = 1.0
    assert sched.admit(1)[0].rid == h_y.id


def test_cache_aware_admission_prefers_resident_blocks(two_datasets):
    """With 'a' resident on the store's device, later-submitted 'a'
    requests admit before earlier cold 'b' requests under cache_aware (and
    do NOT under fcfs)."""
    store = two_datasets
    store.evict()
    store.session().read("a", (0, 1))  # make 'a' resident
    for policy, expect_first in (("cache_aware", "a"), ("fcfs", "b")):
        srv = _server(store, policy=policy)
        srv.read("b", (0, 1))
        h_a = srv.read("a", (0, 1))
        first = srv.scheduler.admit(1)[0]
        assert first.request.dataset == expect_first, policy
        if policy == "cache_aware":
            assert first.rid == h_a.id
        srv.scheduler.abort(first.rid)
        for e in list(srv.scheduler.waiting):
            srv.scheduler.abort(e.rid)


def test_eviction_fairness_under_tiny_device_budget():
    """max_prepared=1 + interleaved two-dataset traffic: every request
    still finishes, and cache-aware admission clusters same-dataset
    requests so the tiny LRU thrashes less than strict FCFS."""
    misses = {}
    for policy in ("fcfs", "cache_aware"):
        store = _store(max_prepared=1)
        store.session().read("a", (0, 1))  # warm: 'a' resident
        store.reset_cache_stats()
        srv = _server(store, policy=policy, max_batch_requests=2)
        hs = [srv.read("a" if i % 2 == 0 else "b", (0, 2)) for i in range(8)]
        srv.run_until_idle()
        assert all(h.state is RequestState.FINISHED for h in hs), policy
        misses[policy] = store.cache_stats()["total"]["misses"]
    assert misses["cache_aware"] < misses["fcfs"], misses


def _mixed_burst(srv, nb):
    """The same submissions for either package's server: mixed priorities,
    two datasets, overlapping ranges, a stream and consensus windows."""
    hs = []
    for i in range(10):
        lo = (3 * i) % (nb - 3)
        if i % 5 == 4:
            hs.append(srv.consensus("b", (lo, lo + 2), priority=i % 3))
        elif i % 4 == 3:
            hs.append(srv.stream("a", (lo, lo + 3), fmt="kmer", kmer_k=4, blocks_per_fetch=1,
                                 priority=i % 3))
        else:
            hs.append(srv.read("a" if i % 2 else "b", (lo, lo + 3), priority=i % 3))
    return hs


@pytest.mark.parametrize("policy", ["fcfs", "cache_aware"])
def test_admission_order_and_batcher_stats_match_reference(policy):
    _, sf = encoded_case("illumina")
    ref_store = RefStore(max_prepared=2)
    ref_store.register("a", sf)
    ref_store.register("b", sf)
    ours = _store(max_prepared=2)
    orders, stats = [], []
    for store, server, pool in ((ours, SageServer, SessionPool), (ref_store, RefServer, RefPool)):
        store.session().read("a", (0, 1))  # 'a' resident: cache_aware ranks it first
        srv = server(pool(store=store), policy=policy, max_batch_requests=3)
        hs = _mixed_burst(srv, store.n_blocks("a"))
        index = {h.id: i for i, h in enumerate(hs)}
        order = []
        while srv.scheduler.has_work():
            before = {e.rid for e in srv.scheduler.running}
            srv.step()
            # each package has its own RequestState enum: compare values
            order += [index[h.id] for h in hs if h.state.value != "waiting"
                      and h.id not in before and index[h.id] not in order]
        assert all(h.state.value == "finished" for h in hs)
        orders.append(order)
        stats.append(dict(srv.batcher.stats))
    assert orders[0] == orders[1] and sorted(orders[0]) == list(range(10))
    for key in ("rounds", "fused_reads", "fused_read_requests", "fused_blocks",
                "consensus_calls", "deferred"):
        assert stats[0][key] == stats[1][key], key


# ------------------------------------------------------------- backpressure
def test_waiting_queue_backpressure(two_datasets):
    srv = _server(two_datasets, max_waiting=2)
    srv.read("a", (0, 1))
    srv.read("a", (0, 1))
    with pytest.raises(QueueFullError):
        srv.read("a", (0, 1), timeout=0)
    assert srv.scheduler.stats["rejected"] == 1
    srv.step()  # drains the queue (admission frees waiting slots)
    h = srv.read("a", (0, 1), timeout=0)  # now accepted
    srv.run_until_idle()
    assert h.state is RequestState.FINISHED


def test_stream_buffer_backpressure_pauses_without_dropping(two_datasets):
    srv = _server(two_datasets)
    assert two_datasets.n_blocks("a") >= 3
    h = srv.stream("a", blocks_per_fetch=1, max_fetches=3, stream_buffer=1)
    srv.step()
    assert h.queue_depth == 1
    before = srv.batcher.stats["skipped_backpressure"]
    srv.step()  # consumer lags: no new chunk, stream stays running
    assert h.queue_depth == 1 and h.state is RequestState.RUNNING
    assert srv.batcher.stats["skipped_backpressure"] == before + 1
    it = h.chunks(timeout=1)
    c0 = next(it)  # drain one -> stream resumes
    srv.step()
    c1 = next(it)
    srv.step()  # final fetch delivered; stream finishes
    chunks = [c0, c1] + list(it)
    assert [c["fetch"] for c in chunks] == [0, 1, 2]  # nothing lost
    assert h.state is RequestState.FINISHED


def test_run_until_idle_raises_on_stalled_backpressure(two_datasets):
    srv = _server(two_datasets)
    srv.stream("a", blocks_per_fetch=1, stream_buffer=1)
    with pytest.raises(RuntimeError, match="backpressure"):
        srv.run_until_idle()


# -------------------------------------------------- batch formation limits
def test_memory_budget_defers_but_never_starves(two_datasets):
    bnb = two_datasets.block_nbytes("a")
    srv = _server(two_datasets, max_batch_bytes=2 * bnb)  # ~2 blocks per round
    hs = [srv.read("a", (i, i + 1)) for i in range(4)]
    srv.run_until_idle()
    assert all(h.state is RequestState.FINISHED for h in hs)
    assert srv.batcher.stats["deferred"] > 0


def test_union_block_cap_splits_fused_reads(two_datasets):
    srv = _server(two_datasets, max_union_blocks=1)
    hs = [srv.read("a", (i, i + 1)) for i in range(3)]
    srv.run_until_idle()
    assert all(h.state is RequestState.FINISHED for h in hs)
    assert srv.batcher.stats["fused_reads"] >= 3


def test_oversized_request_runs_alone(two_datasets):
    srv = _server(two_datasets, max_batch_bytes=1)  # nothing "fits"
    h = srv.read("a", (0, 3))
    srv.run_until_idle()
    assert h.state is RequestState.FINISHED
    assert h.result(timeout=0)["data"]["tokens"].shape[0] == 3


# ---------------------------------------------------------------- validation
def test_request_validation():
    with pytest.raises(ValueError, match="unknown request kind"):
        Request(kind="nope")
    with pytest.raises(ValueError, match="needs dataset"):
        Request(kind="read")
    with pytest.raises(ValueError, match="blocks_per_fetch"):
        Request(kind="isp", dataset="d", blocks_per_fetch=0)
    with pytest.raises(ValueError, match="stream_buffer"):
        Request(kind="read", dataset="d", stream_buffer=0)
    with pytest.raises(ValueError, match="unknown policy"):
        Scheduler(policy="lifo")
    with pytest.raises(ValueError, match="max_waiting"):
        Scheduler(max_waiting=0)


def test_submit_validation(two_datasets):
    srv = _server(two_datasets)
    with pytest.raises(KeyError, match="not registered"):
        srv.read("missing", (0, 1))
    with pytest.raises(ValueError, match="kmer_k"):
        srv.read("a", (0, 1), fmt="kmer")
    with pytest.raises(ValueError, match="unknown output format"):
        srv.read("a", (0, 1), fmt="tokens")
    with pytest.raises(ValueError, match="no ServingEngine"):
        srv.generate(prompt=np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="prompt= or dataset="):
        SageServer(SessionPool(store=two_datasets), engine=object()).submit(Request(kind="generate"))
    with pytest.raises(ValueError, match="not both"):
        SageServer(SessionPool(store=two_datasets), store=two_datasets)
    with pytest.raises(ValueError, match="not both"):
        SessionPool(store=two_datasets, max_prepared=2)


def test_bad_range_fails_only_its_own_request(two_datasets):
    srv = _server(two_datasets)
    nb = two_datasets.n_blocks("a")
    good = srv.read("a", (0, 1))
    bad = srv.read("a", (nb, nb + 2))
    srv.run_until_idle()
    assert good.state is RequestState.FINISHED
    assert bad.state is RequestState.ABORTED
    with pytest.raises(ValueError, match="out of bounds"):
        list(bad.chunks(timeout=0))


def test_batcher_knob_validation(two_datasets):
    pool = SessionPool(store=two_datasets)
    with pytest.raises(ValueError, match="max_batch_requests"):
        ContinuousBatcher(pool, Scheduler(), max_batch_requests=0)
    with pytest.raises(ValueError, match="max_union_blocks"):
        ContinuousBatcher(pool, Scheduler(), max_union_blocks=0)


# ---------------------------------------------------------------- deadlines
def test_deadline_expires_from_waiting_and_running():
    sched = Scheduler(policy="fcfs")
    h = sched.submit(Request(kind="read", dataset="d", deadline_s=0.01))
    live = sched.submit(Request(kind="read", dataset="d"))  # no deadline
    assert sched.expire_deadlines(now=h._entry.submit_t + 1.0) == 1
    assert h.state is RequestState.ABORTED and live.state is RequestState.WAITING
    with pytest.raises(DeadlineExceededError, match="deadline_s=0.01"):
        list(h.chunks(timeout=0))
    h2 = sched.submit(Request(kind="read", dataset="d", deadline_s=0.01))
    admitted = sched.admit(2)
    assert h2.state is RequestState.RUNNING
    e = next(e for e in admitted if e.rid == h2.id)
    assert sched.expire_deadlines(now=e.submit_t + 0.5) == 1
    with pytest.raises(DeadlineExceededError, match="state=running"):
        h2.result(timeout=0)
    assert sched.stats["deadline_expired"] == 2


def test_batcher_step_enforces_deadlines(two_datasets):
    srv = _server(two_datasets)
    doomed = srv.submit(Request(kind="read", dataset="a", block_range=(0, 2), deadline_s=0.005))
    ok = srv.read("a", (0, 2))
    time.sleep(0.02)
    srv.run_until_idle()
    assert doomed.state is RequestState.ABORTED
    assert ok.state is RequestState.FINISHED
    with pytest.raises(DeadlineExceededError):
        doomed.result(timeout=0)
    assert srv.scheduler.stats["deadline_expired"] == 1


def test_deadline_abort_finish_race_closes_exactly_once():
    """expire_deadlines / abort / deliver+finish race over requests in both
    live states: every request lands in exactly one terminal state and its
    channel carries exactly one closing sentinel."""
    sched = Scheduler(policy="fcfs", max_waiting=256)
    handles = [sched.submit(Request(kind="read", dataset="d", deadline_s=0.001)) for _ in range(64)]
    entries = [h._entry for h in handles]
    sched.admit(32)  # half RUNNING, half WAITING
    far = entries[0].submit_t + 10.0
    start = threading.Barrier(4)

    def expirer():
        start.wait()
        for _ in range(50):
            sched.expire_deadlines(now=far)

    def aborter():
        start.wait()
        for h in handles:
            sched.abort(h.id)

    def finisher():
        start.wait()
        for e in entries:
            sched.deliver(e, {"rid": e.rid})
            sched.finish(e)

    threads = [threading.Thread(target=t) for t in (expirer, aborter, finisher)]
    for t in threads:
        t.start()
    start.wait()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    st = sched.stats
    assert st["submitted"] == 64 and st["finished"] + st["aborted"] == 64
    assert not sched.has_work()
    for h, e in zip(handles, entries):
        assert e.state.terminal
        if e.state is RequestState.FINISHED:
            assert e.error is None
        try:
            list(h.chunks(timeout=0))
        except DeadlineExceededError:
            pass
        assert e.chan.qsize() == 0  # no second sentinel behind the first
