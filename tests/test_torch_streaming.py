"""The port's pipelined stream (``read_stream(mode="pipelined")``,
``repro_torch.core.streaming``) on the CPU: batches bit for bit equal to
the JAX package's pipelined stream and to the port's sync and dispatch
streams, the dispatch window, stage accounting, slot recycling, teardown
and in-order typed I/O errors. Mirrors tests/test_stream_pipeline.py."""

import gc
import os
import shutil
import threading
import time

import numpy as np
import pytest

from repro.core import SageStore as RefStore
from repro.core.layout import write_v2
from repro.testing.faults import corrupt_group

from repro_torch.convert import sage_file_from_reference
from repro_torch.core import SageStore
from repro_torch.core.errors import IntegrityError
from repro_torch.core.store import SageReadSession
from repro_torch.core.streaming import PipelinedStream

from torch_cases import assert_same, encoded_case

GROUP = 2


@pytest.fixture(scope="module")
def v2_ds(tmp_path_factory):
    """Encoded dataset + checksummed codec v2 container on disk."""
    _, sf = encoded_case("illumina")
    path = tmp_path_factory.mktemp("stream") / "ds.sage2"
    write_v2(sf, path, align=512)
    assert sf.meta.n_blocks >= 4 * GROUP, "need several residency groups"
    return sf, str(path)


def fresh_store(path, **kw):
    kw.setdefault("group_blocks", GROUP)
    store = SageStore(device="cpu", **kw)
    store.register("ds", path)
    return store


def batch_view(sb):
    return {**sb.data, "block_ids": np.asarray(sb.block_ids),
            "cursor": np.array([sb.epoch, sb.next_block, sb.next_epoch])}


def assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert_same(batch_view(x), batch_view(y))


# -------------------------------------------------------------- mode parity
@pytest.mark.parametrize("fmt", ["2bit", "onehot", "kmer"])
def test_mode_parity_with_wrap_and_boundary_spans(v2_ds, fmt):
    """sync / dispatch / pipelined (plain and fused sessions) deliver the
    JAX package's pipelined StreamBatch sequence on a lazy v2 store,
    including a wrap-around and fetches that straddle block-group
    boundaries (blocks_per_fetch=3, group_blocks=2)."""
    sf, path = v2_ds
    kw = dict(fmt=fmt, kmer_k=4, start_block=sf.meta.n_blocks - 4,
              blocks_per_fetch=3, wrap=True, max_fetches=5)
    ref = RefStore(group_blocks=GROUP)
    ref.register("ds", path)
    want = list(ref.session().read_stream("ds", mode="pipelined", **kw))
    for mode, fused in (("sync", False), ("dispatch", False), ("pipelined", False),
                        ("pipelined", True)):
        got = list(fresh_store(path).session(fused=fused).read_stream("ds", mode=mode, **kw))
        assert_batches_equal(got, want)


def test_pipelined_matches_sync_on_eager_store(v2_ds):
    """Eager (non-lazy) datasets stream through the same pipeline — the I/O
    stage simply has no disk groups to stage."""
    sf, _ = v2_ds
    store = SageStore(device="cpu")
    store.register("ds", sage_file_from_reference(sf))
    sess = store.session(fused=True)
    kw = dict(fmt="2bit", blocks_per_fetch=2, max_fetches=3)
    a = list(sess.read_stream("ds", mode="sync", **kw))
    b = list(sess.read_stream("ds", mode="pipelined", **kw))
    assert_batches_equal(a, b)
    assert store.io_stats["stream_fetches"] == 3


# ---------------------------------------------------------- dispatch window
def test_dispatch_window_holds_exactly_n_in_flight(v2_ds, monkeypatch):
    """dispatch=N dispatches exactly N groups before the first yield and at
    most N ahead of the consumer thereafter."""
    sf, _ = v2_ds
    store = SageStore(device="cpu")
    store.register("ds", sage_file_from_reference(sf))
    sess = store.session()
    reads = []
    orig = SageReadSession.read

    def counting_read(self, *a, **kw):
        reads.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(SageReadSession, "read", counting_read)
    dispatch = 2
    it = sess.read_stream("ds", blocks_per_fetch=1, max_fetches=5,
                          dispatch=dispatch, mode="dispatch")
    seen = 0
    for _ in it:
        seen += 1
        if seen <= 3:  # window still refilling from the descriptor stream
            assert len(reads) == min(5, seen - 1 + dispatch)
    assert seen == 5 and len(reads) == 5


# ------------------------------------------------------------ overlap stats
def test_stream_stats_accounting_and_fold(v2_ds):
    _, path = v2_ds
    store = fresh_store(path)
    sess = store.session(fused=True)
    stream = sess.read_stream("ds", mode="pipelined", blocks_per_fetch=2,
                              max_fetches=4, dispatch=2)
    n = sum(1 for _ in stream)
    assert n == 4
    s = stream.stats.to_dict()
    assert s["fetches"] == 4 and s["io_groups"] >= 4
    assert s["wall_seconds"] > 0
    assert s["inflight_hwm"] >= 2  # the window demonstrably ran ahead
    # double-buffered residency: covering groups of the in-flight fetches
    # only (dispatch slots + one boundary-shared group at most)
    assert s["slot_hwm"] <= 2 + 1
    assert -1.0 <= s["overlap_fraction"] < 1.0
    io = store.io_stats
    assert io["stream_fetches"] == 4
    assert io["stream_wall_seconds"] == pytest.approx(s["wall_seconds"])
    assert io["stream_overlap_fraction"] == pytest.approx(s["overlap_fraction"])
    store.reset_io_stats()
    assert store.io_stats["stream_fetches"] == 0
    assert store.io_stats["stream_overlap_fraction"] == 0.0


def test_wrap_stream_releases_retired_slots(v2_ds):
    """A long wrapped stream keeps device residency bounded: retired fetch
    slots release their groups (host cache keeps the bytes)."""
    _, path = v2_ds
    store = fresh_store(path)
    sess = store.session(fused=True)
    stream = sess.read_stream("ds", mode="pipelined", blocks_per_fetch=2,
                              wrap=True, max_fetches=12, dispatch=2)
    for _ in stream:
        with store._lock:
            # 2 slots x at most 2 covering groups each, + the fetch mid-upload
            assert len(store._prepared) <= 2 * 2 + 2
    assert stream.stats.slot_releases > 0


# ---------------------------------------------------------------- teardown
def _wait_threads_settle(baseline, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        extra = set(threading.enumerate()) - baseline
        if not extra:
            return []
        time.sleep(0.05)
    return [t.name for t in set(threading.enumerate()) - baseline]


def test_abandoned_stream_leaks_no_threads_or_fds(v2_ds):
    _, path = v2_ds
    baseline_threads = set(threading.enumerate())
    fds_before = len(os.listdir("/proc/self/fd"))
    store = fresh_store(path)
    sess = store.session(fused=True)
    stream = sess.read_stream("ds", mode="pipelined", blocks_per_fetch=2,
                              wrap=True, max_fetches=50)
    next(iter(stream))  # mid-stream abandon, worker queue full behind us
    del stream
    gc.collect()
    assert _wait_threads_settle(baseline_threads) == []
    del store, sess
    gc.collect()
    assert len(os.listdir("/proc/self/fd")) <= fds_before


def test_explicit_close_is_idempotent_and_joins_worker(v2_ds):
    _, path = v2_ds
    baseline_threads = set(threading.enumerate())
    sess = fresh_store(path).session(fused=True)
    with sess.read_stream("ds", mode="pipelined", blocks_per_fetch=2,
                          wrap=True, max_fetches=50) as stream:
        next(stream)
    stream.close()  # second close: no-op
    assert _wait_threads_settle(baseline_threads) == []


def test_pipelined_validation_errors(v2_ds):
    sf, _ = v2_ds
    store = SageStore(device="cpu")
    store.register("ds", sage_file_from_reference(sf))
    sess = store.session()
    with pytest.raises(ValueError, match="mode must be one of"):
        sess.read_stream("ds", mode="turbo")
    with pytest.raises(ValueError, match="readahead must be >= 0"):
        sess.read_stream("ds", mode="pipelined", readahead=-1)
    with pytest.raises(ValueError, match="dispatch depth must be >= 1"):
        PipelinedStream(sess, "ds", dispatch=0)


# ------------------------------------------------------------ fault surface
def test_background_io_error_surfaces_typed_and_in_order(v2_ds, tmp_path):
    """Corruption hit by the background I/O stage raises the same typed
    IntegrityError a synchronous read would — at the failing fetch's
    position, after every earlier batch was delivered — and quarantines
    the group. No worker threads survive the failure."""
    _, path = v2_ds
    p = tmp_path / "ds.sage2"
    shutil.copy(path, p)
    corrupt_group(str(p), 1, GROUP, byte=9, bit=6)
    baseline_threads = set(threading.enumerate())
    store = fresh_store(str(p))
    sess = store.session(fused=True)
    stream = sess.read_stream("ds", mode="pipelined", blocks_per_fetch=GROUP,
                              max_fetches=4, dispatch=1)
    first = next(stream)  # group 0 is clean and must be delivered first
    np.testing.assert_array_equal(first.block_ids, np.arange(GROUP))
    with pytest.raises(IntegrityError) as ei:
        next(stream)
    assert ei.value.dataset == "ds" and ei.value.block_group == 1
    assert store.health("ds")["quarantined_groups"] == (1,)
    assert _wait_threads_settle(baseline_threads) == []
    # fail-fast thereafter: the quarantined group is refused without disk I/O
    with pytest.raises(IntegrityError, match="quarantined"):
        store.session().read("ds", (GROUP, GROUP + 1))
