"""The port's self-healing store on the CPU: parity reconstruction in flight,
``SageStore.repair``, the ``Scrubber`` and the migration tool, and the
chaos suite (the storage -> serving stack under faults injected with the
port's own ``repro_torch.testing.faults.inject``, whose seam is
``repro_torch.core.layout._open_read``), held against the JAX package:
both packages' at-rest helpers flip the same bytes, ``repair`` returns the
same summary on two copies of one damaged file, and the repaired file's
bytes equal the undamaged file's."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import SageStore as RefStore
from repro.core.layout import write_v2
from repro.testing import faults as ref_faults

from repro_torch.core import SageStore, Scrubber
from repro_torch.core.errors import IntegrityError, RetryPolicy, TornWriteError, TransientIOError
from repro_torch.core.layout import SageContainerV2, container_version
from repro_torch.serving import Request, SageServer, SessionPool
from repro_torch.testing import (
    FaultPlan,
    corrupt_extent,
    corrupt_extents,
    corrupt_group,
    corrupt_parity,
    inject,
    truncate_file,
)

from torch_cases import encoded_case

GB = 2  # store residency group size (!= the container's parity_group)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def sf():
    _, sf = encoded_case("illumina")
    assert sf.meta.n_blocks >= 4 * GB
    return sf


@pytest.fixture(scope="module")
def plain_path(sf, tmp_path_factory):
    p = tmp_path_factory.mktemp("heal") / "plain.sage2"
    write_v2(sf, p, align=512)
    return str(p)


@pytest.fixture()
def working_copy(plain_path, tmp_path):
    """A private copy of the parity-free container, free to damage."""
    p = tmp_path / "ds.sage2"
    shutil.copy(plain_path, p)
    return str(p)


@pytest.fixture()
def parity_path(sf, tmp_path):
    p = tmp_path / "parity.sage2"
    write_v2(sf, p, align=512, parity="xor", parity_group=4)
    return str(p)


@pytest.fixture()
def rs_path(sf, tmp_path):
    p = tmp_path / "rs.sage2"
    write_v2(sf, p, align=512, parity="rs", parity_group=4, parity_shards=2)
    return str(p)


def store_over(path, **kw):
    kw.setdefault("group_blocks", GB)
    store = SageStore(device="cpu", **kw)
    store.register("ds", path)
    return store


def read_all(store, fmt="2bit", fused=False):
    return store.session(fused=fused).read("ds", None, fmt=fmt, kmer_k=4)


def tokens(out):
    return out["tokens"].numpy() if hasattr(out["tokens"], "numpy") else np.asarray(out["tokens"])


def assert_tokens_equal(a, b):
    np.testing.assert_array_equal(tokens(a), tokens(b))


def serve_pool(path):
    pool = SessionPool(device="cpu", max_prepared=4, group_blocks=GB)
    pool.store.register("ds", path)
    return pool


# ------------------------------------------------- the JAX package's bytes
@pytest.mark.parametrize("helper,args,kw", [
    ("corrupt_extent", (3,), dict(byte=11, bit=2)),
    ("corrupt_extent", (5,), dict(byte=10_000_019, bit=7)),  # wraps into the stored length
    ("corrupt_extents", ([0, 6, 9],), dict(byte=5, bit=4)),
    ("corrupt_group", (2, GB), dict(byte=9, bit=6)),
    ("corrupt_parity", (1,), dict(shard=0, byte=9, bit=6)),
])
def test_at_rest_helpers_flip_the_same_bytes_as_reference(parity_path, tmp_path, helper, args, kw):
    clean = Path(parity_path).read_bytes()
    theirs = tmp_path / "theirs.sage2"
    shutil.copy(parity_path, theirs)
    undo = getattr(sys.modules["repro_torch.testing"], helper)(parity_path, *args, **kw)
    getattr(ref_faults, helper)(str(theirs), *args, **kw)
    mine = Path(parity_path).read_bytes()
    assert mine == theirs.read_bytes()
    assert mine != clean
    undo()
    assert Path(parity_path).read_bytes() == clean


def test_reference_inject_reaches_nothing_in_the_port(plain_path):
    """repro.testing.faults.inject patches the JAX package's seam: a port
    read under it sees no fault; the port's own inject does."""
    store = store_over(plain_path)
    store.meta("ds")
    with ref_faults.inject(ref_faults.FaultPlan(eio_every=1)) as plan:
        read_all(store)
    assert plan.reads == 0 and store.io_stats["read_retries"] == 0
    store = store_over(plain_path)
    store.meta("ds")
    with inject(FaultPlan(eio_reads=frozenset({0}))) as plan:
        read_all(store)
    assert plan.reads > 0 and plan.eio_raised == 1 and store.io_stats["read_retries"] == 1


@pytest.mark.parametrize("damage", [[3], [0, 6], [9]])
def test_repair_summary_and_repaired_bytes_match_reference(parity_path, tmp_path, damage):
    clean = Path(parity_path).read_bytes()
    theirs = str(tmp_path / "theirs.sage2")
    corrupt_extents(parity_path, damage, byte=7, bit=3)
    shutil.copy(parity_path, theirs)
    if damage == [9]:  # a damaged parity shard on top
        for p in (parity_path, theirs):
            corrupt_parity(p, 0, byte=3, bit=1)
    ours = store_over(parity_path)
    ref = RefStore(group_blocks=GB)
    ref.register("ds", theirs)
    got, want = ours.repair("ds"), ref.repair("ds")
    assert got == want
    assert got["repaired_blocks"] == damage
    assert got["repaired_parity_shards"] == ([0] if damage == [9] else [])
    assert Path(parity_path).read_bytes() == Path(theirs).read_bytes() == clean


# ------------------------------------------------- clean-path bit identity
@pytest.mark.parametrize("fmt", ["2bit", "onehot", "kmer"])
@pytest.mark.parametrize("fused", [False, True], ids=["two_step", "fused"])
def test_parity_container_clean_path_bit_identical(plain_path, parity_path, rs_path, fmt, fused):
    want = read_all(store_over(plain_path), fmt, fused)
    for p in (parity_path, rs_path):
        got = read_all(store_over(p), fmt, fused)
        assert_tokens_equal(got, want)
        np.testing.assert_array_equal(got[fmt if fmt != "2bit" else "tokens"].float().numpy(),
                                      want[fmt if fmt != "2bit" else "tokens"].float().numpy())


def test_container_version_reports_parity(plain_path, parity_path, rs_path):
    for path, scheme, m in ((plain_path, None, 0), (parity_path, "xor", 1), (rs_path, "rs", 2)):
        d = container_version(path, detail=True)
        assert d["version"] == 2 and d["integrity"]
        assert d["parity"] == scheme and d["parity_shards"] == m


# -------------------------------------------------- in-flight reconstruction
def test_inflight_reconstruction_serves_bit_identical(plain_path, parity_path):
    undo = corrupt_extent(parity_path, 1, byte=7, bit=5)
    store = store_over(parity_path)
    assert_tokens_equal(read_all(store), read_all(store_over(plain_path)))
    io = store.io_stats
    assert io["reconstructions"] >= 1 and io["parity_reads"] >= 1
    assert io["reconstruction_failures"] == 0
    assert store.health("ds")["ok"]  # healed in flight, never quarantined
    assert SageContainerV2.open(parity_path).verify_blocks() == [1]  # the medium is still damaged
    undo()


def test_rs_container_survives_double_erasure(plain_path, rs_path):
    corrupt_extents(rs_path, [4, 6], byte=3, bit=1)  # both in parity group 1
    store = store_over(rs_path)
    assert_tokens_equal(read_all(store), read_all(store_over(plain_path)))
    assert store.io_stats["reconstructions"] >= 2


def test_damage_beyond_parity_budget_raises_typed(parity_path):
    corrupt_extents(parity_path, [0, 2], byte=3, bit=1)  # xor: 1-shard budget
    store = store_over(parity_path)
    with pytest.raises(IntegrityError) as ei:
        read_all(store)
    assert set(ei.value.blocks or ()) >= {0, 2}
    assert store.io_stats["reconstruction_failures"] >= 1
    assert not store.health("ds")["ok"]


def test_damaged_parity_is_never_used_for_reconstruction(parity_path):
    corrupt_extent(parity_path, 1, byte=2, bit=4)
    corrupt_parity(parity_path, group=0, shard=0, byte=5, bit=3)
    store = store_over(parity_path)
    with pytest.raises(IntegrityError):
        read_all(store)
    assert store.io_stats["reconstruction_failures"] >= 1


# ------------------------------------------------------- durable repair
def test_store_repair_full_sweep_heals_the_medium(plain_path, parity_path):
    corrupt_extent(parity_path, 3, byte=11, bit=2)
    store = store_over(parity_path)
    summary = store.repair("ds")  # nothing quarantined -> full scan
    assert summary["damaged_blocks"] == [3] and summary["repaired_blocks"] == [3]
    assert summary["scanned_blocks"] == store.n_blocks("ds")
    fresh = SageContainerV2.open(parity_path)
    assert fresh.verify_blocks() == [] and fresh.verify_parity() == []
    assert_tokens_equal(read_all(store), read_all(store_over(plain_path)))


def test_store_repair_lifts_quarantine_only_after_reverify(plain_path, parity_path):
    corrupt_extent(parity_path, 2, byte=4, bit=7)
    store = store_over(parity_path)
    read_all(store)  # codec dictionaries of the first reader on the device
    store.quarantine("ds", 1)  # block 2 // GB -> store group 1
    with pytest.raises(IntegrityError, match="quarantined"):
        store.session().read("ds", (2, 3))
    old = store._reader("ds")
    assert old in store._device_dicts
    summary = store.repair("ds")  # scope = the quarantined set
    assert summary["lifted_groups"] == [1]
    assert store.health("ds")["ok"]
    assert old not in store._device_dicts and store._reader("ds") is not old
    want = store_over(plain_path).session().read("ds", (0, 6), "kmer", kmer_k=4)
    got = store.session().read("ds", (0, 6), "kmer", kmer_k=4)  # serves again
    np.testing.assert_array_equal(got["kmer"].numpy(), want["kmer"].numpy())


def test_store_repair_validation(plain_path, sf):
    from repro_torch.convert import sage_file_from_reference

    store = store_over(plain_path)
    with pytest.raises(ValueError, match="not registered"):
        store.repair("nope")
    with pytest.raises(ValueError, match="out of range"):
        store.repair("ds", group=999)
    eager = SageStore(device="cpu")
    eager.register("mem", sage_file_from_reference(sf))
    with pytest.raises(ValueError, match="v2"):
        eager.repair("mem")


def test_store_repair_without_parity_quarantines_and_raises(working_copy):
    corrupt_extent(working_copy, 0, byte=6, bit=1)
    store = store_over(working_copy)
    with pytest.raises(IntegrityError, match="no parity"):
        store.repair("ds", group=0)
    assert store.health("ds")["quarantined_groups"] == (0,)


# ------------------------------------------------------------- the scrubber
def test_scrub_clean_sweep_reports_in_health(parity_path):
    store = store_over(parity_path)
    r = Scrubber(store, chunk_blocks=4).run_once()
    assert r["complete"] and r["findings"] == []
    assert r["blocks_scanned"] == store.n_blocks("ds")
    h = store.health("ds")
    assert h["ok"] and h["scrub"]["sweeps_completed"] == 1 and h["scrub"]["findings"] == []
    assert store.health()["ds"]["scrub"]["n_blocks"] == store.n_blocks("ds")


def test_scrub_finds_and_repairs_damage(parity_path):
    corrupt_extent(parity_path, 5, byte=8, bit=3)
    store = store_over(parity_path)
    r = Scrubber(store, chunk_blocks=4).run_once()
    assert r["complete"]
    assert [f["action"] for f in r["findings"]] == ["repaired"]
    assert r["findings"][0]["blocks"] == (5,)
    assert SageContainerV2.open(parity_path).verify_blocks() == []
    assert store.health("ds")["ok"]
    assert store.health("ds")["scrub"]["findings"] == r["findings"]


def test_scrub_auto_repair_off_quarantines_for_later(parity_path):
    corrupt_extent(parity_path, 5, byte=8, bit=3)
    store = store_over(parity_path)
    r = Scrubber(store, auto_repair=False).run_once()
    assert [f["action"] for f in r["findings"]] == ["found"]
    assert store.health("ds")["quarantined_groups"] == (2,)  # 5 // GB
    store.repair("ds", group=2)  # deferred repair heals and lifts
    assert store.health("ds")["ok"]
    assert SageContainerV2.open(parity_path).verify_blocks() == []


def test_scrub_unrecoverable_damage_quarantines(parity_path):
    corrupt_extents(parity_path, [0, 2], byte=8, bit=3)  # > xor budget
    store = store_over(parity_path)
    r = Scrubber(store).run_once()
    assert {f["action"] for f in r["findings"]} == {"quarantined"}
    assert not store.health("ds")["ok"]
    assert 0 in store.health("ds")["quarantined_groups"]


def test_damage_landing_mid_sweep_is_caught_next_chunk(parity_path):
    store = store_over(parity_path)
    scrub = Scrubber(store, chunk_blocks=2)
    r = scrub.run_once(max_blocks=2)  # partial pass: cursor at block 2
    assert not r["complete"] and store.health("ds")["scrub"]["cursor"] == 2
    corrupt_extent(parity_path, 6, byte=8, bit=3)  # ahead of the cursor
    r2 = scrub.run_once()  # resumes at 2, reaches the damage
    assert r2["complete"]
    assert [f["action"] for f in r2["findings"]] == ["repaired"]
    assert SageContainerV2.open(parity_path).verify_blocks() == []


def test_scrub_rate_limit_bounds_bandwidth(parity_path):
    store = store_over(parity_path)
    c = SageContainerV2.open(parity_path)
    rate = float(c.extents[:, 1].sum()) / 0.2  # a full sweep must take >= ~0.2 s
    r = Scrubber(store, rate_bps=rate, chunk_blocks=2).run_once()
    assert r["complete"]
    assert r["elapsed_s"] >= 0.9 * (r["bytes_scanned"] / rate)
    assert r["effective_bps"] <= 1.2 * rate


def test_scrub_background_thread_pause_resume_stop(parity_path):
    import time

    store = store_over(parity_path)
    scrub = Scrubber(store, interval_s=0.01)
    scrub.start()
    try:
        with pytest.raises(RuntimeError, match="already running"):
            scrub.start()
        deadline = time.monotonic() + 10
        while scrub.status()["sweeps_completed"] < 2:
            assert time.monotonic() < deadline, "background sweeps never ran"
            time.sleep(0.01)
        scrub.pause()
        assert scrub.paused
        scrub.resume()
        assert not scrub.paused
    finally:
        scrub.stop(join=True)
    assert not scrub.running
    scrub.stop()  # idempotent
    st = scrub.status()
    assert st["sweeps_completed"] >= 2 and st["sweep_errors"] == 0
    assert st["blocks_scanned"] >= 2 * store.n_blocks("ds")


def test_scrub_parameter_validation(parity_path):
    store = store_over(parity_path)
    for kw in (dict(rate_bps=0), dict(chunk_blocks=0), dict(interval_s=-1)):
        with pytest.raises(ValueError):
            Scrubber(store, **kw)


# ------------------------------------------------------------- migrate tool
def migrate(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.migrate_container", *args],
        capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
    )


def test_migrate_add_parity_then_repair_in_place(plain_path, tmp_path):
    prot = str(tmp_path / "prot.sage2")
    r = migrate(plain_path, prot, "--add-parity", "rs", "--parity-group", "4",
                "--parity-shards", "2", "--verify")
    assert r.returncode == 0, r.stderr
    assert "parity rs x2/4" in r.stdout and "bit-identical" in r.stdout
    d = container_version(prot, detail=True)
    assert d["parity"] == "rs" and d["parity_shards"] == 2
    theirs = str(tmp_path / "theirs.sage2")
    write_v2(SageContainerV2.open(plain_path).to_sage_file(), theirs, parity="rs",
             parity_group=4, parity_shards=2)
    assert Path(prot).read_bytes() == Path(theirs).read_bytes()  # the JAX package's writer
    r = migrate(prot, "--repair")
    assert r.returncode == 0 and "nothing to repair" in r.stdout
    corrupt_extents(prot, [0, 2], byte=5, bit=4)  # within the rs budget
    r = migrate(prot, "--repair")
    assert r.returncode == 0, r.stderr
    assert "repaired and re-verified clean" in r.stdout
    fresh = SageContainerV2.open(prot)
    assert fresh.verify_blocks() == [] and fresh.verify_parity() == []
    corrupt_extents(prot, [0, 1, 2], byte=5, bit=4)  # beyond the budget
    r = migrate(prot, "--repair")
    assert r.returncode == 1 and "REPAIR FAILED" in r.stderr


def test_migrate_to_v1_and_back_round_trips(plain_path, tmp_path):
    v1 = str(tmp_path / "ds.npz")
    r = migrate(plain_path, v1, "--to-v1", "--verify")
    assert r.returncode == 0 and "bit-identical" in r.stdout, r.stderr
    raw = str(tmp_path / "raw.sage2")
    r = migrate(v1, raw, "--no-codec", "--verify")
    assert r.returncode == 0 and "raw extents" in r.stdout, r.stderr


def test_migrate_repair_rejects_bad_flag_combos(plain_path, tmp_path):
    r = migrate(plain_path, str(tmp_path / "x"), "--repair")
    assert r.returncode != 0 and "in place" in r.stderr
    r = migrate(plain_path, str(tmp_path / "x.sage2"), "--add-parity", "--to-v1")
    assert r.returncode != 0
    r = migrate(plain_path)  # dst required without --repair
    assert r.returncode != 0


# ------------------------------------------------------------ transient I/O
def test_transient_eio_read_succeeds_via_retry(plain_path, working_copy):
    want = read_all(store_over(plain_path))
    store = store_over(working_copy)
    store.meta("ds")  # prime the header-only open; faults hit ranged reads
    with inject(FaultPlan(eio_reads=frozenset({0, 2}))) as plan:
        got = read_all(store)
    assert_tokens_equal(got, want)
    assert plan.eio_raised == 2
    io = store.io_stats
    assert io["read_retries"] >= 2 and io["read_failures"] == 0
    assert store.health("ds")["ok"]  # transient faults never quarantine


def test_persistent_eio_is_transient_error_then_recovers(working_copy):
    store = store_over(working_copy)
    store.meta("ds")
    with pytest.raises(TransientIOError):
        with inject(FaultPlan(eio_every=1)):
            read_all(store)
    io = store.io_stats
    assert io["read_failures"] >= 1
    assert store.health("ds")["ok"]  # NOT quarantined: the medium may heal
    read_all(store)
    assert store.io_stats["read_failures"] == io["read_failures"]


def test_slow_and_flipped_reads_complete_bit_identically(plain_path, working_copy):
    want = read_all(store_over(plain_path))
    store = store_over(working_copy)
    store.meta("ds")
    off = int(SageContainerV2.open(working_copy).extents[3, 0]) + 2
    with inject(FaultPlan(slow_s=0.001, flip_offsets={off: 0x10}, flip_times=1)) as plan:
        got = read_all(store)
    assert_tokens_equal(got, want)
    assert plan.slow_sleeps > 0 and plan.flips == 1
    io = store.io_stats  # the transient flip failed its CRC once and re-read clean
    assert io["checksum_retries"] == 1 and io["checksum_failures"] == 0


# -------------------------------------------- detection: zero silent decodes
@pytest.mark.parametrize("fmt", ["2bit", "onehot", "kmer"])
@pytest.mark.parametrize("fused", [False, True], ids=["two_step", "fused"])
def test_at_rest_corruption_always_detected(working_copy, fmt, fused):
    corrupt_group(working_copy, 1, GB, byte=9, bit=6)
    store = store_over(working_copy)
    with pytest.raises(IntegrityError) as ei:
        read_all(store, fmt=fmt, fused=fused)
    assert ei.value.dataset == "ds" and ei.value.block_group == 1
    assert store.health("ds")["quarantined_groups"] == (1,)


def test_quarantine_fails_fast_and_clears_after_repair(plain_path, working_copy):
    undo = corrupt_group(working_copy, 1, GB, byte=9, bit=6)
    store = store_over(working_copy)
    with pytest.raises(IntegrityError):
        read_all(store)
    store.reset_io_stats()
    with pytest.raises(IntegrityError, match="quarantined"):
        read_all(store)
    assert store.io_stats["extent_reads"] == 0  # refused without re-reading
    out = store.session().read("ds", (0, GB))  # healthy groups keep serving
    assert_tokens_equal(out, store_over(plain_path).session().read("ds", (0, GB)))
    undo()
    store.clear_quarantine("ds")
    assert store.health("ds")["ok"]
    assert_tokens_equal(read_all(store), read_all(store_over(plain_path)))


def test_reregister_also_lifts_quarantine(working_copy):
    undo = corrupt_group(working_copy, 0, GB)
    store = store_over(working_copy)
    with pytest.raises(IntegrityError):
        read_all(store)
    undo()
    store.register("ds", working_copy)
    assert store.health("ds")["ok"]
    read_all(store)


def test_truncated_container_refused_at_open(working_copy):
    truncate_file(working_copy, os.path.getsize(working_copy) - 512)
    with pytest.raises(TornWriteError, match="footer"):
        read_all(store_over(working_copy))


def test_retry_policy_bounds_are_configurable(working_copy):
    store = store_over(working_copy)
    store._reader("ds").retry = RetryPolicy(attempts=1)
    with pytest.raises(TransientIOError):
        with inject(FaultPlan(eio_reads=frozenset({0}))):
            read_all(store)
    assert store.io_stats["read_retries"] == 0


# ------------------------------------------------- serving-level degradation
def test_quarantined_group_fails_only_touching_requests(plain_path, working_copy):
    corrupt_group(working_copy, 1, GB, byte=3, bit=2)
    srv = SageServer(serve_pool(working_copy))
    healthy = srv.read("ds", (0, GB))  # group 0 only
    doomed = srv.read("ds", (GB, 2 * GB))  # group 1 only
    srv.run_until_idle()
    with pytest.raises(IntegrityError) as ei:
        doomed.result(timeout=0)
    assert ei.value.block_group == 1
    out = healthy.result(timeout=0)
    direct = serve_pool(plain_path).session().read("ds", (0, GB))
    np.testing.assert_array_equal(out["data"]["tokens"], direct["tokens"].numpy())
    assert srv.batcher.stats["isolated_failures"] == 1
    assert srv.health("ds")["quarantined_groups"] == (1,)
    assert srv.health() == {"ds": {"ok": False, "quarantined_groups": (1,)}}


def test_single_request_spanning_bad_group_fails_alone(working_copy):
    corrupt_group(working_copy, 1, GB)
    srv = SageServer(serve_pool(working_copy))
    h = srv.read("ds", (0, 2 * GB))
    srv.run_until_idle()
    with pytest.raises(IntegrityError):
        h.result(timeout=0)


def test_isp_stream_degrades_at_the_bad_group(working_copy):
    corrupt_group(working_copy, 1, GB, byte=5, bit=1)
    srv = SageServer(serve_pool(working_copy))
    h = srv.submit(Request(kind="isp", dataset="ds", block_range=(0, 2 * GB), blocks_per_fetch=1))
    srv.run_until_idle()
    srv.stop()
    got = []
    with pytest.raises(IntegrityError):
        for chunk in h.chunks(timeout=5):
            got.append(chunk["block_ids"])
    assert [int(i[0]) for i in got] == list(range(GB))  # group 0 arrived first


def test_transient_eio_invisible_to_served_requests(plain_path, working_copy):
    srv = SageServer(serve_pool(working_copy))
    srv.pool.store.meta("ds")
    with inject(FaultPlan(eio_reads=frozenset({0}))):
        h = srv.read("ds", (0, GB))
        srv.run_until_idle()
        out = h.result(timeout=0)
    direct = serve_pool(plain_path).session().read("ds", (0, GB))
    np.testing.assert_array_equal(out["data"]["tokens"], direct["tokens"].numpy())
    assert srv.pool.store.io_stats["read_retries"] >= 1
    assert srv.batcher.stats["isolated_failures"] == 0


def test_serving_survives_at_rest_damage_in_flight(plain_path, parity_path):
    corrupt_group(parity_path, 1, GB, byte=9, bit=6)
    srv = SageServer(serve_pool(parity_path))
    h = srv.read("ds", None)
    srv.run_until_idle()
    out = h.result(timeout=0)  # no raise: healed mid-read
    np.testing.assert_array_equal(out["data"]["tokens"], tokens(read_all(store_over(plain_path))))
    assert srv.batcher.stats["isolated_failures"] == 0
    io = srv.pool.store.io_stats
    assert io["reconstructions"] >= 1 and io["reconstruction_failures"] == 0
    assert srv.health("ds")["ok"]


def test_batcher_repairs_quarantined_group_on_demand(plain_path, parity_path):
    corrupt_group(parity_path, 1, GB, byte=9, bit=6)
    srv = SageServer(serve_pool(parity_path))
    srv.pool.store.quarantine("ds", 1)  # scrub finding, repair deferred
    h = srv.read("ds", None)
    srv.run_until_idle()
    out = h.result(timeout=0)  # no raise: repaired mid-round and retried
    np.testing.assert_array_equal(out["data"]["tokens"], tokens(read_all(store_over(plain_path))))
    st = srv.batcher.stats
    assert st["repair_attempts"] == 1 and st["auto_repairs"] == 1
    assert st["isolated_failures"] == 0
    assert srv.health("ds")["ok"]
    fresh = SageContainerV2.open(parity_path)
    assert fresh.verify_blocks() == [] and fresh.verify_parity() == []


def test_damage_beyond_parity_budget_fails_only_touching_requests(plain_path, parity_path):
    corrupt_extents(parity_path, [0, 1], byte=9, bit=6)  # same parity group, store group 0
    srv = SageServer(serve_pool(parity_path))
    doomed = srv.read("ds", (0, GB))
    fine = srv.read("ds", (4 * GB, 5 * GB))
    srv.run_until_idle()
    with pytest.raises(IntegrityError):
        doomed.result(timeout=0)
    direct = serve_pool(plain_path).session().read("ds", (4 * GB, 5 * GB))
    np.testing.assert_array_equal(fine.result(timeout=0)["data"]["tokens"], direct["tokens"].numpy())
    st = srv.batcher.stats
    assert st["repair_attempts"] == 1 and st["auto_repairs"] == 0 and st["isolated_failures"] == 1
    assert 0 in srv.health("ds")["quarantined_groups"]


def test_partial_clear_quarantine_under_serving(plain_path, working_copy):
    g = GB
    undo1 = corrupt_group(working_copy, 1, g, byte=9, bit=6)
    corrupt_group(working_copy, 2, g, byte=7, bit=3)
    srv = SageServer(serve_pool(working_copy))
    h1, h2 = srv.read("ds", (g, 2 * g)), srv.read("ds", (2 * g, 3 * g))
    srv.run_until_idle()
    for h in (h1, h2):
        with pytest.raises(IntegrityError):
            h.result(timeout=0)
    assert srv.health("ds")["quarantined_groups"] == (1, 2)
    # no parity on this container: one repair attempt per group, no heal
    assert srv.batcher.stats["repair_attempts"] == 2
    assert srv.batcher.stats["auto_repairs"] == 0
    undo1()
    srv.pool.store.clear_quarantine("ds", 1)
    assert srv.health("ds") == {"ok": False, "quarantined_groups": (2,)}
    ok, doomed = srv.read("ds", (g, 2 * g)), srv.read("ds", (2 * g, 3 * g))
    srv.run_until_idle()
    with pytest.raises(IntegrityError, match="quarantined") as ei:
        doomed.result(timeout=0)
    assert ei.value.block_group == 2
    direct = serve_pool(plain_path).session().read("ds", (g, 2 * g))
    np.testing.assert_array_equal(ok.result(timeout=0)["data"]["tokens"], direct["tokens"].numpy())
    assert srv.batcher.stats["repair_attempts"] == 2  # once per group, ever
