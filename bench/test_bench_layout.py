"""The benchmark's layout and yardsticks, on the CPU: every cell finds its
files by name, BENCHMARK.json keeps to its format, the roofline counts and
the reference's k-mer formatter agree with hand counts."""

from __future__ import annotations

import json
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness, roofline  # noqa: E402
from bench.reference import kmers  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_its_files_by_name(cell):
    files = harness.cell_files(SPEC, cell)
    assert files["config"].is_file() and files["traffic"].is_file() and files["driver"].is_file()
    assert files["metrics"] and all(p.is_file() for p in files["metrics"].values())
    e2e = [m["name"] for m in harness.metrics_of(SPEC, "end_to_end", cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    traffic = harness.load_json(files["traffic"])
    assert set(traffic["limits"]) and all(v >= 0 for v in traffic["limits"].values())


def test_benchmark_json_keeps_to_its_format():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for n in names + [m["name"] for m in metrics] + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    assert len(set(c["name"] for c in SPEC["configs"])) == len(SPEC["configs"])
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("bench/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    cells = {w["name"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert set(m["workloads"]) <= cells if "workloads" in m else True
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25, m
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200, m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock"), m


def test_every_metric_reader_belongs_to_a_per_layer_metric():
    files = {p.name[:-3] for p in (ROOT / "bench" / "metrics").glob("*.py")}
    assert files == {harness.reader_file(m["name"]).name[:-3] for m in SPEC["per_layer"]}


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_per_layer_metric_lists_its_cells_and_has_a_reader(metric):
    m = next(m for m in SPEC["per_layer"] if m["name"] == metric)
    assert m["workloads"] and set(m["workloads"]) <= {w["name"] for w in SPEC["workloads"]}
    assert callable(harness.reader(harness.reader_file(metric)))


def test_a_reader_is_found_by_its_name_then_by_its_stem():
    assert harness.reader_file("ssd_ms.train").name == "ssd_ms.train.py"
    assert harness.reader_file("device_idle.train").name == "device_idle.py"
    assert harness.reader_file("device_idle.serve").name == "device_idle.py"
    bench = {"end_to_end": SPEC["end_to_end"],
             "per_layer": SPEC["per_layer"] + [{"name": "x.other", "moves": "setup_s", "workloads": ["other"]}]}
    assert "x.other" not in {m["name"] for m in harness.metrics_of(bench, "per_layer", "mamba2-train")}


def test_the_interval_union_merges_overlaps_and_keeps_gaps():
    from bench import trace

    assert trace.union([(5, 7), (0, 2), (1, 3), (3, 4), (6, 6.5)]) == [[0, 4], [5, 7]]
    assert trace.union([]) == []


def test_roofline_counts_match_hand_counts():
    # one (b, chunk, head) of Q = 2, P = N = 1, x in bf16: ops Q(Q+1)N + Q(Q+1)P + 2QNP = 6 + 6 + 4;
    # bytes: x and y 2·2·1·2, dt and a 2·2·4, B and C 2·2·1·4, the state and total 1·(1 + 1)·4
    ms, what = roofline.ssd_bound((1, 1, 2, 1, 1, 1), 2)
    assert ms == pytest.approx(max(48 / roofline.HBM_BYTES_PER_S, 16 / roofline.B6_OPS_PER_S) * 1e3)
    assert what == "bytes"
    # backward: 3·6·1 + 2·6·1 + 4·2 = 38 ops; bytes 3·2·2 + 4·2·4 + 4·2·4 + 8 = 84
    ms, _ = roofline.ssd_bwd_bound((1, 1, 2, 1, 1, 1), 2)
    assert ms == pytest.approx(max(84 / roofline.HBM_BYTES_PER_S, 38 / roofline.B6_OPS_PER_S) * 1e3)
    cfg = {"family": "ssm", "n_layers": 1, "d_model": 2, "d_inner": 4, "ssm_headdim": 2, "ssm_state": 1,
           "ssm_groups": 1, "ssm_chunk": 2, "vocab": 3}
    # projections 2·(2·(8 + 2 + 2) + 4·2) = 64 a token; SSD one chunk of Q = 2 over 2 heads,
    # 2·(6·1 + 6·2 + 4·2·1·2) = 68; head 2·2·3 = 12 a token
    assert roofline.forward_flops(cfg, 1, 2) == 64 * 2 + 68 + 12 * 2
    assert roofline.train_step_flops(cfg, 1, 2) == 3 * (64 * 2 + 68 + 24)


def test_the_cells_step_flops_stay_as_counted():
    cfg = harness.load_json(ROOT / "bench" / "configs" / "mamba2-370m.json")["arch"]
    assert roofline.train_step_flops(cfg, 64, 512) == 80_968_723_464_192


def test_a_familys_flops_come_from_its_reference_module(monkeypatch):
    stub = types.ModuleType("bench.reference.stub_family")
    stub.forward_flops = lambda cfg, batch, seq: cfg["width"] * batch * seq
    monkeypatch.setitem(sys.modules, "bench.reference.stub_family", stub)
    assert roofline.train_step_flops({"family": "stub_family", "width": 5}, 2, 3) == 3 * 5 * 2 * 3
    monkeypatch.setitem(sys.modules, "bench.reference.no_count", types.ModuleType("bench.reference.no_count"))
    with pytest.raises(ValueError, match=r"bench/reference/no_count\.py has no forward_flops"):
        roofline.forward_flops({"family": "no_count"}, 2, 3)


def test_kmer_formatter_matches_known_strings():
    code = {c: i for i, c in enumerate("ACGTN")}

    def ids(s, k):
        return kmers.kmer_ids(np.array([code[c] for c in s], np.uint8), k).tolist()

    assert ids("ACGT", 2) == [1, 11]
    assert ids("AAACTTTTG", 4) == [1, 255]  # the last base is no whole group
    assert ids("ACNT", 2) == [1, 18]  # a group with an N inside the read: 4**2 + 2
    assert kmers.expand(np.array([1, 11, 18]), 2).tolist() == [0, 1, 2, 3, 255, 255]
    with pytest.raises(ValueError):
        kmers.expand(np.array([16]), 2)  # the pad id is no k-mer


def test_parse_stream_rebuilds_blocks_and_finds_an_altered_token():
    rng = np.random.default_rng(3)
    reads = [rng.integers(0, 4, int(n)).astype(np.uint8) for n in rng.integers(60, 90, 40)]
    reads[7][10] = 4  # an N dropout
    k = 7
    blocks, order = [], rng.permutation(len(reads))
    for b in range(0, len(order), 5):  # blocks of 5 reads, each cut to whole groups
        row = np.concatenate([reads[i] for i in order[b:b + 5]])
        blocks.append(row[: (row.size // k) * k])
    tokens = np.concatenate([kmers.kmer_ids(r, k) for r in blocks])
    index = kmers.ReadIndex(reads, k)
    got = kmers.parse_stream(tokens, index)
    assert got["bad_at"] is None and [i for i, _n in got["taken"]] == order.tolist()
    bases = np.concatenate([reads[i][:n] for i, n in got["taken"]])
    assert np.array_equal(kmers.kmer_ids(bases, k), tokens)
    bad = tokens.copy()
    bad[30] = (bad[30] + 1) % 4**k
    assert kmers.parse_stream(bad, index)["bad_at"] is not None
