"""The ``train`` driver at a tiny size on the CPU: a run gives the result's
keys and comes out correct; with the timed path broken underneath (a step
that returns its state unchanged, half the batch left out, a token altered
where the pipeline makes it) and with the control (the plain reference with
fp8 products in the system's place) it comes out not correct.

The limits are the tiny size's own, set as the cell's are, on seed 13: the
system reads 4.2e-3 (first moment) and 3.1e-3 (change); the control 6.6e-2
(first moment), half the batch 0.51 (first moment), a state left unchanged
1 (both)."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness, weights  # noqa: E402
from bench.drivers import train  # noqa: E402

TINY = {"arch": {"n_layers": 1, "d_model": 32, "d_inner": 64, "ssm_headdim": 16, "ssm_state": 16, "ssm_chunk": 16,
                 "vocab": 1024},
        "batch": 2, "seq": 32, "trace_steps": 2, "reference_rows": 2,
        "container": {"profile": "illumina", "ref_len": 20000, "n_reads": 100, "read_len": 150, "token_target": 2048},
        "limits": {"tokens_wrong": 0, "grad_gap": 0.02, "change_gap": 0.3}}


def run_tiny(tmp_path, faults=()):
    from bench import run

    return run.execute("mamba2-train", 13, 0.2, False, "cpu", time.perf_counter(), overrides=TINY,
                       tmp=tmp_path, faults=faults)


def test_a_tiny_run_gives_the_result_keys_and_is_correct(tmp_path):
    r = run_tiny(tmp_path)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(r["metrics"]) == {"train_tokens_per_s", "setup_s"} and r["metrics"]["setup_s"]["unit"] == "s"
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


def test_a_traced_tiny_run_reads_its_host_spans(tmp_path):
    from bench import run

    r = run.execute("mamba2-train", 13, 0.2, True, "cpu", time.perf_counter(), overrides=TINY, tmp=tmp_path)
    assert r["correct"], r["checks"]
    # on the CPU the profiler sees no device operation: the device readers find nothing to read
    assert set(r["metrics"]) == {"data_wait_ms.train"} and r["metrics"]["data_wait_ms.train"]["value"] > 0
    assert r["device"]["busy_s"] == 0 and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_gap_leaves_out_leaves_nought_to_rounding():
    grad_ref = {"a": 1.0, "b": 2.0, "c": 1e-6}
    ref = {"a": 1.0, "b": 4.0, "c": 1.0}
    worst, leaf = train.gap({"a": 1.5, "b": 4.0, "c": 9.0}, ref, grad_ref)
    # c's gradient is under a thousandth of the median leaf's: out, whatever it reads;
    # a is held against the median of the others' norms, 2.5, not its own 1.0
    assert leaf == "a" and worst == pytest.approx(0.5 / 2.5)


@pytest.mark.parametrize("fault", ["frozen_step", "half_batch", "batch_token"])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault):
    r = run_tiny(tmp_path, faults=(fault,))
    assert not r["correct"], r["checks"]


def test_the_fp8_control_is_not_correct(tmp_path):
    ctx = harness.Run("mamba2-train", 13, 0, False, "cpu", time.perf_counter(), overrides=TINY, tmp=tmp_path)
    cell = train.Cell(ctx)
    batches, rs, k = cell.batches, cell.rs, cell.pipe.k
    cell.close()
    _wrong, rebuilt = train.token_check(batches, rs, k)
    cfg = ctx.cfg["arch"]
    w = weights.make(train.reference_module(cfg).param_spec(cfg), ctx.seed, "cpu")
    ref = train.reference_train(cfg, ctx.traffic, w, rebuilt[:3], "f32", 2)
    low = train.reference_train(cfg, ctx.traffic, w, rebuilt[:3], "fp8", 2)
    readings = {k: v for k, v in train.readings(low, ref).items() if not k.startswith("_")}
    correct, checks = harness.judge({"tokens_wrong": 0.0, **readings}, TINY["limits"])
    assert not correct, checks
