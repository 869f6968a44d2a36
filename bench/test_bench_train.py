"""The ``train`` driver at a tiny size on the CPU: a run gives the result's
keys and comes out correct; with the timed path broken underneath (a step
that returns its state unchanged, half the batch left out, a token altered
where the pipeline makes it) and with the control (the plain reference with
fp8 products in the system's place) it comes out not correct.

The limits are the tiny size's own, set as the cell's are, on seed 13: the
system reads 4.2e-3 (first moment) and 3.1e-3 (change); the control 6.6e-2
(first moment), half the batch 0.51 (first moment), a state left unchanged
1 (both).

The reference's loop and the change of the system's parameters are also
held, bit for bit, against the loop as it was when it kept the weights and
a second gradient set on the device (``reference_train_kept``, frozen here).
"""

from __future__ import annotations

import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness, weights  # noqa: E402
from bench.drivers import train  # noqa: E402
from bench.reference import base  # noqa: E402

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
    ref = train.reference_train(cfg, ctx.traffic, ctx.seed, "cpu", rebuilt[:3], "f32", 2)
    low = train.reference_train(cfg, ctx.traffic, ctx.seed, "cpu", rebuilt[:3], "fp8", 2)
    readings = {k: v for k, v in train.readings(low, ref).items() if not k.startswith("_")}
    correct, checks = harness.judge({"tokens_wrong": 0.0, **readings}, TINY["limits"])
    assert not correct, checks


def reference_train_kept(cfg, tr, w, batches, precision, rows):
    """The reference's loop as it was: the weights ``w`` kept beside the
    parameters, and each block's gradient tuple summed into a second set."""
    fwd = train.reference_module(cfg).forward
    mm = base.matmul(precision)
    dev = next(iter(w.values())).device
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    v_ = {k: torch.zeros_like(v) for k, v in w.items()}
    losses, m1 = [], None
    with base.exact_f32():
        for s, b in enumerate(batches, start=1):
            tok, lab = (torch.as_tensor(b[k], device=dev) for k in ("tokens", "labels"))
            B = tok.shape[0]
            grads = {k: torch.zeros_like(v) for k, v in w.items()}
            total = 0.0
            for r0 in range(0, B, rows):
                part = slice(r0, min(r0 + rows, B))
                loss = base.xent(fwd(params, cfg, tok[part], mm), lab[part]) * ((part.stop - r0) / B)
                gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
                for (k, _p), g in zip(params.items(), gs):
                    if g is not None:
                        grads[k] += g
                total += float(loss.detach())
                del loss, gs
            base.adamw_step(tr["adamw"], params, grads, m, v_, s)
            losses.append(total)
            if s == 1:
                m1 = train.leaf_norms(m)
                g1 = train.leaf_norms(grads)
    change = {k: float(torch.linalg.vector_norm((params[k].detach() - w[k]).double())) for k in w}
    return {"losses": losses, "m1": m1, "g1": g1, "change": change}


@pytest.mark.parametrize("precision", ["f32", "fp8"])
def test_the_reference_loop_reads_as_it_did_with_the_weights_kept(tmp_path, precision):
    ctx = harness.Run("mamba2-train", 13, 0, False, "cpu", time.perf_counter(), overrides=TINY, tmp=tmp_path)
    cfg, tr = ctx.cfg["arch"], ctx.traffic
    rng = np.random.default_rng(5)
    # 5 rows in blocks of 2: three blocks a step, the last of one row
    batches = [{"tokens": rng.integers(0, cfg["vocab"], (5, 32)), "labels": rng.integers(0, cfg["vocab"], (5, 32))}
               for _ in range(3)]
    got = train.reference_train(cfg, tr, ctx.seed, "cpu", batches, precision, 2)
    kept = reference_train_kept(cfg, tr, train.draw_weights(cfg, ctx.seed, "cpu"), batches, precision, 2)
    assert got == kept


def test_the_systems_change_reads_as_it_did_with_the_weights_kept(tmp_path):
    ctx = harness.Run("mamba2-train", 13, 0, False, "cpu", time.perf_counter(), overrides=TINY, tmp=tmp_path)
    cell = train.Cell(ctx)
    cell.close()
    cfg = ctx.cfg["arch"]
    w = weights.make(train.reference_module(cfg).param_spec(cfg), ctx.seed, "cpu")
    kept = {k: float(torch.linalg.vector_norm((p.detach() - w[k]).double())) for k, p in cell.model.named_parameters()}
    assert cell.change == kept and max(kept.values()) > 0


def test_a_configuration_without_ssm_layers_has_no_b6_shape(monkeypatch):
    stub = types.ModuleType("bench.reference.stub_family")
    stub.forward_flops = lambda cfg, batch, seq: 7 * batch * seq
    monkeypatch.setitem(sys.modules, "bench.reference.stub_family", stub)
    tr = {"batch": 4, "seq": 16}
    rec = train.window_record({"family": "stub_family", "ssm_state": 0}, tr, None, 0.0)
    assert rec.ssd_shape is None and rec.step_flops == 3 * 7 * 4 * 16
    rec = train.window_record({**harness.load_json(ROOT / "bench/configs/mamba2-370m.json")["arch"]}, tr, None, 0.0)
    assert rec.ssd_shape == (4, 1, 16, 32, 64, 128)
