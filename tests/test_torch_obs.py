"""The port's observability (``repro_torch.obs``) on the CPU: one counter
registry shared with the kernel wrappers, spans that cost nothing while no
profiler runs, and, under the profiler, spans that are host-side ranges
nested along the training path, re-entered by a remat's recompute."""

import tracemalloc

import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.core import decode_torch
from repro_torch.kernels import cuda_lib, reformat
from repro_torch.training.steps import TrainOptions, init_train_state, make_train_step

SPANS = {"rt.train.step", "rt.train.grads", "rt.train.nan_gate", "rt.train.adamw", "rt.train.xent",
         "rt.adamw.norm", "rt.adamw.chunk", "rt.lm.embed", "rt.lm.block", "rt.lm.head",
         "rt.ssm.in_proj", "rt.ssm.conv", "rt.ssm.ssd_prep", "rt.ssm.b6", "rt.ssm.ssd_state",
         "rt.ssm.gate_norm", "rt.ssm.out_proj"}
#: what the benchmark's kernel-name readers match: no span name may hold one
READ_BY_NAME = ("ssd_intra_prefill_kernel", "ssd_bwd_kernel", "multi_tensor_apply_kernel", "lpnorm_cleanup")


def tiny_step():
    cfg = ArchConfig(name="tiny-mamba2", family="ssm", n_layers=2, d_model=32, n_heads=0, n_kv_heads=0, d_ff=0,
                     vocab=256, d_inner=64, ssm_headdim=16, ssm_state=16, ssm_chunk=16)
    model, opt = init_train_state(torch.Generator().manual_seed(0), cfg, TrainOptions(), device="cpu")
    tok = torch.randint(0, 256, (2, 32), generator=torch.Generator().manual_seed(1))
    return cfg, make_train_step(cfg, TrainOptions()), model, opt, {"tokens": tok, "labels": tok}


def in_backward(e):
    while e is not None and not e.name.startswith("autograd::engine::evaluate_function"):
        e = e.cpu_parent
    return e is not None


def rt_parent(e):
    e = e.cpu_parent
    while e is not None and not e.name.startswith("rt."):
        e = e.cpu_parent
    return e


def test_cuda_lib_counts_are_the_one_registry():
    assert cuda_lib.COUNTS is obs.COUNTS
    obs.reset_counts()
    reformat.kmer_pack(torch.zeros((1, 8), dtype=torch.int8), 4)
    assert cuda_lib.counts() == obs.counts() == decode_torch.trace_counts() == {"plain:kmer_pack": 1}
    decode_torch.reset_trace_counts()
    assert obs.counts() == {}


def test_a_span_without_a_profiler_is_a_shared_null_context_and_allocates_nothing(monkeypatch):
    def boom(name):
        raise AssertionError("a span opened a profiler range with no profiler running")

    monkeypatch.setattr(obs, "_RecordFunctionFast", boom)
    before = obs.counts()
    assert obs.span("rt.ssm.conv") is obs.span("rt.lm.block") is obs._NULL
    for _ in range(10):  # warm the call path before measuring
        with obs.span("rt.lm.block"):
            pass
    tracemalloc.start()
    try:
        snap0 = tracemalloc.take_snapshot()
        for _ in range(2000):
            with obs.span("rt.lm.block"):
                pass
        snap1 = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = [tracemalloc.Filter(True, obs.__file__)]
    grown = snap1.filter_traces(mine).compare_to(snap0.filter_traces(mine), "filename")
    assert sum(d.size_diff for d in grown) <= 0
    assert obs.counts() == before


def test_a_span_is_a_host_range_of_the_private_function_scope_record():
    # torch's private symbol the spans stand on: a release that moves it fails here
    from torch._C._profiler import RecordScope, _RecordFunctionFast

    assert obs._RecordFunctionFast is _RecordFunctionFast
    assert autograd_profiler._is_profiler_enabled is False
    x = torch.randn(16, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert autograd_profiler._is_profiler_enabled is True
        with obs.span("rt.ssm.conv"):
            (x @ x).sum()
        with record_function("user_range"):
            (x @ x).sum()
    assert autograd_profiler._is_profiler_enabled is False
    (mine,) = [e for e in prof.events() if e.name == "rt.ssm.conv"]
    (user,) = [e for e in prof.events() if e.name == "user_range"]
    # a FUNCTION-scope record sits on the host's timeline only; a user scope is drawn on the device's too
    assert mine.device_type == DeviceType.CPU and mine.scope == int(RecordScope.FUNCTION)
    assert user.scope == int(RecordScope.USER_SCOPE) != mine.scope
    assert any(c.name == "aten::matmul" for c in mine.cpu_children)


def test_a_profiled_train_step_opens_every_span_along_the_path():
    cfg, step, model, opt, batch = tiny_step()
    model, opt, _m = step(model, opt, batch)  # no profiler: no span
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(model, opt, batch)
    rt = [e for e in prof.events() if e.name.startswith("rt.")]
    assert {e.name for e in rt} == SPANS
    assert all(e.device_type == DeviceType.CPU for e in rt)
    by = {n: [e for e in rt if e.name == n] for n in SPANS}
    assert len(by["rt.train.step"]) == 1 and len(by["rt.adamw.norm"]) == 1
    # remat: each layer's block in the forward, and again in the recompute inside the backward
    assert len(by["rt.lm.block"]) == 2 * cfg.n_layers
    assert all(len(by[f"rt.ssm.{n}"]) == 2 * cfg.n_layers for n in ("in_proj", "conv", "b6", "gate_norm", "out_proj"))
    parents = {"rt.train.grads": "rt.train.step", "rt.train.nan_gate": "rt.train.step",
               "rt.train.adamw": "rt.train.step", "rt.adamw.norm": "rt.train.adamw",
               "rt.adamw.chunk": "rt.train.adamw", "rt.lm.embed": "rt.train.grads",
               "rt.ssm.conv": "rt.lm.block", "rt.ssm.b6": "rt.lm.block", "rt.ssm.gate_norm": "rt.lm.block"}
    for child, parent in parents.items():
        assert all(rt_parent(e).name == parent for e in by[child]), child
    assert sum(map(in_backward, by["rt.lm.block"])) == cfg.n_layers  # the recompute, inside backward nodes


@pytest.mark.parametrize("substring", READ_BY_NAME)
def test_no_span_name_holds_what_a_kernel_name_reader_matches(substring):
    assert not [n for n in SPANS if substring in n]
