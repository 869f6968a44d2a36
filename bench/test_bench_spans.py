"""The program's spans as the benchmark reads them, on the CPU: a traced
tiny run logs them and counts none as a device operation; a window
without them reads as before; backward work goes to the span of its
forward op, through a remat's recompute; a kernel the profiler lists
under two host events counts once, and a window whose kernels would count
twice gives None; the readers compute from the spans once a window has
seen the device, and give None on the CPU."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness, program_spans  # noqa: E402
from bench.drivers import train  # noqa: E402
from bench.test_bench_train import TINY  # noqa: E402
from bench.trace import Window  # noqa: E402

NEW = ("conv_ms.train", "ssd_glue_ms.train", "gate_norm_ms.train")


def read(name: str, rec):
    return harness.reader(harness.reader_file(name))(rec)


def tiny_traced(tmp_path):
    ctx = harness.Run("mamba2-train", 13, 0.2, True, "cpu", time.perf_counter(), overrides=TINY, tmp=tmp_path)
    return train.run(ctx)["rec"]


def test_a_traced_cpu_run_logs_its_spans_and_none_is_a_device_operation(tmp_path, capsys):
    rec = tiny_traced(tmp_path)
    assert all(read(m, rec) is None for m in NEW)  # the CPU: no device
    (line,) = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith('{"bench": "spans"')]
    by = line["by_name"]
    assert {"rt.train.step", "rt.train.nan_gate", "rt.ssm.conv",
            "rt.ssm.gate_norm", "rt.lm.block"} <= set(by)
    assert by["rt.train.step"]["count"] == rec.steps and all(k.startswith("rt.") for k in by)
    assert by["rt.lm.block"]["count"] == 2 * rec.steps * TINY["arch"]["n_layers"]  # forward and recompute
    assert not [n for n, _a, _b in rec.window.kernels if n.startswith("rt.")]
    assert all(r["host_ms"] >= r["self_ms"] >= -1e-6 for r in by.values())


def test_a_window_without_program_spans_reads_as_before():
    x = torch.randn(64, 64)
    with Window("cpu", ("train_step",)) as win:
        with torch.profiler.record_function("train_step"):
            (x @ x).sum()
    before = (win.busy_s, win.window_s, list(win.kernels), win.top_ops(), win.idle_gaps())
    rec = SimpleNamespace(window=win, steps=1)
    assert program_spans.of(rec) is None and all(read(m, rec) is None for m in NEW)
    assert (win.busy_s, win.window_s, list(win.kernels), win.top_ops(), win.idle_gaps()) == before


def test_backward_nodes_go_to_the_span_of_their_forward_op():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ArchConfig
    from repro_torch.training.steps import TrainOptions, init_train_state, make_train_step

    cfg = ArchConfig(name="tiny-mamba2", family="ssm", n_layers=2, d_model=32, n_heads=0, n_kv_heads=0, d_ff=0,
                     vocab=256, d_inner=64, ssm_headdim=16, ssm_state=16, ssm_chunk=16)
    model, opt = init_train_state(torch.Generator().manual_seed(0), cfg, TrainOptions(), device="cpu")
    step = make_train_step(cfg, TrainOptions())
    tok = torch.randint(0, 256, (2, 32), generator=torch.Generator().manual_seed(1))
    step(model, opt, {"tokens": tok, "labels": tok})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(model, opt, {"tokens": tok, "labels": tok})
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU and not e.is_async]
    put = program_spans.attribution(cpu)

    def in_backward(e):
        while e is not None and not e.name.startswith(program_spans.BACKWARD):
            e = e.cpu_parent
        return e is not None

    forward = {}  # the first forward's ops (not a recompute's, which runs inside the backward)
    for e in cpu:
        if e.sequence_nr >= 0 and not in_backward(e):
            forward.setdefault((e.sequence_nr, e.thread), put(e)[0])
    nodes = [e for e in cpu if e.name.startswith(program_spans.BACKWARD)]
    got = {}
    for node in nodes:
        name, where = put(node)
        got.setdefault(name, []).append(where)
        assert name == forward.get((node.sequence_nr, node.fwd_thread)), where
    assert {w for w in got.pop(None)} == {"torch::autograd::AccumulateGrad"}  # no forward op: a leaf
    conv = [k for k, v in forward.items() if v == "rt.ssm.conv"]
    assert len(got["rt.ssm.conv"]) > 10 and len(got["rt.ssm.conv"]) <= len(conv)
    assert got["rt.ssm.b6"] == ["SsdIntraBackward"] * 2  # B6's backward, one a layer
    # the recompute's ops keep their re-entered spans
    recompute = [e for e in cpu if in_backward(e) and e.name == "rt.ssm.conv"]
    assert len(recompute) == 2 and all(put(c)[0] == "rt.ssm.conv" for e in recompute for c in e.cpu_children)


def test_the_readers_compute_once_the_window_saw_the_device(tmp_path):
    rec = tiny_traced(tmp_path)
    win = rec.window
    seen = SimpleNamespace(_prof=win._prof, busy_s=1.0, kernels=win.kernels, _spans=win._spans, _merged=win._merged)
    card = SimpleNamespace(window=seen, steps=rec.steps)
    for m in NEW:
        assert read(m, card) == 0.0  # the CPU's ops launch no kernel


@pytest.mark.parametrize("name, parent, own", [
    ("aten::mul", "rt.ssm.conv", True),
    ("rt.ssm.b6", "rt.lm.block", True),
    ("SsdIntra", None, True),
    ("cudaLaunchKernel", "aten::mul", False),
    ("cudaMemcpyAsync", "aten::copy_", False),
    ("Command Buffer Full", "cudaLaunchKernel", False),  # the host waited on a full launch queue
    ("Activity Buffer Request", None, False),
    ("Some Other CUPTI Event", "cuLaunchKernel", False),
])
def test_kernels_are_counted_under_the_ops_that_launch_them(name, parent, own):
    up = None if parent is None else SimpleNamespace(name=parent, cpu_parent=None)
    assert program_spans.launches(SimpleNamespace(name=name, cpu_parent=up)) is own


def fake(name, eid, parent=None, kernels=(), t=(0.0, 1.0)):
    """A host event of the profiler's, as ``program_spans.walk`` reads it."""
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, id=eid, cpu_parent=parent, device_type=DeviceType.CPU, is_async=False,
                           time_range=SimpleNamespace(start=t[0], end=t[1]), sequence_nr=-1, thread=1,
                           fwd_thread=1, kernels=[SimpleNamespace(name=k, duration=us) for k, us in kernels])


def conv_op(op_id: int, us: float, cupti_first: bool):
    """``rt.ssm.conv`` > ``aten::mul`` > ``cudaLaunchKernel`` > ``Command
    Buffer Full``, the profiler listing the op's kernel under the op and
    again under the CUPTI event that shares its correlation id."""
    span = fake("rt.ssm.conv", 100 + op_id)
    op = fake("aten::mul", op_id, span, [("elementwise_kernel", us)])
    launch = fake("cudaLaunchKernel", 200 + op_id, op)
    full = fake("Command Buffer Full", op_id, launch, [("elementwise_kernel", us)])
    return [span, full, launch, op] if cupti_first else [span, op, launch, full]


@pytest.mark.parametrize("cupti_first", [False, True])
def test_a_kernel_listed_under_two_host_events_counts_once(cupti_first):
    got = program_spans.walk(conv_op(1, 10.0, cupti_first))
    assert got["spans"]["rt.ssm.conv"]["device_us"] == 10.0 and got["unspanned"] == {}


@pytest.mark.parametrize("window_us, conv_ms", [(20.0, 0.02), (25.0, 0.02), (15.0, None)])
def test_kernels_put_down_beyond_the_windows_give_none(window_us, conv_ms, capsys):
    events = conv_op(1, 10.0, False) + conv_op(2, 10.0, True)
    win = SimpleNamespace(_prof=SimpleNamespace(events=lambda: events), kernels=[("k", 0.0, window_us)],
                          busy_s=window_us / 1e6, _spans=[], _merged=[])
    rec = SimpleNamespace(window=win, steps=1)
    assert read("conv_ms.train", rec) == conv_ms
    (line,) = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith('{"bench": "spans"')]
    assert line["counted_twice"] is (conv_ms is None)
