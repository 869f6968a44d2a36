"""The port's dry run (``repro_torch.launch.dryrun``, ``specs``, ``op_cost``)
against the JAX package's, on the CPU.

XLA's cost numbers and the port's are different measures (a compiled
module's post-fusion HLO against one rank's eager aten ops), so only what
both compute alike is held against ``repro``: the parameter counts, the
model FLOPs, the artifact's keys and the skip contract. The fake process
group never starts in a pytest worker: the dry run and the collective
counts run in subprocesses, as tests/test_dryrun_launch.py runs
``repro``'s."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch.dryrun import model_flops
from repro_torch.launch.op_cost import count

ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def _dryrun(tmp_path, arch: str, shape: str, timeout: int):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, "--mesh", "single",
         "--out", str(tmp_path)],
        capture_output=True, text=True, env=ENV, cwd=ROOT, timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return json.loads((tmp_path / f"{arch}_{shape}_pod1.json").read_text())


def test_dryrun_cell_produces_roofline_artifact(tmp_path):
    """qwen2-1.5b x train_4k on one pod (256 fake ranks, (data 16, model
    16)): repro's artifact contract, with the H100's 80 GB where repro
    asserts a v5e's 16 GB, and model_flops_total equal to repro's."""
    art = _dryrun(tmp_path, "qwen2-1.5b", "train_4k", timeout=900)
    assert art["status"] == "ok"
    assert art["chips"] == 256
    for k in ("t_compute", "t_memory", "t_collective", "hlo_flops_dev", "hlo_bytes_dev", "collective_bytes_dev",
              "peak_hbm_gb", "roofline_frac", "model_flops_dev"):
        assert k in art and art[k] >= 0, k
    assert art["bottleneck"] in ("compute", "memory", "collective")
    # useful flops a sane share of the counted products (remat <= ~3x waste)
    assert 0.2 < art["useful_flops_frac"] <= 1.2
    assert art["peak_hbm_gb"] < 80.0  # an H100 80GB HBM3
    assert art["model_flops_total"] == model_flops(ARCHS["qwen2-1.5b"], SHAPES["train_4k"])
    assert art["seq_shard"] is True and art["options"]["microbatch"] == 4
    assert "torch dispatch" in art["cost_source"]
    assert art["collectives"]["n_all-gather"] > 0 and art["collective_bytes_dev"] > 0


def test_dryrun_skip_contract(tmp_path):
    """A full-attention arch's long_500k cell writes repro's skip record."""
    art = _dryrun(tmp_path, "yi-34b", "long_500k", timeout=300)
    assert art["status"] == "skipped"
    assert "sub-quadratic" in art["reason"]
    assert art["reason"] == "full-attention arch; 500k decode needs sub-quadratic attention (DESIGN.md §4)"


def test_model_flops_and_active_params_match_reference():
    """Every arch's active parameter count is repro's, and every cell's
    model FLOPs (6·N·D to train, 2·N·D forward) are repro's
    ``dryrun.model_flops`` (which forces 512 host devices when imported,
    so it runs in a subprocess)."""
    assert sorted(ARCHS) == sorted(JARCHS) and sorted(SHAPES) == sorted(JSHAPES)
    for a in ARCHS:
        assert ARCHS[a].n_active_params() == JARCHS[a].n_active_params(), a
    code = ("import json\nfrom repro.configs import ARCHS, SHAPES\nfrom repro.launch.dryrun import model_flops\n"
            "print(json.dumps({f'{a}/{s}': model_flops(ARCHS[a], SHAPES[s]) for a in ARCHS for s in SHAPES}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(ENV, JAX_PLATFORMS="cpu"), cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    theirs = json.loads(out.stdout.strip().splitlines()[-1])
    ours = {f"{a}/{s}": model_flops(ARCHS[a], SHAPES[s]) for a in ARCHS for s in SHAPES}
    assert ours == theirs


# ------------------------------------------------------------------ op_cost
def test_matmul_flops_are_two_m_n_k():
    """A (256, 512) x (512, 128) f32 product: 2·M·N·K FLOPs (flop_counter's
    formula), and its operands and result read and written once."""
    with FakeTensorMode():
        a, b = torch.randn(256, 512), torch.randn(512, 128)
        cost = count(lambda: a @ b)
    assert cost.flops == 2 * 256 * 512 * 128
    assert cost.bytes == 4 * (256 * 512 + 512 * 128 + 256 * 128)
    assert cost.collective_bytes == 0


def test_python_loop_counts_each_layer():
    """An L-layer Python loop (L = 7 products of (32, 128) x (128, 128) and
    a tanh) counts L times one layer: torch has no scan to scale."""
    L, D = 7, 128
    with FakeTensorMode():
        x, ws = torch.randn(32, D), torch.randn(L, D, D)

        def layers(n):
            h = x
            for i in range(n):
                h = torch.tanh(h @ ws[i])
            return h

        one, all_ = count(layers, 1), count(layers, L)
    assert one.flops == 2 * 32 * D * D
    assert all_.flops == L * one.flops and all_.bytes == L * one.bytes


def test_bytes_reasonable_on_elementwise():
    """``a * 2 + 1`` on a (1024, 1024) f32 tensor moves between one and four
    times its bytes (two unfused ops, each reading and writing it)."""
    with FakeTensorMode():
        x = torch.randn(1024, 1024)
        cost = count(lambda: x * 2 + 1)
    nbytes = 1024 * 1024 * 4
    assert nbytes <= cost.bytes <= 4 * nbytes
    assert cost.flops == 0


COLLECTIVES = r"""
import json
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.op_cost import OpCounter, count
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("d",))
m2 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("a", "b"))
out = {}
with FakeTensorMode():
    t = torch.randn(100, 10)
    def loop(n):
        h = t
        for _ in range(n):
            h = funcol.all_reduce(h * 2, "sum", dist.group.WORLD)
        return h
    for n in (1, 5):
        c = count(loop, n)
        out[f"funcol/{n}"] = [c.collective_bytes, dict(c.coll), dict(c.coll_n)]
    def c10d():
        dist.all_reduce(t)
    c = count(c10d)
    out["c10d"] = [c.collective_bytes, dict(c.coll), dict(c.coll_n)]
    a = distribute_tensor(torch.randn(256, 512), mesh, [Shard(0)], src_data_rank=None)
    b = distribute_tensor(torch.randn(512, 128), mesh, [Replicate()], src_data_rank=None)
    c = count(lambda: (a @ b).redistribute(mesh, [Replicate()]))
    out["dtensor"] = [c.flops, dict(c.coll), dict(c.coll_n)]
    for nsize in (8, 4):
        with OpCounter(node_size=nsize) as c:
            funcol.all_reduce(t, "sum", dist.group.WORLD)
            dist.all_reduce(t)
            x = distribute_tensor(torch.randn(8, 16), m2, [Shard(0), Shard(1)], src_data_rank=None)
            x.redistribute(m2, [Replicate(), Shard(1)])
            x.redistribute(m2, [Shard(0), Replicate()])
        out[f"node/{nsize}"] = [c.cost.collective_bytes, c.cost.coll_internode]
dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def collectives():
    out = subprocess.run([sys.executable, "-c", COLLECTIVES], capture_output=True, text=True, env=ENV, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_collectives_counted_once_and_per_layer(collectives):
    """On a fake 8-rank group: an all-reduce of a (100, 10) f32 tensor counts
    its 4000 result bytes once, and 5 times inside a 5-layer loop, both as
    a functional collective and as ``dist.all_reduce``. A DTensor product
    counts the rank's FLOPs (its 32 of 256 rows, not the global 2·M·N·K)
    and the all-gather of its result."""
    res = collectives
    assert res["funcol/1"] == [4000.0, {"all-reduce": 4000.0}, {"all-reduce": 1.0}]
    assert res["funcol/5"] == [20000.0, {"all-reduce": 20000.0}, {"all-reduce": 5.0}]
    assert res["c10d"] == [4000.0, {"all-reduce": 4000.0}, {"all-reduce": 1.0}]
    flops, coll, coll_n = res["dtensor"]
    assert flops == 2 * 32 * 512 * 128
    assert coll == {"all-gather": 256 * 128 * 4} and coll_n == {"all-gather": 1.0}


def test_collectives_spanning_nodes_counted_apart(collectives):
    """``coll_internode`` holds the bytes of the collectives whose group
    spans more than one node of ``node_size`` consecutive ranks. Rank 0 of
    a fake 8-rank group runs two all-reduces of 4000 bytes over the whole
    group (functional and ``dist.all_reduce``) and, on a (2, 4) mesh, an
    (8, 16) f32 DTensor's all-gather over the 2-rank axis (ranks 0 and 4;
    128 result bytes) and over the 4-rank axis (ranks 0-3; 256 bytes). With
    nodes of 8 nothing spans nodes; with nodes of 4 all but the 4-rank
    axis's all-gather does."""
    assert collectives["node/8"] == [8384.0, 0.0]
    assert collectives["node/4"] == [8384.0, 8128.0]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_batch_shapes_match_reference(kind):
    """The inputs of every arch's cell of each kind have repro's shapes and
    dtypes (specs.batch_shapes)."""
    from repro.launch.specs import batch_shapes as ref_batch_shapes

    from repro_torch.launch.specs import batch_shapes

    cell = next(c for c in SHAPES.values() if c.kind == kind)
    for a in ARCHS:
        ours = batch_shapes(ARCHS[a], cell)
        theirs = ref_batch_shapes(JARCHS[a], JSHAPES[cell.name])
        assert sorted(ours) == sorted(theirs), a
        for k, (shape, dt) in ours.items():
            assert tuple(theirs[k].shape) == shape, (a, k)
            assert str(theirs[k].dtype) == str(dt).replace("torch.", ""), (a, k)
