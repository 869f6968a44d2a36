"""The port's multi-rank runtime against the JAX package, on the CPU.

One module fixture writes the inputs (numpy draws from seeds, and the JAX
package's initial states), then starts at once:
  * 4 gloo CPU ranks (``tests/dist_cases.py``, a ``FileStore`` in the
    fixture's directory), which run every multi-rank case once and save
    their results;
  * one JAX-package process (``tests/dist_reference.py``) with
    ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (the recipe of
    tests/test_distributed.py), which runs ``repro``'s DP step on 2 and 4
    forced host devices;
and meanwhile runs the one-rank DP cases of both packages in this process.
The tests compare the results with ``repro`` computed here, each at the
bound it states."""

import dataclasses
import functools
import itertools
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.distributed.sharding import Rules as RefRules
from repro.distributed.sharding import param_spec as ref_param_spec
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro.models import lm as JLM
from repro.models import moe as JM
from repro.training import optimizer as JO
from repro.training import steps as JS

from repro_torch.distributed.dp_step import pack_int16, unpack_int16
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.training.steps import _stacked

import dist_cases as DC
import dist_reference as DR
from train_cases import compare_step

ROOT = Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"
WORLD = 4
TIMEOUT = 400  # seconds for the ranks and the reference process


def flat(tree, prefix: str) -> dict:
    return DR.flat(tree, prefix)


def make_inputs() -> dict:
    out = {}
    r = np.random.default_rng(0)
    out["pp/ws"] = (r.standard_normal((8, 16, 16)) * 0.3).astype(np.float32)  # L 8, D 16
    out["pp/x"] = r.standard_normal((6, 16)).astype(np.float32)  # B 6
    jcfg = JARCHS[DC.MOE_ARCH].reduced()
    out.update(flat(jax.jit(lambda k: JM.moe_init(k, jcfg))(jax.random.PRNGKey(0)), "moe/p/"))
    out["moe/x"] = r.standard_normal((4, 16, jcfg.d_model)).astype(np.float32)
    for arch in DC.DP_ARCHS:
        jo = JS.TrainOptions(chunk=32, adamw=JO.AdamWConfig(**DC.ADAMW), grad_compress="int16_ef")
        jcfg = dataclasses.replace(JARCHS[arch].reduced(), n_layers=DC.DP_LAYERS)
        params, opt = jax.jit(lambda k, jcfg=jcfg, jo=jo: JS.init_train_state(k, jcfg, jo))(jax.random.PRNGKey(0))
        out.update(flat({"params": params, "opt": opt}, f"dp/{arch}/"))
    vocab = min(JARCHS[a].reduced().vocab for a in DC.DP_ARCHS)
    rb = np.random.default_rng(7)
    for i in range(DC.DP_STEPS):
        t = rb.integers(0, vocab, (4, 33)).astype(np.int32)
        out[f"dp_batch/{i}/tokens"], out[f"dp_batch/{i}/labels"] = t[:, :-1], t[:, 1:]
    rt = np.random.default_rng(11)
    vocab = min(JARCHS[a].reduced().vocab for a, _ in DC.TP_CASES)
    for i in range(DC.TP_STEPS):
        t = rt.integers(0, vocab, (DC.TP_BATCH[0], DC.TP_BATCH[1] + 1)).astype(np.int32)
        out[f"tp_batch/{i}/tokens"], out[f"tp_batch/{i}/labels"] = t[:, :-1], t[:, 1:]
    return out


def one_rank(inputs: dict) -> tuple[dict, dict]:
    """Both packages' DP step with one rank: ``repro`` on a 1-device mesh
    (in threads, whose compilations overlap), the port with no process
    group (f32 forwards on both sides)."""
    ref, ours = {}, {}
    cases = [(arch, comp) for arch in DC.DP_ARCHS for comp in DC.DP_COMPRESS]
    orig = JLM.forward
    JLM.forward = functools.partial(orig, dtype=jnp.float32)
    try:
        with ThreadPoolExecutor(len(cases)) as ex:
            futs = [ex.submit(DR.dp_case, arch, comp, 1, inputs) for arch, comp in cases]
            for arch, comp in cases:
                ours.update({f"dp/{arch}/{comp}/1/{k}": v for k, v in DC.dp_run(arch, comp, None, inputs).items()})
            for f in futs:
                ref.update(f.result())
    finally:
        JLM.forward = orig
    return ref, ours


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("dist")
    inputs = make_inputs()
    np.savez(work / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(TESTS)]), OMP_NUM_THREADS="1")
    logs = {}

    def start(name, args, **extra):
        logs[name] = open(work / f"{name}.log", "w")
        return subprocess.Popen([sys.executable, *args], env=dict(env, **extra), cwd=ROOT,
                                stdout=logs[name], stderr=subprocess.STDOUT)

    procs = {"reference": start("reference", [str(TESTS / "dist_reference.py"), str(work)], JAX_PLATFORMS="cpu",
                                XLA_FLAGS="--xla_force_host_platform_device_count=8")}
    for r in range(WORLD):
        procs[f"rank{r}"] = start(f"rank{r}", [str(TESTS / "dist_cases.py"), str(work), str(r), str(WORLD)])
    try:
        ref1, ours1 = one_rank(inputs)
        for name, p in procs.items():
            rc = p.wait(timeout=TIMEOUT)
            logs[name].close()
            assert rc == 0, f"{name} exited {rc}:\n" + (work / f"{name}.log").read_text()[-4000:]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]
    ref = dict(np.load(work / "reference.npz"))
    ref.update(ref1)
    return inputs, ranks, ref, ours1


# ------------------------------------------------------------------- PP
def test_pipeline_matches_sequential(dist_run):
    """GPipe over 4 stages (8 tanh layers of 16 x 16, batch 6, 3
    microbatches): every rank's output equals repro's sequential
    application within 1e-5."""
    inputs, ranks, _ref, _o = dist_run
    h = jnp.asarray(inputs["pp/x"])
    for w in inputs["pp/ws"]:
        h = jnp.tanh(h @ jnp.asarray(w))
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["pp"], np.asarray(h), rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")


# ------------------------------------------------------------------- EP
def test_moe_expert_parallel_matches_local_path(dist_run):
    """Reduced deepseek-moe-16b on a (data 2, model 2) mesh: each rank runs
    its 4 of 8 experts on its 2 of 4 rows and an all-reduce over the model
    axis combines them. y within 2e-4 and aux within 1e-5 of repro's
    single-device moe_apply (repro's own bounds: the cross-rank sum adds in
    another order); the model axis's two ranks agree exactly."""
    inputs, ranks, _ref, _o = dist_run
    jcfg = JARCHS[DC.MOE_ARCH].reduced()
    p = jax.tree.map(jnp.asarray, DC.nest(inputs, "moe/p/"))
    y_ref, aux_ref = JM.moe_apply(p, jnp.asarray(inputs["moe/x"]), jcfg)
    y_ref = np.asarray(y_ref, np.float32)
    assert jcfg.n_experts % 2 == 0
    for r, res in enumerate(ranks):
        d = int(res["ep/data"])
        np.testing.assert_allclose(res["ep/y"], y_ref[2 * d:2 * d + 2], rtol=2e-4, atol=2e-4, err_msg=f"rank {r}")
        np.testing.assert_allclose(float(res["ep/aux"]), float(aux_ref), rtol=1e-5)
    for a, b in ((0, 1), (2, 3)):  # the model-axis pairs of the (2, 2) mesh
        np.testing.assert_array_equal(ranks[a]["ep/y"], ranks[b]["ep/y"])


# ------------------------------------------------------------------- DP
# the two packages' f32 gradients differ by up to this share of a leaf's max|g|
# (~1e-6 in most leaves; mamba2's D, whose gradient sums over every position, ~1.1e-6)
F32_GRAD_EPS = 2e-6


def dp_close(ours: dict, theirs: dict, prefix: str, ndev: int, summed_in_bf16: bool) -> None:
    """``prefix``'s two steps of both packages (f32 forwards), the loss
    within 1e-4 relative each step.

    Why the bounds: the two packages' f32 gradients differ by ~1e-6
    relative, which the quantizer (int16_ef: to ±qmax steps of
    max|x|/qmax; bf16: to 8 mantissa bits) turns into one step where x
    falls that close to a rounding boundary; that element's m, v and
    parameter move with it (tests/test_torch_train.py's
    compressed_steps_match). So grad_norm is within 1e-4 relative, and of
    each leaf of the final state (parameters, m, v) at most 0.5% of its
    elements (and at least one) lie outside 1e-4·max|leaf|, a parameter's
    bound widened by AdamW's own amplification of a gradient error τ =
    1e-4·max|ĝ| near ĝ = 0, (lr_1 + lr_2)·min(2, τ·eps/(|ĝ| + eps)²), ĝ
    taken as |m|/(1 - b1) (tests/train_cases.py; qwen2's key bias sits at
    |ĝ| ~ eps).

    ef = x - q·s, held against the port's last quantum s (``quantum/``): a
    gradient element that differs by δ <= ε·max|x| = ε·qmax·s between the
    packages (ε = ``F32_GRAD_EPS``) moves ef by δ at each of the two steps,
    so an element whose q rounded alike both times lies within the band
    2·ε·qmax·s (0.13·s at qmax 32767, 0.033·s at 8191). q flips where x
    lies within δ of a rounding boundary, with a chance δ/s <= ε·qmax a
    step; a flip moves ef by up to one quantum. So every element is within
    s (and the band), and at most max(1, 4·ε·qmax·n) of a leaf's n (twice
    the two steps' flip chance: 26% at qmax 32767, 6.6% at 8191) lie
    outside the band; in these cases at most 2.1% of a leaf of 1024 or
    more elements do, and one element of a smaller leaf. Dropping the
    error feedback or keeping the wrong residual puts ~74% or more outside
    it (|ef| spread over [0, s/2]).

    ``summed_in_bf16`` (bf16 over 2 and 4 ranks): the ranks' bf16
    gradients are summed in another order (gloo's ring rounds to bf16 at
    each add), so a summed element may differ by up to two bf16 ulps
    (2^-7 relative): grad_norm within 2^-7 relative, m within 2^-6·max|m|
    (m mixes two steps' gradients), v within 2^-5·max|v| (squares double
    the relative error), and each parameter within 1e-4·max|leaf| plus
    2·(lr_1 + lr_2) (AdamW's step is ~lr·sign(ĝ) where |ĝ| is near 0,
    which such an error can flip)."""
    lrs = []
    for i in range(DC.DP_STEPS):
        lrs.append(float(theirs[f"{prefix}metric/{i}/lr"]))
        for k, tol in (("loss", 1e-4), ("grad_norm", 2 ** -7 if summed_in_bf16 else 1e-4)):
            a, b = float(ours[f"{prefix}metric/{i}/{k}"]), float(theirs[f"{prefix}metric/{i}/{k}"])
            assert abs(a - b) <= tol * abs(b), (prefix, i, k, a, b)
    st = f"{prefix}state/"
    names = sorted(k for k in theirs if k.startswith(st))
    assert names == sorted(k for k in ours if k.startswith(st))
    assert any("opt/ef/" in k for k in names) == ("int16_ef" in prefix)
    for k in names:
        if k.endswith("opt/step"):
            assert int(ours[k]) == int(theirs[k]) == DC.DP_STEPS
            continue
        a, b = np.asarray(ours[k], np.float32), np.asarray(theirs[k], np.float32)
        top = float(np.abs(b).max())
        err = np.abs(a - b)
        if "opt/ef/" in k:
            s = np.asarray(ours[k.replace("/state/", "/quantum/", 1)], np.float32)
            qmax = max(32767 // ndev, 255)
            band = 2 * F32_GRAD_EPS * qmax * s
            assert bool(np.all(err <= s + band)), (k, float((err / s).max()))
            off = err > band
            assert off.sum() <= max(1, 4 * F32_GRAD_EPS * qmax * off.size), (k, int(off.sum()), off.size)
        elif summed_in_bf16:
            bound = {"opt/m/": 2 ** -6 * top, "opt/v/": 2 ** -5 * top}.get(
                next((t for t in ("opt/m/", "opt/v/") if t in k), ""), 1e-4 * top + 2 * sum(lrs))
            assert float(err.max()) <= bound, (k, float(err.max()), bound)
        else:
            bound = 1e-4 * top
            if "/params/" in k:
                c = JO.AdamWConfig()
                g = np.abs(np.asarray(theirs[k.replace("params/", "opt/m/", 1)], np.float32)) / (1 - c.b1)
                tau = 1e-4 * float(g.max())
                bound = bound + sum(lrs) * np.minimum(2.0, tau * c.eps / (g + c.eps) ** 2)
            off = err > bound
            assert off.sum() <= max(1, 0.005 * off.size), (k, int(off.sum()), off.size)


@pytest.mark.parametrize("ndev", (1, 2, 4))
@pytest.mark.parametrize("compress", DC.DP_COMPRESS)
@pytest.mark.parametrize("arch", DC.DP_ARCHS)
def test_dp_train_step_matches_reference(dist_run, arch, compress, ndev):
    """``make_dp_train_step`` on 1 rank (no process group), on the data axis
    of a (data 2, model 2) gloo mesh and on a (data 4) one, against repro's
    on a 1-device mesh and on 2 and 4 forced host devices (``dp_close``);
    every rank holds the same state, bit for bit; the wire carries 2 bytes
    a gradient element (the int16 sums packed four to an int64)."""
    _inputs, ranks, ref, ours1 = dist_run
    prefix = f"dp/{arch}/{compress}/{ndev}/"
    ours = ours1 if ndev == 1 else ranks[0]
    dp_close(ours, ref, prefix, ndev, summed_in_bf16=compress == "bf16" and ndev > 1)
    if ndev > 1:  # params, m, v replicated; ef is each data rank's own residual
        for r in range(1, WORLD):
            same_data = ndev == 2 and r // 2 == 0
            for k in (k for k in ranks[0] if k.startswith(prefix + "state/")):
                if "opt/ef/" not in k or same_data:
                    np.testing.assert_array_equal(ranks[r][k], ranks[0][k], err_msg=f"rank {r} {k}")
    elems, nbytes = int(ours[prefix + "wire_elements"]), int(ours[prefix + "wire_bytes"])
    assert elems > 0 and 2 * elems <= nbytes < 2 * elems + 8 * 4 * 64, (elems, nbytes)


@pytest.mark.parametrize("ndev", (2, 4, 128))
def test_packed_int16_sum_is_exact_at_two_bytes_an_element(ndev):
    """Values at ±qmax (qmax = max(32767 // ndev, 255)) packed four to an
    int64: the sum over the ranks in any order, and every partial sum
    along it, unpacks to the exact integer sums; the packed words take 2
    bytes an element (the count padded to a multiple of 4)."""
    qmax = max(32767 // ndev, 255)
    r = np.random.default_rng(ndev)
    n = 1001
    vals = r.integers(-qmax, qmax + 1, (ndev, n))
    vals[:, :4] = qmax  # the extremes: every rank at +qmax, then at -qmax
    vals[:, 4:8] = -qmax
    packed = [pack_int16(torch.from_numpy(v)) for v in vals]
    assert packed[0].dtype == torch.int64 and packed[0].numel() * 8 == 2 * (n + (-n) % 4)
    orders = itertools.permutations(range(ndev)) if ndev <= 4 else (r.permutation(ndev) for _ in range(16))
    for order in orders:
        acc = torch.zeros_like(packed[0])
        for j, i in enumerate(order):
            acc = acc + packed[i]
            want = vals[list(order[:j + 1])].sum(0)
            assert torch.equal(unpack_int16(acc, n), torch.from_numpy(want)), (order, j)


# ------------------------------------------------------------- elastic
def test_elastic_checkpoint_restore_across_meshes(dist_run):
    """An (8, 8) leaf saved Shard(0) on a 4-rank mesh restores onto a
    (2, 2) mesh with placements (Shard(1), Shard(0)): the values are equal
    and each rank holds the block those placements give it (repro's
    test_elastic_checkpoint_restore_across_meshes)."""
    _inputs, ranks, _ref, _o = dist_run
    full = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["elastic/full"], full)
        a, b = divmod(r, 2)  # coordinates on ("a", "b")
        np.testing.assert_array_equal(res["elastic/local"], full[4 * b:4 * b + 4, 4 * a:4 * a + 4])
        assert str(res["elastic/placements"]) == "(Shard(dim=1), Shard(dim=0))"
        assert str(res["elastic/mesh"]) == "('a', 'b')" and int(res["elastic/step"]) == 1


# -------------------------------------------------- rules and parameters
def expected_placements(part, names=("data", "model")) -> str:
    out = ["Replicate()"] * len(names)
    for i, ax in enumerate(part):
        for a in ax if isinstance(ax, (list, tuple)) else (ax,):
            if a in names:
                out[names.index(a)] = f"Shard(dim={i})"
    return "(" + ", ".join(out) + ")"


def as_list(spec) -> list:
    """A partition's entries, an axis tuple of one as its axis (JAX's
    PartitionSpec normalizes ("data",) to "data")."""
    return [(a[0] if len(a) == 1 else list(a)) if isinstance(a, (list, tuple)) else a for a in spec]


def test_rules_spec_is_the_reference_table(dist_run):
    """Every logical name's partition equals repro's PartitionSpec for the
    same rules, and its placements shard each tensor dim over the mesh
    dims the partition names."""
    rules = json.loads(str(dist_run[1][0]["rules"]))["rules"]
    mesh = ref_make_mesh((1, 1), ("data", "model"))
    assert len(rules) == len(DC.RULE_CASES)
    for key, table in rules.items():
        data_axes, seq, pure = json.loads(key)
        ref = RefRules(mesh, data_axes=tuple(data_axes), seq_shard=seq, pure_dp=pure)
        for name, (part, places) in table.items():
            assert as_list(part) == as_list(ref.spec(name)), (key, name)
            assert places == expected_placements(part), (key, name, places)


def test_shard_act_redistributes_a_dtensor_to_its_logical_placements(dist_run):
    """Under rules on (data 2, model 2), shard_act moves a replicated (4, 6,
    8) activation to "act_btd"'s placements: the batch dim over data, the
    sequence dim over model too with seq_shard; each rank holds its block
    of the same values. A plain tensor, an unknown name, or no rules leave
    the input as it is (asserted on the ranks)."""
    full = np.arange(4 * 6 * 8, dtype=np.float32).reshape(4, 6, 8)
    for r, res in enumerate(dist_run[1]):
        d, m = divmod(r, 2)  # coordinates on ("data", "model")
        assert str(res["shard_act/False/placements"]) == "(Shard(dim=0), Replicate())"
        np.testing.assert_array_equal(res["shard_act/False/local"], full[2 * d:2 * d + 2])
        assert str(res["shard_act/True/placements"]) == "(Shard(dim=0), Shard(dim=1))"
        np.testing.assert_array_equal(res["shard_act/True/local"], full[2 * d:2 * d + 2, 3 * m:3 * m + 3])
        for seq in (False, True):
            np.testing.assert_array_equal(res[f"shard_act/{seq}/full"], full)


def test_param_spec_matches_reference_for_every_config(dist_run):
    """For every configuration's reduced parameters, the port's spec of a
    parameter is the trailing part of repro's spec of its stacked leaf, and
    on a (data 2, model 2) mesh its placements after the divisibility
    fixups are those of repro's param_shardings."""
    _inputs, ranks, ref, _o = dist_run
    ours = json.loads(str(ranks[0]["rules"]))["params"]
    theirs = json.loads(str(ref["shardings"]))
    rules = RefRules(ref_make_mesh((1, 1), ("data", "model")))
    assert sorted(ours) == sorted(theirs) == sorted(JARCHS)
    for arch, params in ours.items():
        for name, (part, places, shape) in params.items():
            path = _stacked(name).replace(".", "/")
            ref_shape, ref_fixed = theirs[arch][path]
            assert ref_shape[len(ref_shape) - len(shape):] == shape, (arch, name)
            want = as_list(ref_param_spec(path, len(ref_shape), rules))
            assert part == want[len(want) - len(shape):], (arch, name, part, want)
            assert places == expected_placements(ref_fixed[len(ref_fixed) - len(shape):]), (arch, name)


def test_production_mesh_names_the_world_it_needs(dist_run):
    """make_production_mesh raises naming 256 (or 512) ranks when the
    process group has another size (4 ranks, or none here)."""
    assert "256 ranks" in str(dist_run[1][0]["production_mesh_error"])
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True)


# ------------------------------------------------------------- TP / SP
def tp_leaves(res: dict, prefix: str, i: int) -> tuple[dict, dict]:
    """(metrics, state) of step ``i`` under ``prefix``, as compare_step takes them."""
    m = {k: float(res[f"{prefix}metric/{i}/{k}"]) for k in ("loss", "grad_norm", "lr")}
    pre = f"{prefix}state/{i}/"
    return m, {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


@pytest.mark.parametrize("arch,seq_shard", DC.TP_CASES, ids=[f"{a}-sp{int(s)}" for a, s in DC.TP_CASES])
def test_tp_train_step_matches_one_rank_step(dist_run, arch, seq_shard):
    """Tensor (and with seq_shard, sequence) parallelism through the LM:
    reduced ``arch`` on a (data 2, model 2) gloo mesh, its parameters
    DTensors placed by param_shardings, chunk 32, a (4, 64) batch a step,
    f32 forwards. qwen2-1.5b's 4 query heads split over the model axis
    while its one KV head stays whole; mamba2-370m's 8 heads and B6 split;
    deepseek-moe-16b's 8 experts split 4 a rank (EP) and its shared
    experts by columns. repro's check (tests/test_distributed.py
    test_train_step_runs_sharded_with_sp): the losses finite and not rising
    by 1.0. Then each step, gathered whole, is held against the one-rank
    port step from the same state (the seed-0 weights, then the TP state
    after the step before) within tests/train_cases.py's bounds
    (compare_step)."""
    _inputs, ranks, _ref, _o = dist_run
    inputs = dist_run[0]
    prefix = f"tp/{arch}/{seq_shard}/"
    losses = [float(ranks[0][f"{prefix}metric/{i}/loss"]) for i in range(DC.TP_STEPS)]
    assert all(np.isfinite(losses)) and losses[1] < losses[0] + 1.0, losses
    for i in range(DC.TP_STEPS):
        start = None if i == 0 else tp_leaves(ranks[0], prefix, i - 1)[1]
        one = DC.tp_run(arch, seq_shard, None, inputs, start=start, first=i, steps=1)
        compare_step(tp_leaves(ranks[0], prefix, i), tp_leaves(one, "", i), step=i + 1)
    for r in range(1, WORLD):  # the gathered states of all ranks agree
        for k in (k for k in ranks[0] if k.startswith(prefix)):
            np.testing.assert_array_equal(ranks[r][k], ranks[0][k], err_msg=f"rank {r} {k}")


def test_tp_prefill_matches_one_rank(dist_run):
    """Reduced qwen2-1.5b's f32 prefill of a (4, 64) batch into 80 slots
    under Rules(seq_shard=True) on (data 2, model 2): the last position's
    logits and the KV cache (zeros after position 64), gathered whole,
    within 1e-5·max|leaf| of the one-rank prefill (the row-parallel
    products sum in another order)."""
    inputs, ranks, _ref, _o = dist_run
    one = DC.tp_prefill(None, inputs)
    for k, want in one.items():
        got = ranks[0][f"tp_prefill/{k}"]
        assert got.shape == want.shape, (k, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()), err_msg=k)
    assert not np.any(ranks[0]["tp_prefill/k"][:, :, DC.TP_BATCH[1]:])


def test_tp_named_points_take_the_reference_placements(dist_run):
    """Every shard_act point the TP steps pass (recorded on each rank) gives
    its activation the placements of repro's PartitionSpec for its name
    (Rules.spec on the same rules); qwen2 passes act_btd, act_heads, act_ff
    and act_btv, mamba2 act_btd, act_ff and act_btv, deepseek-moe-16b
    act_btd, act_heads and act_btv (its shared experts' act_ff lies inside
    the MoE's kernel boundary, on each rank's plain shard)."""
    mesh = ref_make_mesh((1, 1), ("data", "model"))
    want_names = {"qwen2-1.5b": {"act_btd", "act_heads", "act_ff", "act_btv"},
                  "mamba2-370m": {"act_btd", "act_ff", "act_btv"},
                  "deepseek-moe-16b": {"act_btd", "act_heads", "act_btv"}}
    for r, res in enumerate(dist_run[1]):
        acts = json.loads(str(res["tp/acts"]))
        assert sorted(acts) == sorted(f"{a}/{s}" for a, s in DC.TP_CASES)
        for case, log in acts.items():
            arch, seq = case.split("/")
            ref = RefRules(mesh, data_axes=("data",), seq_shard=seq == "True")
            seen = {name for name, _ in log}
            assert seen == want_names[arch], (r, case, seen)
            for name, places in log:
                assert places == expected_placements(ref.spec(name)), (r, case, name, places)


def test_zero1_moments_take_the_reference_placements(dist_run):
    """Each AdamW moment's ZeRO-1 placements from the port's
    launch.specs._zero1_sharding, for full-size qwen2-1.5b and mamba2-370m
    (fake tensors: shapes only) on the (data 2, model 2) mesh, equal
    repro's _zero1_sharding of the same parameter on the same mesh. The
    port's parameters are repro's stacked leaves cut to one layer, so
    repro's is taken on that cut (its stacked leaf would put the data
    shard on the layer axis where the data size divides the depth)."""
    _inputs, ranks, ref, _o = dist_run
    ours = json.loads(str(ranks[0]["zero1"]))
    theirs = json.loads(str(ref["zero1"]))
    assert sorted(ours) == sorted(theirs) == sorted(DC.ZERO_ARCHS)
    for arch, params in ours.items():
        assert len(params) >= len(theirs[arch])
        for name, (shape, places) in params.items():
            ref_shape, ref_spec = theirs[arch][_stacked(name).replace(".", "/")]
            assert ref_shape[len(ref_shape) - len(shape):] == shape, (arch, name)
            assert places == expected_placements(ref_spec), (arch, name, places, ref_spec)
