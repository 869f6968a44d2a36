"""The port's training path against the JAX package's, on the CPU: the loss,
AdamW and its schedule, gradient compression, the gradients of ``ops.ssd``
(B6 and the recurrence across chunks) against ``jax.grad`` of
``ssd_chunked``, B6's written-out backward against autograd, the train step
of a reduced mamba2-370m, qwen2-1.5b (dense), deepseek-moe-16b (moe) and
zamba2-2.7b (hybrid) (JAX's weights through ``convert``), the trainer's
resume, and checkpoints that either package restores.

Inputs are made from seeds with numpy and handed to both packages. Each
test states its tolerance and why."""

import functools
import json
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as RefManager
from repro.configs import ARCHS as JARCHS
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro.training import optimizer as JO
from repro.training import steps as JS

from repro_torch.checkpoint.checkpoint import CheckpointManager, _flatten
from repro_torch.configs import get_arch
from repro_torch.convert import sage_file_from_reference, train_state_from_reference, train_state_to_reference
from repro_torch.core import SageStore
from repro_torch.core.errors import IntegrityError
from repro_torch.data import SageTokenPipeline
from repro_torch.kernels import cuda_lib, ops
from repro_torch.kernels.ssd_chunk import ssd_intra, ssd_intra_bwd_plain, ssd_intra_plain
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.layers import softmax_xent
from repro_torch.training import optimizer as TO
from repro_torch.training import steps as TS
from repro_torch.training.trainer import StragglerMonitor, Trainer, TrainerConfig

from train_cases import compare_step

ARCH = "mamba2-370m"
MOE = "deepseek-moe-16b"
ADAMW = dict(lr=1e-3, total_steps=8, warmup_steps=2)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def leaf_close(ours, theirs, tol: float, what: str = "") -> None:
    """|ours - theirs| <= tol · max|theirs| elementwise (and exactly 0 where
    the reference leaf is all zeros)."""
    a, b = f32(ours), f32(theirs)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    bound = tol * float(np.abs(b).max())
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= bound, f"{what}: max err {err} > {bound}"


# ------------------------------------------------------------------ the loss
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4], ids=["noz", "z"])
def test_softmax_xent_matches_reference(masked, z_loss):
    """rtol 1e-6: one f32 logsumexp and mean on each side. The labels come
    in as int32, as the pipeline yields them."""
    r = np.random.default_rng(1)
    logits = (r.standard_normal((2, 7, 33)) * 3).astype(np.float32)
    labels = r.integers(0, 33, (2, 7)).astype(np.int32)
    mask = (r.random((2, 7)) > 0.3).astype(np.float32) if masked else None
    want = JL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                           None if mask is None else jnp.asarray(mask), z_loss)
    got = softmax_xent(torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels),
                       None if mask is None else torch.from_numpy(mask), z_loss)
    want_bf = JL.softmax_xent(jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels),
                              None if mask is None else jnp.asarray(mask), z_loss)
    np.testing.assert_allclose(float(got), float(want_bf), rtol=1e-6)
    got32 = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                         None if mask is None else torch.from_numpy(mask), z_loss)
    np.testing.assert_allclose(float(got32), float(want), rtol=1e-6)


# ------------------------------------------------------------------ AdamW
def test_schedule_matches_reference():
    """Warmup, the cosine and its floor: rtol 1e-6 (f32 on both sides)."""
    jc = JO.AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=40, min_lr_frac=0.1)
    tc = TO.AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=40, min_lr_frac=0.1)
    for s in (0, 1, 4, 5, 6, 17, 39, 40, 55):
        want = float(JO.schedule(jc, jnp.asarray(s, jnp.int32)))
        got = float(TO.schedule(tc, torch.tensor(s, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def _tree(r, scale=1.0):
    return {"w": (r.standard_normal((5, 7)) * scale).astype(np.float32),
            "b": (r.standard_normal((7,)) * scale).astype(np.float32),
            "e": (r.standard_normal((3, 4)) * scale).astype(np.float32)}


def test_adamw_three_steps_match_reference():
    """Three updates with clipping active (global norm ~7 > 1), through the
    warmup (2 steps) into the cosine (5 steps): parameters, m, v within
    1e-5·max|leaf| (f32 element ops in the same order; the foreach kernels
    may fuse a multiply-add), step, grad_norm and lr within rtol 1e-6."""
    r = np.random.default_rng(2)
    jc = JO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    tc = TO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    jp = {k: jnp.asarray(v) for k, v in _tree(r).items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    jopt, topt = JO.adamw_init(jp), TO.adamw_init(tp)
    for _ in range(3):
        g = _tree(r, scale=2.0)
        jp, jopt, jm = JO.adamw_update(jc, {k: jnp.asarray(v) for k, v in g.items()}, jopt, jp)
        tp, topt, tm = TO.adamw_update(tc, {k: torch.from_numpy(v) for k, v in g.items()}, topt, tp)
        assert float(jm["grad_norm"]) > 1.0  # clipping is active
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        for k in jp:
            leaf_close(tp[k], jp[k], 1e-5, f"param {k}")
            leaf_close(topt["m"][k], jopt["m"][k], 1e-5, f"m {k}")
            leaf_close(topt["v"][k], jopt["v"][k], 1e-5, f"v {k}")
        assert int(topt["step"]) == int(jopt["step"]) and topt["step"].dtype == torch.int32


def test_global_norm_is_accurate_on_large_leaves():
    """The global norm is the reference's sqrt(Σ sum(g²)) in f32: within
    1e-6 of the float64 value on a leaf of 2^25 elements (the CPU's
    ``vector_norm`` / ``_foreach_norm`` drift by ~1e-3 there, which moved
    a full-width qwen2-1.5b cut's clipped step on the CPU away from the
    card's), and within rtol 1e-6 of ``repro``'s on small leaves."""
    r = np.random.default_rng(11)
    big = {"embed": (r.standard_normal(1 << 25) * 1e-3).astype(np.float32), "b": r.standard_normal(7).astype(np.float32)}
    exact = np.sqrt(sum(float(np.square(v.astype(np.float64)).sum()) for v in big.values()))
    got = float(TO.global_norm({k: torch.from_numpy(v) for k, v in big.items()}))
    assert abs(got - exact) <= 1e-6 * exact, (got, exact)
    small = _tree(r)
    np.testing.assert_allclose(float(TO.global_norm({k: torch.from_numpy(v) for k, v in small.items()})),
                               float(JO.global_norm({k: jnp.asarray(v) for k, v in small.items()})), rtol=1e-6)


def test_adamw_update_is_the_same_in_runs_of_any_size(monkeypatch):
    """The update walks the parameters in runs of at most CHUNK_ELEMS
    elements (bounding its temporaries): three steps give the same
    parameters, m and v bit for bit whether a run holds every parameter,
    some of them or one."""
    r = np.random.default_rng(9)
    shapes = [(5, 7), (300,), (7,), (40, 25), (2,), (64,)]
    start = {f"p{i}": torch.from_numpy(r.standard_normal(sh).astype(np.float32)) for i, sh in enumerate(shapes)}
    grads = [{k: torch.from_numpy(r.standard_normal(v.shape).astype(np.float32) * 3) for k, v in start.items()}
             for _ in range(3)]
    runs = []
    for chunk in (1 << 28, 301, 1):
        monkeypatch.setattr(TO, "CHUNK_ELEMS", chunk)
        p = {k: v.clone() for k, v in start.items()}
        opt = TO.adamw_init(p)
        for g in grads:
            p, opt, _m = TO.adamw_update(TO.AdamWConfig(lr=1e-2, warmup_steps=1), g, opt, p)
        runs.append((p, opt))
    assert [len(c) for c in TO._chunks(list(start), start)] == [1] * len(start)  # CHUNK_ELEMS is 1 here
    for p, opt in runs[1:]:
        for k in start:
            assert torch.equal(p[k], runs[0][0][k]) and torch.equal(opt["m"][k], runs[0][1]["m"][k])
            assert torch.equal(opt["v"][k], runs[0][1]["v"][k])


@pytest.mark.parametrize("how", ["bf16", "int16_ef"])
def test_compress_grads_matches_reference(how):
    """Two steps, the error feedback carried from the first into the second.
    bf16: bit for bit. int16_ef: the quantised values within 1e-6·max|g|
    (one scale division and round half to even on each side), the
    residual within 1e-6·max|g|."""
    r = np.random.default_rng(3)
    jef = tef = None
    for _ in range(2):
        g = _tree(r, scale=0.1)
        jg, jef = JS._compress_grads({k: jnp.asarray(v) for k, v in g.items()}, how, jef)
        tg, tef = TS._compress_grads({k: torch.from_numpy(v) for k, v in g.items()}, how, tef)
        for k in g:
            gmax = float(np.abs(g[k]).max())
            err = float(np.abs(f32(tg[k]) - f32(jg[k])).max())
            assert err <= (0.0 if how == "bf16" else 1e-6 * gmax), (k, err)
            if how == "int16_ef":
                assert float(np.abs(f32(tef[k]) - f32(jef[k])).max()) <= 1e-6 * gmax
    if how == "bf16":
        assert jef is None and tef is None


# ------------------------------------------------------ the SSD's gradients
# (name, B, S, H, P, N, chunk, x dtype, A max, dt shift)
SSD_GRAD_CASES = [
    ("ragged16", 2, 37, 3, 8, 5, 16, "f32", 4.0, -1.0),
    ("chunk1", 2, 9, 3, 8, 5, 1, "f32", 4.0, -1.0),
    ("chunk2", 2, 9, 3, 8, 5, 2, "f32", 4.0, -1.0),
    ("whole16", 1, 32, 4, 8, 6, 16, "f32", 4.0, -1.0),
    ("bf16", 2, 37, 3, 8, 5, 16, "bf16", 4.0, -1.0),
    ("large_decay", 1, 32, 4, 8, 5, 16, "f32", 6.0, 0.0),
]


@pytest.mark.parametrize("case", SSD_GRAD_CASES, ids=[c[0] for c in SSD_GRAD_CASES])
def test_ssd_gradients_match_jax_grad(case):
    """Gradients of Σ gy·y + Σ gs·state through ``ops.ssd`` (B6's
    autograd.Function, its plain forward and backward on the CPU, and the
    recurrence) against ``jax.grad`` of ``ssd_chunked``, for x, dt, A, B, C
    and the initial state: each within 1e-5·max|grad| in f32 (sums in
    another order; ``cum`` in f64 on the port's side). With bf16 x, dx
    within one bf16 ulp of its largest value (2^-7·max) and the rest within
    1e-5·max: both sides round the intra-chunk term to bf16 at other
    places. ``large_decay``: a chunk's log-decay reaches ~70, so L spans
    e^-70..1 but exp of the upper triangle stays finite in f32 (the
    reference's masked-``where`` gradient is NaN past e^88)."""
    _name, Bb, S, H, P, N, chunk, xdt, amax, shift = case
    r = np.random.default_rng(4)
    x = r.standard_normal((Bb, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((Bb, S, H)) + shift)).astype(np.float32)
    A = -np.linspace(1.0, amax, H).astype(np.float32)
    B = (r.standard_normal((Bb, S, H, N)) * 0.3).astype(np.float32)
    C = (r.standard_normal((Bb, S, H, N)) * 0.3).astype(np.float32)
    s0 = (r.standard_normal((Bb, H, P, N)) * 0.1).astype(np.float32)
    gy = r.standard_normal((Bb, S, H, P)).astype(np.float32)
    gs = r.standard_normal((Bb, H, P, N)).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if xdt == "bf16" else (jnp.float32, torch.float32)

    def jloss(x, dt, A, B, C, s0):
        y, s = jax_ssd_chunked(x.astype(jd), dt, A, B, C, chunk, s0)
        return jnp.sum(y.astype(jnp.float32) * gy) + jnp.sum(s * gs)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*(jnp.asarray(a) for a in (x, dt, A, B, C, s0)))
    assert all(bool(jnp.isfinite(w).all()) for w in want)
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, B, C, s0)]
    cuda_lib.reset_counts()
    y, s = ops.ssd(ins[0].to(td), *ins[1:5], chunk, ins[5])
    loss = (y.float() * torch.from_numpy(gy)).sum() + (s * torch.from_numpy(gs)).sum()
    got = torch.autograd.grad(loss, ins)
    assert cuda_lib.counts() == {"plain:ssd_intra": 1, "plain:ssd_intra_bwd": 1, "plain:ssd_chain": 1,
                                 "plain:ssd_chain_bwd": 1}
    for name, g, w in zip(("x", "dt", "A", "B", "C", "state0"), got, want):
        tol = 2.0**-7 if (name == "x" and xdt == "bf16") else 1e-5
        leaf_close(g, w, tol, name)


def test_ssd_intra_bwd_plain_matches_autograd():
    """The written-out backward against torch.autograd through
    ``ssd_intra_plain`` on the same f32 inputs and output gradients (dy,
    dst, dtotal), within 1e-5·max|grad|; with bf16 x and dy the written-out
    dx is autograd's (f32, on the bf16 dy) rounded once to bf16: within one
    bf16 ulp of it, plus the same 1e-5·max|dx|. At large decay (log-decay past 88 in
    a chunk) autograd's da is NaN (0·inf in the masked exp) and the
    written-out one stays finite, while dx, dB and dC still agree."""
    r = np.random.default_rng(5)
    for Q, H, shift, amax in ((16, 3, -1.0, 4.0), (7, 2, -1.0, 2.0), (128, 2, 2.0, 16.0)):
        Bb, nc, P, N = 2, 2, 8, 5
        x = r.standard_normal((Bb, nc, Q, H, P)).astype(np.float32)
        dt = np.log1p(np.exp(r.standard_normal((Bb, nc, Q, H)) + shift)).astype(np.float32)
        a = (dt * -np.linspace(1.0, amax, H)).astype(np.float32)
        B = (r.standard_normal((Bb, nc, Q, H, N)) * 0.3).astype(np.float32)
        C = (r.standard_normal((Bb, nc, Q, H, N)) * 0.3).astype(np.float32)
        dy = r.standard_normal((Bb, nc, Q, H, P)).astype(np.float32)
        dst = r.standard_normal((Bb, nc, H, P, N)).astype(np.float32)
        dtot = r.standard_normal((Bb, nc, H)).astype(np.float32)
        ins = [torch.from_numpy(t).requires_grad_() for t in (x, dt, a, B, C)]
        outs = ssd_intra_plain(*ins)
        gs = [torch.from_numpy(t) for t in (dy, dst, dtot)]
        auto = torch.autograd.grad(sum((o * g).sum() for o, g in zip(outs, gs)), ins, retain_graph=True)
        mine = ssd_intra_bwd_plain(*(t.detach() for t in ins), *gs)
        overflow = Q == 128
        for name, m, w in zip(("dx", "ddt", "da", "dB", "dC"), mine, auto):
            assert m.dtype == torch.float32 and bool(torch.isfinite(m).all()), name
            if overflow and name == "da":
                assert not bool(torch.isfinite(w).all())  # why the backward is written out
                continue
            leaf_close(m, w, 1e-5, name)
        xb, dyb = torch.from_numpy(x).bfloat16(), torch.from_numpy(dy).bfloat16()
        dx_bf = ssd_intra_bwd_plain(xb, *(t.detach() for t in ins[1:]), dyb, *gs[1:])[0]
        assert dx_bf.dtype == torch.bfloat16
        want = torch.autograd.grad(sum((o * g).sum() for o, g in zip(outs, [dyb.float(), *gs[1:]])),
                                   ins[0])[0]
        ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)  # bf16: 8 significant bits
        err = (dx_bf.float() - want).abs()
        assert bool((err <= ulp + 1e-5 * want.abs().max()).all()), float((err - ulp).max())


def test_ssd_intra_routes_by_grad_mode():
    """Under grad mode with an input that requires grad, ``ssd_intra`` goes
    through the autograd.Function (the forward is counted once, the backward
    once); under no_grad it is one forward call and keeps nothing."""
    r = np.random.default_rng(6)
    x = torch.from_numpy(r.standard_normal((1, 2, 4, 2, 3)).astype(np.float32))
    dt = torch.from_numpy(np.abs(r.standard_normal((1, 2, 4, 2))).astype(np.float32))
    a = -dt
    B = torch.from_numpy(r.standard_normal((1, 2, 4, 2, 5)).astype(np.float32))
    cuda_lib.reset_counts()
    with torch.no_grad():
        y, _st, _tot = ssd_intra(x.requires_grad_(), dt, a, B, B)
    assert y.grad_fn is None and cuda_lib.counts() == {"plain:ssd_intra": 1}
    y, st, tot = ssd_intra(x, dt, a, B, B)
    assert y.grad_fn is not None
    (y.sum() + st.sum() + tot.sum()).backward()
    assert cuda_lib.counts() == {"plain:ssd_intra": 2, "plain:ssd_intra_bwd": 1}
    assert x.grad is not None and x.grad.shape == x.shape


# ------------------------------------------------------------ the train step
@functools.cache
def start_of(arch: str):
    """A reduced ``arch``'s initial train state from the JAX package, as
    host numpy (the port loads it through ``convert``)."""
    jcfg = JARCHS[arch].reduced()
    jopts = JS.TrainOptions(chunk=32, adamw=JO.AdamWConfig(**ADAMW))
    params, opt = JS.init_train_state(jax.random.PRNGKey(0), jcfg, jopts)
    return jcfg, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt)


@pytest.fixture(scope="module")
def start():
    return start_of(ARCH)


def batches(cfg, n, B=2, S=32, seed=7):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = r.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def port_state(cfg, params, opt):
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    sd, topt = train_state_from_reference(cfg, params, opt)
    model.load_state_dict(sd)
    return model, topt


_JAX_STEPS: dict = {}  # jitted reference steps by (dtype, options): each compiles once a process


def run_both(start, n_steps, *, dtype="bf16", monkeypatch=None, arch=ARCH, **opt_kw):
    """``n_steps`` of both packages' train steps from the same state on the
    same batches; returns (the two metric lists, the two final states in
    the JAX package's layout as flat {name: array})."""
    jcfg, params, opt = start
    cfg = get_arch(arch).reduced()
    if dtype == "f32":  # both forwards in f32: the reference's step calls lm.forward with its default dtype
        monkeypatch.setattr(JLM, "forward", functools.partial(JLM.forward, dtype=jnp.float32))
        monkeypatch.setattr(lm, "forward", functools.partial(lm.forward, dtype=torch.float32))
    jo = JS.TrainOptions(chunk=32, adamw=JO.AdamWConfig(**ADAMW), **opt_kw)
    to = TS.TrainOptions(chunk=32, adamw=TO.AdamWConfig(**ADAMW), **opt_kw)
    key = (arch, dtype, tuple(sorted(opt_kw.items())))
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = jax.jit(JS.make_train_step(jcfg, jo))
    jstep = _JAX_STEPS[key]
    tstep = TS.make_train_step(cfg, to)
    jp, jopt = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, opt)
    if opt_kw.get("grad_compress") == "int16_ef":
        jopt["ef"] = jax.tree.map(jnp.zeros_like, jp)
    model, topt = port_state(cfg, params, jax.tree.map(np.asarray, jopt))
    jms, tms = [], []
    for b in batches(cfg, n_steps):
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in b.items()})
        model, topt, tm = tstep(model, topt, {k: torch.from_numpy(v) for k, v in b.items()})
        jms.append({k: float(v) for k, v in jm.items()})
        tms.append({k: float(v) for k, v in tm.items()})
    ours = dict(_flatten(train_state_to_reference(cfg, model, topt)))
    theirs = dict(_flatten({"params": jax.tree.map(np.asarray, jp), "opt": jax.tree.map(np.asarray, jopt)}))
    return jms, tms, ours, theirs


@pytest.mark.parametrize("arch,n_steps", [(ARCH, 1), (ARCH, 3), ("qwen2-1.5b", 1), ("zamba2-2.7b", 1),
                                          ("zamba2-2.7b", 3)],
                         ids=["1", "3", "qwen2-1.5b-1", "zamba2-2.7b-1", "zamba2-2.7b-3"])
def test_train_step_matches_reference_f32(arch, n_steps, monkeypatch):
    """f32 forwards on both sides: the loss within 1e-4 relative, grad_norm
    and lr within 1e-4 relative, every parameter, m and v leaf within
    1e-4·max|leaf|, the step equal. (AdamW divides m by sqrt(v): where a
    gradient is near 0 its sign decides the update, which is why the bound
    is 1e-4 and not f32's ~1e-6.) The ssm (mamba2-370m), dense (qwen2-1.5b:
    tied, QKV biases, attention through ``CausalFlash``) and hybrid
    (zamba2-2.7b: the shared block's leaves) families.

    qwen2's key bias: RoPE all but cancels its gradient (without RoPE a
    bias shared by every key shifts all scores of a query alike), so parts
    of it fall to |ĝ| ~ AdamW's eps, where the update ĝ/(|ĝ| + eps) turns
    the gradients' f32 noise into a parameter change of up to lr. Its step
    is held to tests/train_cases.py's bounds, which add that term
    (lr·min(2, τ·eps/(|ĝ| + eps)²)) to the parameters' 1e-4·max|leaf|."""
    jms, tms, ours, theirs = run_both(start_of(arch), n_steps, dtype="f32", monkeypatch=monkeypatch, arch=arch)
    if get_arch(arch).qkv_bias:
        compare_step((tms[0], ours), (jms[0], theirs))
        return
    for jm, tm in zip(jms, tms):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        if k == "opt/step":
            assert int(ours[k]) == int(theirs[k]) == n_steps
        else:
            leaf_close(ours[k], theirs[k], 1e-4, k)


def test_train_step_matches_reference_bf16():
    """The default bf16 forward, two steps: the loss within 2e-2 relative
    (bf16 rounds at other places in XLA's fused ops and in eager torch)."""
    bf16_steps_match(ARCH)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-2.7b"])
def test_family_train_step_matches_reference_bf16(arch):
    """``bf16_steps_match`` for the dense and hybrid families."""
    bf16_steps_match(arch)


@pytest.mark.parametrize("remat,policy", [(False, "nothing"), (True, "nothing"), (True, "dots")],
                         ids=["off", "nothing", "dots"])
def test_moe_train_step_matches_reference_f32(remat, policy, monkeypatch):
    """One f32 train step of the reduced deepseek-moe-16b (2 layers, 8
    experts of d_ff 32, top-2, one shared; pairs dropped at the default
    capacity factor), the aux loss in the objective at aux_coeff 0.01, with
    remat off, ``nothing`` and ``dots`` on both sides: the loss, and every
    leaf of the state within tests/train_cases.py's AdamW-aware bounds.
    ``aux`` within 1e-5."""
    jms, tms, ours, theirs = run_both(start_of(MOE), 1, dtype="f32", monkeypatch=monkeypatch, arch=MOE,
                                      remat=remat, remat_policy=policy)
    np.testing.assert_allclose(tms[0]["aux"], jms[0]["aux"], rtol=1e-5, atol=1e-5)
    compare_step((tms[0], ours), (jms[0], theirs))


def test_moe_aux_reaches_the_loss_with_its_gradient(monkeypatch):
    """The moe family's aux (the sum of its layers' load-balance losses)
    enters the loss at aux_coeff with its gradient: in f32, the router's
    gradient moves with aux_coeff, by aux_coeff times the gradient of aux
    alone (within 1e-5 of the gradient's largest value: the two runs' loss
    gradients cancel in another order); ``metrics["aux"]`` is a detached
    f32 tensor."""
    monkeypatch.setattr(lm, "forward", functools.partial(lm.forward, dtype=torch.float32))
    _jcfg, params, opt = start_of(MOE)
    cfg = get_arch(MOE).reduced()
    b = {k: torch.from_numpy(v) for k, v in batches(cfg, 1)[0].items()}
    model, _ = port_state(cfg, params, opt)
    grads = {c: TS._grads(model, cfg, b, TS.TrainOptions(remat=False, aux_coeff=c)) for c in (0.0, 1.0)}
    _loss, m, _g = grads[1.0]
    assert isinstance(m["aux"], torch.Tensor) and not m["aux"].requires_grad and m["aux"].dtype == torch.float32
    assert float(m["aux"]) > 0
    _l, aux = lm.forward(model, cfg, b["tokens"], remat=False)
    aux_grads = dict(zip(dict(model.named_parameters()), torch.autograd.grad(aux, list(model.parameters()),
                                                                              allow_unused=True)))
    for i in range(cfg.n_layers):
        name = f"layers.{i}.moe.router"
        moved = grads[1.0][2][name] - grads[0.0][2][name]
        assert float(moved.abs().max()) > 0, name
        top = float(grads[1.0][2][name].abs().max())
        np.testing.assert_allclose(moved.numpy(), aux_grads[name].numpy(), rtol=0, atol=1e-5 * top)
    last = f"layers.{cfg.n_layers - 1}.moe"  # its aux depends on its input and router, not on its experts
    assert aux_grads[f"{last}.experts.up"] is None and aux_grads[f"{last}.router"] is not None


def bf16_steps_match(arch):
    """Two steps of both packages' default bf16 train step: the loss within
    2e-2 relative, grad_norm within 5e-2."""
    jms, tms, _ours, _theirs = run_both(start_of(arch), 2, arch=arch)
    for jm, tm in zip(jms, tms):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=2e-2)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=5e-2)


def test_microbatch_matches_reference(start, monkeypatch):
    """``microbatch=2`` in f32: loss and grad_norm within 1e-4 relative,
    each leaf within 1e-4·max|leaf|, as the unsplit step."""
    jms, tms, ours, theirs = run_both(start, 1, dtype="f32", monkeypatch=monkeypatch, microbatch=2)
    np.testing.assert_allclose(tms[0]["loss"], jms[0]["loss"], rtol=1e-4)
    np.testing.assert_allclose(tms[0]["grad_norm"], jms[0]["grad_norm"], rtol=1e-4)
    for k in theirs:
        if k != "opt/step":
            leaf_close(ours[k], theirs[k], 1e-4, k)


def test_compressed_train_step_matches_reference(monkeypatch):
    """``compressed_steps_match`` for mamba2-370m."""
    compressed_steps_match(ARCH, monkeypatch)


def test_family_compressed_train_step_matches_reference(monkeypatch):
    """``compressed_steps_match`` for the hybrid family (zamba2-2.7b): int16
    error feedback on its nested layer leaves and its shared block."""
    compressed_steps_match("zamba2-2.7b", monkeypatch)


def compressed_steps_match(arch, monkeypatch):
    """``grad_compress="int16_ef"`` in f32, two steps: loss and grad_norm
    within 1e-4 relative; the error feedback lives in opt["ef"] on both
    sides with one scale a JAX leaf (a layer parameter's scale spans its
    layers). Rounding to the int8 grid turns the gradients' f32 noise
    (~1e-6 relative) into: ef off by up to 127·1e-6 of the scale, i.e.
    within 1e-3·max|ef|; and, where x/scale falls within that noise of a
    half-integer, a quantum flipped, so ef moves by one step (<= 2·max|ef|)
    and that element's m, v and parameter move with it. So: at most 0.5%
    of a leaf's elements (and at least one allowed) may sit outside
    1e-4·max|leaf| (1e-3 for ef), and a flipped ef element stays within one
    quantum. The hybrid's (zamba2-2.7b) layer parameters share one scale
    across groups and layers, its shared block's one a parameter."""
    jms, tms, ours, theirs = run_both(start_of(arch), 2, dtype="f32", monkeypatch=monkeypatch,
                                      grad_compress="int16_ef", arch=arch)
    for jm, tm in zip(jms, tms):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)
    assert any(k.startswith("opt/ef/") for k in theirs) and sorted(ours) == sorted(theirs)
    for k in theirs:
        if k == "opt/step":
            continue
        a, b = f32(ours[k]), f32(theirs[k])
        top = float(np.abs(b).max())
        off = np.abs(a - b) > (1e-3 if k.startswith("opt/ef/") else 1e-4) * top
        assert off.sum() <= max(1, 0.005 * off.size), (k, int(off.sum()), off.size)
        if k.startswith("opt/ef/"):
            assert float(np.abs(a - b).max()) <= 2.01 * top, k


@pytest.mark.parametrize("policy", [(False, "nothing"), (True, "nothing"), (True, "dots")],
                         ids=["off", "nothing", "dots"])
def test_remat_gives_the_same_gradients(start, policy):
    """Remat recomputes the same ops: gradients with remat off, on
    (``nothing``) and ``dots`` equal the no-remat ones within 1e-6·max. With
    remat, B6's forward runs twice a layer and its backward once."""
    _jcfg, params, opt = start
    cfg = get_arch(ARCH).reduced()
    b = {k: torch.from_numpy(v) for k, v in batches(cfg, 1)[0].items()}
    model, _ = port_state(cfg, params, opt)
    base = TS._grads(model, cfg, b, TS.TrainOptions(remat=False))[2]
    remat, pol = policy
    cuda_lib.reset_counts()
    loss, _m, grads = TS._grads(model, cfg, b, TS.TrainOptions(remat=remat, remat_policy=pol))
    L = cfg.n_layers
    assert cuda_lib.counts() == {"plain:ssd_intra": (2 if remat else 1) * L, "plain:ssd_intra_bwd": L,
                                 "plain:ssd_chain": (2 if remat else 1) * L, "plain:ssd_chain_bwd": L}
    for k, g in grads.items():
        leaf_close(g, base[k], 1e-6, k)


@pytest.mark.parametrize("remat", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-moe-16b", "zamba2-2.7b"])
def test_family_remat_gives_the_same_gradients(arch, remat, monkeypatch):
    """Remat as the reference places it: every dense and moe block is
    checkpointed, so the attention's forward (``_flash_fwd_impl``) runs
    twice a layer a step and its backward once (a moe block's aux leaves
    the checkpoint beside x); the hybrid checkpoints each Mamba2 block
    (B6 forward twice a layer, backward once) and not the shared block
    (its attention forward runs once a group). The gradients equal the
    no-remat ones within 1e-6·max."""
    jcfg, params, opt = start_of(arch)
    cfg = get_arch(arch).reduced()
    b = {k: torch.from_numpy(v) for k, v in batches(cfg, 1)[0].items()}
    model, _ = port_state(cfg, params, opt)
    base = TS._grads(model, cfg, b, TS.TrainOptions(remat=False, chunk=8))[2]
    runs = {"fwd": 0, "bwd": 0}

    def counted(fn, key):
        def run(*a):
            runs[key] += 1
            return fn(*a)
        return run

    monkeypatch.setattr(L, "_flash_fwd_impl", counted(L._flash_fwd_impl, "fwd"))
    monkeypatch.setattr(L, "_flash_bwd", counted(L._flash_bwd, "bwd"))
    cuda_lib.reset_counts()
    _loss, _m, grads = TS._grads(model, cfg, b, TS.TrainOptions(remat=remat, chunk=8))
    if cfg.family in ("dense", "moe"):
        assert runs == {"fwd": (2 if remat else 1) * cfg.n_layers, "bwd": cfg.n_layers}
        assert cuda_lib.counts() == {}
    else:
        groups = cfg.n_layers // cfg.attn_every
        assert runs == {"fwd": groups, "bwd": groups}
        n_fwd = (2 if remat else 1) * cfg.n_layers
        assert cuda_lib.counts() == {"plain:ssd_intra": n_fwd, "plain:ssd_intra_bwd": cfg.n_layers,
                                     "plain:ssd_chain": n_fwd, "plain:ssd_chain_bwd": cfg.n_layers}
    for k, g in grads.items():
        leaf_close(g, base[k], 1e-6, k)


def test_stacked_maps_every_parameter_onto_its_jax_leaf():
    """``_stacked`` names each parameter by the JAX package's leaf: the
    layers' (one index, or the hybrid's two) dropped, ``shared_attn.*`` and
    the embedding, norm and head as they are; int16_ef keeps one scale a
    leaf."""
    for arch in (ARCH, "qwen2-1.5b", "minitron-8b", MOE, "zamba2-2.7b"):
        jcfg = JARCHS[arch].reduced()
        leaves = {".".join(str(k.key) for k in path)
                  for path, _ in jax.tree_util.tree_flatten_with_path(JLM.init_params(jax.random.PRNGKey(0), jcfg))[0]}
        model = lm.init_params(torch.Generator().manual_seed(0), get_arch(arch).reduced(), device="cpu")
        assert {TS._stacked(k) for k in model.state_dict()} == leaves, arch
    assert TS._stacked("layers.3.12.ssm.in_x") == "layers.ssm.in_x"
    assert TS._stacked("shared_attn.attn.wq") == "shared_attn.attn.wq"


def test_nan_gate_leaves_the_state_untouched(start):
    """The twin of test_substrate.py's circuit breaker: a NaN loss mask makes
    the loss NaN, and parameters, m, v and step stay bit for bit."""
    _jcfg, params, opt = start
    cfg = get_arch(ARCH).reduced()
    model, topt = port_state(cfg, params, opt)
    step = TS.make_train_step(cfg, TS.TrainOptions(chunk=32))
    bad = {"tokens": torch.zeros((2, 32), dtype=torch.int32), "labels": torch.zeros((2, 32), dtype=torch.int32),
           "loss_mask": torch.full((2, 32), float("nan"))}
    before = dict(_flatten(train_state_to_reference(cfg, model, topt)))
    model, topt, m = step(model, topt, bad)
    assert not np.isfinite(float(m["loss"]))
    after = dict(_flatten(train_state_to_reference(cfg, model, topt)))
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)


# ---------------------------------------------------------------- trainer
def _pipe(illumina_encoded, cfg):
    return SageTokenPipeline(sage_file_from_reference(illumina_encoded[1]), cfg.vocab, batch=2,
                             seq_len=32, store=SageStore(device="cpu"))


def _trainer(illumina_encoded, start, ckpt_dir, total):
    _jcfg, params, opt = start
    cfg = get_arch(ARCH).reduced()
    model, topt = port_state(cfg, params, opt)
    pipe = _pipe(illumina_encoded, cfg)
    tc = TrainerConfig(total_steps=total, ckpt_every=2, log_every=1, ckpt_dir=str(ckpt_dir))
    opts = TS.TrainOptions(chunk=32, adamw=TO.AdamWConfig(**ADAMW))
    return Trainer(tc, cfg, opts, model, topt, iter(pipe.batches())), pipe


def test_trainer_resume_matches_uninterrupted(illumina_encoded, start, tmp_path):
    """The twin of test_trainer_resume_after_interrupt: a run stopped after
    2 steps and resumed by a fresh trainer and pipeline from its checkpoint
    (parameters, AdamW state, data cursor) gives the loss history of an
    uninterrupted 4-step run (rtol 1e-6: the same ops on the same CPU)."""
    full, pipe = _trainer(illumina_encoded, start, tmp_path / "full", 4)
    whole = full.run(pipeline=pipe)
    first, pipe1 = _trainer(illumina_encoded, start, tmp_path / "cut", 2)
    first.run(pipeline=pipe1)
    second, pipe2 = _trainer(illumina_encoded, start, tmp_path / "cut", 4)
    assert second.maybe_resume(pipe2) and second.step == 2
    assert int(second.opt["step"]) == 2
    second.run(pipeline=pipe2)
    assert second.step == 4 and [h["step"] for h in second.history] == [3, 4]
    np.testing.assert_allclose([h["loss"] for h in first.history + second.history],
                               [h["loss"] for h in whole], rtol=1e-6)
    assert full.ckpt.steps() == [2, 4]


def _ran_ahead(pipe, batches: int) -> None:
    """Wait until a prefetching worker has made ``batches`` batches."""
    need = pipe.batch * (pipe.seq_len + 1)
    for _ in range(1000):
        if pipe.cursor.consumed >= batches * need:
            return
        time.sleep(0.01)
    raise AssertionError("the prefetch worker made no batch ahead of the trainer")


def test_prefetched_batches_save_the_cursor_of_the_last_batch_handed_out(illumina_encoded):
    """ROADMAP C-1: the launchers draw batches through
    launch.train.PrefetchedBatches, whose state() is the cursor of the last
    batch handed to the trainer, although its worker runs ahead. Restored
    into a fresh pipeline, it gives batch k + 1 of an uninterrupted
    batches() stream after k batches; pipe.state() beside pipe.prefetched()
    (the launchers' pairing before) skips the batches made ahead."""
    cfg = get_arch(ARCH).reduced()
    k = 3
    whole = _pipe(illumina_encoded, cfg).batches()
    want = [next(whole) for _ in range(k + 1)]

    feed = launch_train.PrefetchedBatches(_pipe(illumina_encoded, cfg))
    for i in range(k):
        np.testing.assert_array_equal(next(feed)["tokens"], want[i]["tokens"])
    _ran_ahead(feed.pipe, k + 1)
    resumed = _pipe(illumina_encoded, cfg)
    resumed.restore(feed.state())
    nxt = next(resumed.batches())
    np.testing.assert_array_equal(nxt["tokens"], want[k]["tokens"])
    np.testing.assert_array_equal(nxt["labels"], want[k]["labels"])
    with pytest.raises(RuntimeError, match="already drawn"):
        feed.restore(feed.state())

    pipe = _pipe(illumina_encoded, cfg)
    stream = pipe.prefetched()
    for _ in range(k):
        next(stream)
    _ran_ahead(pipe, k + 1)
    stale = _pipe(illumina_encoded, cfg)
    stale.restore(pipe.state())
    assert not np.array_equal(next(stale.batches())["tokens"], want[k]["tokens"])
    stream.close()


def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(warmup=3)
    seen = []
    mon.hook = lambda step, dt, ew: seen.append(step)
    for i in range(10):
        mon.observe(i, 0.1)
    assert mon.observe(99, 1.0)  # 10x slower
    assert mon.anomalies == 1 and seen == [99]


# ------------------------------------------------------------- checkpoints
def test_checkpoint_roundtrip_and_gc(tmp_path):
    """Leaves come back bit for bit (numpy and torch leaves), GC keeps the
    last 2, the manifest records what the reference's does."""
    cm = CheckpointManager(tmp_path, keep_last=2)
    state = {"w": torch.arange(12.0).reshape(3, 4), "n": {"b": np.ones((2,), np.int32)}}
    for s in (1, 2, 3):
        cm.save(s, state, extra={"tag": s}, block=s == 3)
    cm.wait()
    assert cm.steps() == [2, 3] and cm.latest_step() == 3
    restored, extra, step = cm.restore(state, verify=True)
    assert step == 3 and extra["tag"] == 3
    np.testing.assert_array_equal(restored["w"], state["w"].numpy())
    np.testing.assert_array_equal(restored["n"]["b"], state["n"]["b"])
    man = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    assert man["treedef"] == "PyTreeDef({'n': {'b': *}, 'w': *})"
    assert [(leaf["name"], leaf["file"]) for leaf in man["leaves"]] == [("n/b", "n__b.npy"), ("w", "w.npy")]


def test_checkpoint_detects_corruption(tmp_path):
    """A flipped value fails the checksum: IntegrityError (an OSError)."""
    cm = CheckpointManager(tmp_path)
    cm.save(1, {"w": np.ones((4, 4), np.float32)}, block=True)
    f = tmp_path / "step_1" / "w.npy"
    arr = np.load(f)
    arr[0, 0] = 42
    np.save(f, arr)
    with pytest.raises(IntegrityError, match="checksum mismatch for w"):
        cm.restore({"w": np.zeros((4, 4), np.float32)}, verify=True)
    assert issubclass(IntegrityError, OSError)


def test_checkpoints_cross_between_packages(tmp_path):
    """``checkpoints_cross`` for mamba2-370m."""
    checkpoints_cross(ARCH, tmp_path)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "yi-9b", "deepseek-moe-16b", "zamba2-2.7b"])
def test_family_checkpoints_cross_between_packages(arch, tmp_path):
    """``checkpoints_cross`` for the dense (tied and untied), moe (stacked
    experts, router and shared expert) and hybrid (nested layers, shared
    block) layouts."""
    checkpoints_cross(arch, tmp_path)


def checkpoints_cross(arch, tmp_path):
    """A train state written by ``repro``'s CheckpointManager restores in
    the port (through ``convert``) and one written by the port restores in
    ``repro``, every array equal bit for bit, with the same manifest."""
    jcfg, params, opt = start_of(arch)
    cfg = get_arch(arch).reduced()
    r = np.random.default_rng(8)
    jstate = {"params": jax.tree.map(lambda a: a + r.standard_normal(a.shape).astype(a.dtype), params),
              "opt": {**opt, "step": np.asarray(5, np.int32)}}
    RefManager(tmp_path / "jax").save(5, jstate, extra={"pipeline": {"cursor": {"consumed": 9}}}, block=True)
    model, topt = port_state(cfg, params, opt)
    like = train_state_to_reference(cfg, model, topt, shapes_only=True)
    got, extra, step = CheckpointManager(tmp_path / "jax").restore(like, verify=True)
    assert step == 5 and extra["pipeline"]["cursor"]["consumed"] == 9
    sd, topt2 = train_state_from_reference(cfg, got["params"], got["opt"])
    model.load_state_dict(sd)
    mine = dict(_flatten(train_state_to_reference(cfg, model, topt2)))
    for k, v in _flatten(jstate):
        np.testing.assert_array_equal(mine[k], np.asarray(v), err_msg=k)

    CheckpointManager(tmp_path / "torch").save(7, train_state_to_reference(cfg, model, topt2), block=True)
    back, _extra, step = RefManager(tmp_path / "torch").restore(
        jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jstate), verify=True)
    assert step == 7
    for (k, a), (_k, b) in zip(_flatten(back), _flatten(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=k)
    ours = json.loads((tmp_path / "torch" / "step_7" / "manifest.json").read_text())
    theirs = json.loads((tmp_path / "jax" / "step_5" / "manifest.json").read_text())
    assert ours["treedef"] == theirs["treedef"]
    fields = ("name", "file", "shape", "dtype")
    assert [[x[f] for f in fields] for x in ours["leaves"]] == [[x[f] for f in fields] for x in theirs["leaves"]]


# --------------------------------------------------------- entry points
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-moe-16b", "zamba2-2.7b"])
def test_launch_train_trains_dense_and_hybrid_on_the_cpu(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch <dense, moe or hybrid>
    --smoke --device cpu`` trains the reduced model on SAGe tokens and
    writes its final checkpoint in the JAX package's layout."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path)]
    handlers = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        launch_train.main(args)
    finally:
        for sig, h in handlers.items():
            signal.signal(sig, h)
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out and "final loss" in out
    man = json.loads((tmp_path / "step_2" / "manifest.json").read_text())
    assert any(leaf["name"].startswith("params/layers/attn/") or leaf["name"].startswith("params/shared_attn/")
               for leaf in man["leaves"])


def test_launch_train_smoke_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu`` trains,
    checkpoints and resumes. The launcher installs SIGTERM/SIGINT
    handlers; the test puts the process's own back."""
    args = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "64",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    handlers = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        launch_train.main(args)
        out = capsys.readouterr().out
        assert "arch=mamba2-370m-smoke" in out and "final loss" in out
        assert CheckpointManager(tmp_path).steps() == [2, 3]
        launch_train.main([a if a != "3" else "5" for a in args] + ["--resume"])
        assert "resumed at step 3" in capsys.readouterr().out
        assert CheckpointManager(tmp_path).latest_step() == 5
    finally:
        for sig, h in handlers.items():
            signal.signal(sig, h)


def test_other_families_raise_naming_slice_6b(tmp_path):
    """Slice 6b part 3 is ported: the encdec and vlm families build their
    train state and cross ``convert`` both ways, and ``loss_fn`` passes a
    batch's frames / patch_embeds on to ``forward``. What still raises is
    the reference's own failure: a batch of tokens alone (the token
    pipeline's, as the training launcher feeds it) has no frames or
    patches, and the port raises ValueError naming them."""
    for name, key in (("whisper-small", "frames"), ("qwen2-vl-72b", "patch_embeds")):
        cfg = get_arch(name).reduced()
        model, opt = TS.init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
        sd, opt2 = train_state_from_reference(cfg, *(lambda s: (s["params"], s["opt"]))(
            train_state_to_reference(cfg, model, opt)))
        assert sorted(sd) == sorted(model.state_dict()) and int(opt2["step"]) == 0
        batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64), "labels": torch.zeros((1, 4), dtype=torch.int64),
                 key: torch.zeros((1, 4, cfg.d_model))}
        loss, metrics = TS.loss_fn(model, cfg, batch, TS.TrainOptions())
        assert bool(torch.isfinite(loss)) and metrics["aux"] == 0.0
        with pytest.raises(ValueError, match=key):
            TS.loss_fn(model, cfg, {k: v for k, v in batch.items() if k != key}, TS.TrainOptions())
        handlers = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
        try:
            with pytest.raises(ValueError, match=key):
                launch_train.main(["--arch", name, "--smoke", "--device", "cpu", "--steps", "1", "--batch", "2",
                                   "--seq", "16", "--ckpt-dir", str(tmp_path / name)])
        finally:
            for sig, h in handlers.items():
                signal.signal(sig, h)


def test_train_path_raises_without_a_card():
    """No fallback: without a card, the train path's entry points asked for
    the card (their default) raise instead of running the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is valid")
    cfg = get_arch(ARCH).reduced()
    with pytest.raises(RuntimeError, match="is_available"):
        TS.init_train_state(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        launch_train.main(["--smoke", "--steps", "1"])
