"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on the CPU, at the reduced deepseek-moe-16b
(d_model 64, 8 experts of d_ff 32, top-2, one shared expert), with JAX's
weights carried across.

Inputs are made from seeds with numpy and handed to both packages.
Tolerances: f32 within 1e-4 (rtol and atol; sums in another order), bf16
within 5e-2 (bf16 rounds at other places in XLA's fused ops and in eager
torch), as tests/test_torch_lm.py has them; the aux loss within 1e-5 in
f32 and 1e-3 in bf16 (an f32 mean of probabilities whose router logits
were rounded to bf16 in other orders). Routing is compared exactly: given
the same input, both packages pick the same experts in both dtypes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import moe as JM

from repro_torch.configs import get_arch
from repro_torch.models import moe as M

ARCH = "deepseek-moe-16b"
DT = {"f32": (jnp.float32, torch.float32, 1e-4, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2, 1e-3)}


def f32(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def close(ours, theirs, tol, what=""):
    np.testing.assert_allclose(f32(ours), f32(theirs), rtol=tol, atol=tol, err_msg=what)


def cfgs(**kw):
    return dataclasses.replace(JARCHS[ARCH].reduced(), **kw), dataclasses.replace(get_arch(ARCH).reduced(), **kw)


def reference_params(seed: int = 3):
    jcfg, cfg = cfgs()
    jp = JM.moe_init(jax.random.PRNGKey(seed), jcfg)
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def cast(tp, dtype):
    return jax.tree.map(lambda t: t.to(dtype), tp)


def jax_top_e(jp, x, cfg):
    logits = (x @ jp["router"].astype(x.dtype)).astype(jnp.float32)
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.moe_top_k)[1])


def numpy_drops(top_e: np.ndarray, cfg, chunk: int = 1024) -> int:
    """Pairs past capacity, per row and per chunk, counted with numpy."""
    B, S, k = top_e.shape
    if S > chunk and S % chunk == 0:
        top_e, S = top_e.reshape(B * (S // chunk), chunk, k), chunk
    cap = JM.expert_capacity(S, cfg)
    counts = np.stack([np.bincount(row.ravel(), minlength=cfg.n_experts) for row in top_e])
    return int(np.maximum(counts - cap, 0).sum())


def inputs(case: str, d: int, seed: int = 1):
    """x of each case, at the RMS of about 1 that the block's rmsnorm gives
    the layer: ``drops`` leans every token towards one direction, so a few
    experts take most pairs past capacity; ``s2048`` runs two
    1024-token chunks; ``s1`` is one token a row, as in decode."""
    r = np.random.default_rng(seed)
    S = {"s40": 40, "drops": 64, "s2048": 2048, "s1": 1}[case]
    x = r.standard_normal((2, S, d)).astype(np.float32)
    if case == "drops":
        x = 0.3 * x + r.standard_normal(d).astype(np.float32)
    return x


def test_moe_init_keys_and_shapes_match_reference():
    jcfg, cfg = cfgs()
    want = JM.moe_init(jax.random.PRNGKey(0), jcfg)
    got = M.moe_init(torch.Generator().manual_seed(0), cfg)
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(got) == shapes(want)
    assert got["shared"]["up"].shape == (cfg.d_model, cfg.expert_d_ff * cfg.n_shared_experts)
    d, f = cfg.d_model, cfg.expert_d_ff  # the reference's scales: 1/sqrt(fan in)
    full = M.moe_init(torch.Generator().manual_seed(1), dataclasses.replace(cfg, n_experts=64))
    for w, fan in ((full["experts"]["up"], d), (full["experts"]["down"], f), (full["router"], d)):
        assert abs(float(w.std()) * np.sqrt(fan) - 1.0) < 0.05
    assert "shared" not in M.moe_init(torch.Generator().manual_seed(0), dataclasses.replace(cfg, n_shared_experts=0))


def test_expert_capacity_matches_reference():
    jcfg, cfg = cfgs()
    full_j, full_t = JARCHS[ARCH], get_arch(ARCH)
    for n in (1, 7, 40, 64, 512, 1024, 4096):
        assert M.expert_capacity(n, cfg) == JM.expert_capacity(n, jcfg)
        assert M.expert_capacity(n, full_t) == JM.expert_capacity(n, full_j)
    assert M.expert_capacity(1, full_t) == 8 and M.expert_capacity(512, full_t) == 64


@pytest.mark.parametrize("case", ["s40", "drops", "s2048", "s1"])
@pytest.mark.parametrize("dtype", sorted(DT))
def test_moe_apply_matches_reference(dtype, case):
    """(y, aux) of moe_apply, with the same experts picked: the
    ``drops`` case drops pairs (counted > 0 at the default capacity
    factor, the same count as the reference's top_e gives), ``s2048`` runs
    the 1024-token chunk loop, ``s1`` the decode shape."""
    jdt, tdt, tol, aux_tol = DT[dtype]
    jcfg, cfg = cfgs()
    jp, tp = reference_params()
    x = inputs(case, cfg.d_model)
    xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    yj, aj = jax.jit(JM.moe_apply, static_argnums=2)(jp, xj, jcfg)
    pt = cast(tp, tdt)
    yt, at = M.moe_apply(pt, xt, cfg)
    assert yt.dtype == tdt and yt.shape == x.shape and at.dtype == torch.float32 and at.dim() == 0
    _probs, _w, te = M.route(pt, xt, cfg)
    want_e = jax_top_e(jp, xj, jcfg)
    np.testing.assert_array_equal(te.numpy(), want_e)
    drops = int(M.dropped_pairs(te, cfg))
    assert drops == numpy_drops(want_e, jcfg)
    if case == "drops":
        assert drops > 0
    close(yt, yj, tol, "y")
    np.testing.assert_allclose(float(at), float(aj), rtol=aux_tol, atol=aux_tol)


@pytest.mark.parametrize("dtype", sorted(DT))
def test_route_puts_the_lower_expert_first_among_equal_probabilities(dtype):
    """Experts 2 and 5 have the same router column, so their logits and
    probabilities are equal in every token, and only expert 0 ranks above
    them: the tie sits at the k-th place (k = 2). The reference's top_k
    keeps the lower index, expert 2; so does the port's stable sort."""
    jdt, tdt, _tol, _a = DT[dtype]
    jcfg, cfg = cfgs()
    jp, tp = reference_params()
    r = np.random.default_rng(4)
    u = r.standard_normal(cfg.d_model).astype(np.float32)
    u /= np.linalg.norm(u)
    router = (0.05 * r.standard_normal((cfg.d_model, cfg.n_experts))).astype(np.float32)
    router[:, 2] = router[:, 5] = u
    router[:, 0] = 2 * u
    jp = {**jp, "router": jnp.asarray(router)}
    tp = {**tp, "router": torch.from_numpy(router)}
    x = (3 * u + 0.1 * r.standard_normal((2, 16, cfg.d_model))).astype(np.float32)
    probs, top_w, te = M.route(cast(tp, tdt), torch.from_numpy(x).to(tdt), cfg)
    assert bool((probs[..., 2] == probs[..., 5]).all())
    want = jax_top_e(jp, jnp.asarray(x, jdt), jcfg)
    np.testing.assert_array_equal(te.numpy(), want)
    assert (want == [0, 2]).all()
    close(top_w.sum(-1), np.ones((2, 16)), 1e-6)


@pytest.mark.parametrize("dtype", sorted(DT))
def test_dispatch_combines_bit_for_bit_in_ascending_expert_order(dtype):
    """The dispatch on inputs whose every product is exact (small
    integers, relu2) and with pairs dropped: only the combine's k weighted
    adds round, so the port equals the reference's scatter-add bit for
    bit, which adds a token's outputs in ascending expert id."""
    jdt, tdt, _tol, _a = DT[dtype]
    jcfg, cfg = cfgs(act="relu2", moe_top_k=4)
    r = np.random.default_rng(0)
    B, S, d, E, f = 2, 64, cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    x = r.integers(-2, 3, (B, S, d)).astype(np.float32)
    wg, wu = (r.integers(-1, 2, (E, d, f)).astype(np.float32) for _ in range(2))
    wd = (r.integers(-3, 4, (E, f, d)) * 0.37).astype(np.float32)
    skew = np.array([8, 8, 1, 1, 1, 1, 1, 1], np.float64)  # experts 0 and 1 overflow
    te = np.stack([r.choice(E, 4, replace=False, p=skew / skew.sum()) for _ in range(B * S)]).reshape(B, S, 4)
    tw = r.random((B, S, 4)).astype(np.float32)
    tw /= tw.sum(-1, keepdims=True)
    assert numpy_drops(te, jcfg) > 0
    want = JM._dispatch_ffn(jnp.asarray(x, jdt), jnp.asarray(te), jnp.asarray(tw),
                            *(jnp.asarray(a, jdt) for a in (wg, wu, wd)), jcfg, 0, E)
    got = M._dispatch_ffn(torch.from_numpy(x).to(tdt), torch.from_numpy(te), torch.from_numpy(tw),
                          *(torch.from_numpy(a).to(tdt) for a in (wg, wu, wd)), cfg)
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize("case", ["drops", "s2048"])
def test_moe_gradients_match_jax_grad(case):
    """Gradients of sum(y · R) + 0.7·aux (f32) into x and every parameter
    against jax.grad of the reference: none reaches a dropped pair, the
    router's comes through the kept weights and mean(probs). Each leaf
    within 1e-4 of its largest value."""
    jcfg, cfg = cfgs()
    jp, tp = reference_params()
    x = inputs(case, cfg.d_model)
    R = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = JM.moe_apply(p, xx, jcfg)
        return jnp.sum(y * R) + 0.7 * aux

    gp, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = jax.tree.map(lambda t: t.clone().requires_grad_(), tp)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = M.moe_apply(leaves, xt, cfg)
    ((y * torch.from_numpy(R)).sum() + 0.7 * aux).backward()
    if case == "drops":
        assert int(M.dropped_pairs(M.route(tp, torch.from_numpy(x), cfg)[2], cfg)) > 0
    pairs = [(xt.grad, gx, "x")] + [(a.grad, b, str(k)) for (k, a), b in zip(
        jax.tree_util.tree_flatten_with_path(leaves)[0], jax.tree.leaves(gp))]
    for ours, theirs, what in pairs:
        theirs = np.asarray(theirs)
        assert ours is not None, what
        err = float(np.abs(f32(ours) - theirs).max())
        assert err <= 1e-4 * float(np.abs(theirs).max()), (what, err)


def test_moe_module_keeps_its_casts_and_names():
    """MoE holds the parameters under the reference's keys; under no_grad
    each matrix's compute-dtype copy is made once, in grad mode afresh."""
    _jcfg, cfg = cfgs()
    mod = M.MoE(M.moe_init(torch.Generator().manual_seed(0), cfg))
    assert sorted(n for n, _ in mod.named_parameters()) == [
        "experts.down", "experts.gate", "experts.up", "router", "shared.down", "shared.gate", "shared.up"]
    with torch.no_grad():
        a = mod.params(torch.bfloat16)
        b = mod.params(torch.bfloat16)
        assert a["router"] is b["router"] and a["experts"]["up"] is b["experts"]["up"]
        assert mod.params(torch.float32)["router"] is mod.router
    assert mod.params(torch.bfloat16)["router"].requires_grad


def test_dropped_pairs_counts_each_chunk_and_row():
    """dropped_pairs counts per row and per 1024-token chunk, as the
    dispatch drops them: all pairs of a chunk on one expert keep cap."""
    _jcfg, cfg = cfgs()
    te = torch.zeros((2, 2048, cfg.moe_top_k), dtype=torch.int64)
    te[..., 1] = 1
    cap = M.expert_capacity(1024, cfg)
    assert int(M.dropped_pairs(te, cfg)) == 2 * 2 * 2 * (1024 - cap)
    assert int(M.dropped_pairs(te[:, :40], cfg)) == 2 * 2 * (40 - M.expert_capacity(40, cfg))
    assert int(M.dropped_pairs(te[:, :1], cfg)) == 0
