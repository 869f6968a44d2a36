"""The port's attention stack (``repro_torch.models.layers``) against the JAX
package's ``repro.models.layers`` on the CPU: RoPE, the QKV projection,
the blockwise ``causal_flash`` and its written-out backward (against
``jax.grad`` of the reference's custom VJP), ``attention_train`` with
``collect_kv``, cached ``attention_decode`` over several steps, and the
MLP in its three forms.

Inputs are made from seeds with numpy and handed to both packages.
Tolerances: f32 within 1e-4 (rtol and atol; sums in another order), bf16
within 5e-2 (bf16 rounds at other places in XLA's fused ops and in eager
torch), as tests/test_torch_lm.py has them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import layers as JL

from repro_torch.configs import get_arch
from repro_torch.models import layers as L

DT = {"f32": (jnp.float32, torch.float32, 1e-4), "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def f32(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def close(ours, theirs, tol, what=""):
    np.testing.assert_allclose(f32(ours), f32(theirs), rtol=tol, atol=tol, err_msg=what)


def cfgs(name, **kw):
    """Both packages' reduced ``name`` with the same fields replaced."""
    return dataclasses.replace(JARCHS[name].reduced(), **kw), dataclasses.replace(get_arch(name).reduced(), **kw)


def randn(r, shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dh,theta", [(16, 1e6), (80, 1e4)], ids=["dh16", "dh80"])
@pytest.mark.parametrize("dtype", sorted(DT))
def test_rope_apply_matches_reference(dtype, dh, theta):
    """Default positions (0..S-1, one row for the batch) and per-row decode
    positions up to 600; zamba2's head_dim 80."""
    jdt, tdt, tol = DT[dtype]
    r = np.random.default_rng(1)
    x = randn(r, (2, 9, 3, dh))
    for pos in (np.arange(9)[None, :], r.integers(0, 600, (2, 9))):
        want = JL.rope_apply(jnp.asarray(x, jdt), jnp.asarray(pos, jnp.int32), theta)
        got = L.rope_apply(torch.from_numpy(x).to(tdt), torch.from_numpy(pos), theta)
        assert got.dtype == tdt
        close(got, want, tol)
    np.testing.assert_allclose(L.rope_freqs(dh, theta).numpy(), np.asarray(JL.rope_freqs(dh, theta)), rtol=1e-6)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("dtype", sorted(DT))
def test_qkv_project_matches_reference(dtype, bias):
    """qwen2's biases (drawn non-zero here) and none; GQA shapes."""
    jdt, tdt, tol = DT[dtype]
    jcfg, cfg = cfgs("qwen2-1.5b", qkv_bias=bias)
    r = np.random.default_rng(2)
    p = {k: v for k, v in dict(wq=randn(r, (64, 64), 0.125), wk=randn(r, (64, 16), 0.125),
                               wv=randn(r, (64, 16), 0.125), bq=randn(r, (64,)), bk=randn(r, (16,)),
                               bv=randn(r, (16,))).items() if bias or not k.startswith("b")}
    x = randn(r, (2, 7, 64))
    want = JL.qkv_project({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x, jdt), jcfg)
    got = L.qkv_project({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x).to(tdt), cfg)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape) and a.dtype == tdt
        close(a, b, tol)


# (S, H, KV, chunk): chunks that divide S and ones that do not (the largest
# divisor below the request is taken), G = H // KV in {1, 2, 4}
FLASH_CASES = [(24, 4, 4, 8), (24, 4, 2, 8), (24, 4, 1, 8), (24, 4, 4, 7), (24, 4, 2, 10), (24, 4, 1, 5),
               (20, 4, 2, 20)]


def flash_inputs(S, H, KV, seed=3, B=2, Dh=8):
    r = np.random.default_rng(seed)
    return randn(r, (B, S, H, Dh)), randn(r, (B, S, KV, Dh)), randn(r, (B, S, KV, Dh)), randn(r, (B, S, H, Dh))


@pytest.mark.parametrize("bidirectional", [False, True], ids=["causal", "bidir"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[f"S{c[0]}H{c[1]}KV{c[2]}c{c[3]}" for c in FLASH_CASES])
def test_causal_flash_matches_reference(case, bidirectional):
    """The forward in f32 (1e-4) and bf16 (5e-2) against
    ``repro.models.layers.causal_flash``."""
    S, H, KV, chunk = case
    q, k, v, _ = flash_inputs(S, H, KV)
    for jdt, tdt, tol in DT.values():
        want = JL.causal_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)), chunk, bidirectional)
        got = L.causal_flash(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), chunk, bidirectional)
        assert got.dtype == tdt and got.shape == want.shape
        close(got, want, tol)


@pytest.mark.parametrize("bidirectional", [False, True], ids=["causal", "bidir"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[f"S{c[0]}H{c[1]}KV{c[2]}c{c[3]}" for c in FLASH_CASES])
def test_causal_flash_grads_match_jax_grad(case, bidirectional):
    """dq, dk, dv of Σ dout·out through ``CausalFlash`` against ``jax.grad``
    of the reference's custom VJP, f32, within 1e-4·max|grad| (the GQA
    groups fold into their KV head in another order)."""
    S, H, KV, chunk = case
    q, k, v, do = flash_inputs(S, H, KV, seed=4)
    want = jax.grad(lambda *a: jnp.sum(JL.causal_flash(*a, chunk, bidirectional) * do), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = L.causal_flash(*ins, chunk, bidirectional)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * torch.from_numpy(do)).sum(), ins)
    for name, a, b in zip("qkv", got, want):
        b = np.asarray(b)
        assert bool(torch.isfinite(a).all()), name
        np.testing.assert_allclose(f32(a), b, rtol=0, atol=1e-4 * np.abs(b).max(), err_msg=f"d{name}")


def test_causal_flash_bf16_grads_match_jax_grad():
    """bf16 q, k, v (the train step's activations): the gradients within
    5e-2·max|grad| of ``jax.grad``'s, in q's, k's and v's dtype."""
    q, k, v, do = flash_inputs(24, 4, 2, seed=5)
    cast = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = jax.grad(lambda *a: jnp.sum(JL.causal_flash(*a, 8, False).astype(jnp.float32) * do),
                    argnums=(0, 1, 2))(*cast)
    ins = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v)]
    out = L.causal_flash(*ins, 8, False)
    got = torch.autograd.grad((out.float() * torch.from_numpy(do)).sum(), ins)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16
        b = f32(b)
        np.testing.assert_allclose(f32(a), b, rtol=0, atol=5e-2 * np.abs(b).max(), err_msg=f"d{name}")


def test_causal_flash_keeps_large_scores_finite():
    """Scores of magnitude ~1e3 (exp overflows without the running max):
    the output and the gradients stay finite and equal the reference's."""
    q, k, v, do = flash_inputs(16, 4, 2, seed=6)
    q = q * 40.0
    want = JL.causal_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4, False)
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = L.causal_flash(*ins, 4, False)
    close(out, want, 1e-4)
    grads = torch.autograd.grad((out * torch.from_numpy(do)).sum(), ins)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-2.7b"])
@pytest.mark.parametrize("dtype", sorted(DT))
def test_attention_train_matches_reference(arch, dtype):
    """The whole attention sublayer (projections, RoPE, flash, out
    projection) with ``collect_kv``: out and the cached (k, v)."""
    jdt, tdt, tol = DT[dtype]
    jcfg, cfg = cfgs(arch)
    jp = JL.attn_init(jax.random.PRNGKey(3), jcfg)
    if cfg.qkv_bias:  # non-zero biases, so the test sees them
        r = np.random.default_rng(7)
        jp = {k: (jnp.asarray(randn(r, v.shape)) if k.startswith("b") else v) for k, v in jp.items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = randn(np.random.default_rng(8), (2, 20, cfg.d_model))
    want, (wk, wv) = JL.attention_train(jp, jnp.asarray(x, jdt), jcfg, chunk=8, collect_kv=True)
    got, (gk, gv) = L.attention_train(tp, torch.from_numpy(x).to(tdt), cfg, chunk=8, collect_kv=True)
    for a, b, what in ((got, want, "out"), (gk, wk, "k"), (gv, wv, "v")):
        assert tuple(a.shape) == tuple(b.shape) and a.dtype == tdt, what
        close(a, b, tol, what)
    assert isinstance(L.attention_train(tp, torch.from_numpy(x), cfg, chunk=8), torch.Tensor)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-2.7b"])
@pytest.mark.parametrize("dtype", sorted(DT))
def test_attention_decode_matches_reference(arch, dtype):
    """Five steps against a cache prefilled with 6 tokens (12 slots): out
    and the cache at every step. The port writes the new K and V into the
    cache it is given; the reference returns a new one."""
    jdt, tdt, tol = DT[dtype]
    jcfg, cfg = cfgs(arch)
    jp = JL.attn_init(jax.random.PRNGKey(4), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    r = np.random.default_rng(9)
    shape = (2, 12, cfg.n_kv_heads, cfg.head_dim)
    ck0 = np.zeros(shape, np.float32)
    cv0 = np.zeros(shape, np.float32)
    ck0[:, :6], cv0[:, :6] = randn(r, (2, 6) + shape[2:]), randn(r, (2, 6) + shape[2:])
    jk, jv = jnp.asarray(ck0, jdt), jnp.asarray(cv0, jdt)
    tk, tv = torch.from_numpy(ck0).to(tdt), torch.from_numpy(cv0).to(tdt)
    ptr = tk.data_ptr()
    for t in range(5):
        x = randn(r, (2, 1, cfg.d_model))
        want, jk, jv = JL.attention_decode(jp, jnp.asarray(x, jdt), jk, jv, jnp.int32(6 + t), jcfg)
        got, tk2, tv2 = L.attention_decode(tp, torch.from_numpy(x).to(tdt), tk, tv, 6 + t, cfg)
        assert tk2 is tk and tv2 is tv and tk.data_ptr() == ptr
        close(got, want, tol, f"out, step {t}")
        close(tk, jk, tol, f"k cache, step {t}")
        close(tv, jv, tol, f"v cache, step {t}")


MLP_CASES = [("silu", True), ("gelu", True), ("relu2", False)]


@pytest.mark.parametrize("act,gated", MLP_CASES, ids=[f"{a}-{'gated' if g else 'plain'}" for a, g in MLP_CASES])
@pytest.mark.parametrize("dtype", sorted(DT))
def test_mlp_apply_matches_reference(dtype, act, gated):
    """silu gated (qwen2, yi, zamba2), gelu gated (the tanh form, JAX's
    default) and relu2 non-gated (minitron-8b)."""
    jdt, tdt, tol = DT[dtype]
    jp = JL.mlp_init(jax.random.PRNGKey(5), 32, 48, gated)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert sorted(tp) == sorted(L.mlp_init(torch.Generator().manual_seed(0), 32, 48, gated))
    x = randn(np.random.default_rng(10), (2, 5, 32), 2.0)
    want = JL.mlp_apply(jp, jnp.asarray(x, jdt), act, gated)
    got = L.mlp_apply(tp, torch.from_numpy(x).to(tdt), act, gated)
    assert got.dtype == tdt
    close(got, want, tol)


def test_attn_init_keys_and_shapes_match_reference():
    for arch in ("qwen2-1.5b", "yi-9b", "zamba2-2.7b"):
        jcfg, cfg = cfgs(arch)
        want = JL.attn_init(jax.random.PRNGKey(0), jcfg)
        got = L.attn_init(torch.Generator().manual_seed(0), cfg)
        assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in want.items()}
        assert all(not bool(v.any()) for k, v in got.items() if k.startswith("b"))


def test_pick_chunk_matches_reference():
    for S in (1, 7, 24, 160, 512):
        for c in (1, 5, 8, 64, 1024):
            assert L._pick_chunk(S, c) == JL._pick_chunk(S, c)
