"""The port's Mamba2 LM (``mamba2-370m`` reduced: 2 layers, d_model 64,
N 16, chunk 16) against the JAX package's, with the JAX package's weights
carried across by ``convert.lm_params_from_reference``.

Tolerances: f32 rtol = atol = 1e-4 (sums in another order); bf16 5e-2,
because bf16 rounds at other places in XLA's fused conv sum and in eager
torch, and the kernel path rounds the intra-chunk SSD term before adding
the state term; the step-by-step-decode duality check 2e-2, as in
tests/test_arch_smoke.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import cells as jax_cells
from repro.models import lm as JLM
from repro.models import ssm as JSSM

from repro_torch.configs import ARCHS, SHAPES, cells, get_arch
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import lm
from repro_torch.models import ssm as S

DT = {"f32": (jnp.float32, torch.float32, 1e-4), "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


@pytest.fixture(scope="module")
def models():
    jcfg = JARCHS["mamba2-370m"].reduced()
    cfg = get_arch("mamba2-370m").reduced()
    params = JLM.init_params(jax.random.PRNGKey(7), jcfg)
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    return jcfg, params, cfg, model


def f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def close(ours, theirs, tol):
    np.testing.assert_allclose(f32(ours), f32(theirs), rtol=tol, atol=tol)


def close_state(ours: dict, theirs: dict, tol):
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert tuple(ours[k].shape) == tuple(theirs[k].shape), k
        close(ours[k], theirs[k], tol)


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def test_configs_equal_reference():
    assert sorted(ARCHS) == sorted(JARCHS)
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JARCHS[name]), name
        assert cfg.n_params() == JARCHS[name].n_params()
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(JARCHS[name].reduced())
    for skipped in (False, True):
        ours = [(a.name, s.name, k) for a, s, k in cells(include_skipped=skipped)]
        assert ours == [(a.name, s.name, k) for a, s, k in jax_cells(include_skipped=skipped)]
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    full = get_arch("mamba2-370m")
    assert (full.n_layers, full.d_model, full.ssm_heads, full.ssm_state, full.vocab) == (48, 1024, 32, 128, 50280)


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
@pytest.mark.parametrize("dtype", sorted(DT))
def test_ssm_forward_matches_reference(models, dtype, with_state):
    jcfg, params, cfg, model = models
    jdt, tdt, tol = DT[dtype]
    rng = np.random.default_rng(3)
    xin = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        st = S.ssm_init_state(cfg, 2, device="cpu")
        state = {k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32) for k, v in st.items()}
    jp = jax.tree.map(lambda a: a[0], params["layers"]["ssm"])
    jst = None if state is None else {k: jnp.asarray(v) for k, v in state.items()}
    out_j, new_j = JSSM.ssm_forward(jp, jnp.asarray(xin, jdt), jcfg, jst)
    tst = None if state is None else {k: torch.from_numpy(v) for k, v in state.items()}
    with torch.no_grad():
        out_t, new_t = S.ssm_forward(model.layers[0].ssm.params(tdt), torch.from_numpy(xin).to(tdt), cfg, tst)
    assert out_t.dtype == tdt
    close(out_t, out_j, tol)
    close_state(new_t, new_j, tol)


@pytest.mark.parametrize("dtype", sorted(DT))
def test_prefill_and_decode_match_reference(models, dtype):
    """Prefill logits and every layer's states, then four decode steps'
    logits and states."""
    jcfg, params, cfg, model = models
    jdt, tdt, tol = DT[dtype]
    toks = tokens(cfg, (2, 40), seed=5)
    lj, cj = JLM.prefill(params, jcfg, jnp.asarray(toks), 48, dtype=jdt)
    lt, ct = lm.prefill(model, cfg, torch.from_numpy(toks).long(), 48, dtype=tdt)
    assert lt.shape == (2, 1, cfg.vocab) and lt.dtype == tdt
    close(lt, lj, tol)
    close_state(ct["ssm"], cj["ssm"], tol)
    nxt = tokens(cfg, (2, 4), seed=6)
    for t in range(4):
        lj, cj = JLM.decode_step(params, jcfg, jnp.asarray(nxt[:, t : t + 1]), cj, jnp.int32(40 + t), dtype=jdt)
        lt, ct = lm.decode_step(model, cfg, torch.from_numpy(nxt[:, t : t + 1]).long(), ct, 40 + t, dtype=tdt)
        close(lt, lj, tol)
        close_state(ct["ssm"], cj["ssm"], tol)


def test_forward_and_init_cache_match_reference(models):
    jcfg, params, cfg, model = models
    toks = tokens(cfg, (2, 24), seed=8)
    lj, _ = JLM.forward(params, jcfg, jnp.asarray(toks), remat=False, dtype=jnp.float32)
    with torch.no_grad():
        lt, aux = lm.forward(model, cfg, torch.from_numpy(toks).long(), dtype=torch.float32)
    assert aux == 0.0
    close(lt, lj, 1e-4)
    cache_t = lm.init_cache(cfg, batch=2, max_len=32, device="cpu")
    cache_j = JLM.init_cache(jcfg, batch=2, max_len=32)
    close_state(cache_t["ssm"], cache_j["ssm"], 0)
    assert all(v.dtype == torch.float32 for v in cache_t["ssm"].values())


def test_ssm_decode_matches_forward(models):
    """SSD chunked forward and step-by-step decode agree (the duality),
    port only, f32."""
    _, _, cfg, model = models
    T = 24
    toks = torch.from_numpy(tokens(cfg, (1, T), seed=9)).long()
    with torch.no_grad():
        full, _ = lm.forward(model, cfg, toks, dtype=torch.float32)
    cache = lm.init_cache(cfg, batch=1, max_len=T, device="cpu")
    outs = []
    for t in range(T):
        lg, cache = lm.decode_step(model, cfg, toks[:, t : t + 1], cache, t, dtype=torch.float32)
        outs.append(lg[:, 0])
    close(torch.stack(outs, dim=1), full, 2e-2)


def test_decode_step_updates_the_cache_in_place(models):
    """decode_step writes every layer's new state into the cache it is given
    and returns that cache."""
    _, _, cfg, model = models
    cache = lm.init_cache(cfg, batch=2, max_len=4, device="cpu")
    ptrs = {k: v.data_ptr() for k, v in cache["ssm"].items()}
    toks = torch.from_numpy(tokens(cfg, (2, 1), seed=12)).long()
    _, out = lm.decode_step(model, cfg, toks, cache, 0, dtype=torch.float32)
    assert out is cache
    assert {k: v.data_ptr() for k, v in out["ssm"].items()} == ptrs
    assert all(bool(v.abs().sum() > 0) for v in out["ssm"].values())


def test_ssm_init_state_defaults_to_the_card(monkeypatch):
    """ssm_init_state builds on the CPU only when asked; its default, the
    card, raises when torch.cuda.is_available() is False."""
    cfg = get_arch("mamba2-370m").reduced()
    st = S.ssm_init_state(cfg, 2, device="cpu")
    assert all(v.device.type == "cpu" and not bool(v.any()) for v in st.values())
    assert st["ssm"].shape == (2, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        S.ssm_init_state(cfg, 2)


def test_entry_points_default_to_the_card():
    """init_params and init_cache build on cuda unless the caller asks for the
    CPU: without a card they raise rather than run the plain versions; a
    generator on another device than the weights is refused."""
    cfg = get_arch("mamba2-370m").reduced()
    gen = torch.Generator().manual_seed(0)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="generator lives on"):
            lm.init_params(gen, cfg)
        assert lm.init_cache(cfg, batch=1, max_len=8)["ssm"]["ssm"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            lm.init_params(gen, cfg)
        with pytest.raises(RuntimeError, match="is_available"):
            lm.init_cache(cfg, batch=1, max_len=8)
    assert lm.init_params(gen, cfg, device="cpu").embed.device.type == "cpu"


def test_forward_is_differentiable_on_cpu(models):
    _, _, cfg, model = models
    toks = torch.from_numpy(tokens(cfg, (1, 20), seed=10)).long()
    logits, _ = lm.forward(model, cfg, toks, dtype=torch.float32)
    logits.float().square().mean().backward()
    g = model.layers[0].ssm.in_x.grad
    assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0
    model.zero_grad(set_to_none=True)


def test_weight_casts_are_kept_and_refreshed(models):
    """With grad off, a layer's bf16 matrices are made once; an in-place
    change to a parameter makes a fresh copy with the new values."""
    _, _, _, model = models
    mixer = model.layers[1].ssm
    with torch.no_grad():
        a = mixer.params(torch.bfloat16)["in_x"]
        assert mixer.params(torch.bfloat16)["in_x"] is a
        assert torch.equal(a, mixer.in_x.to(torch.bfloat16))
        assert mixer.params(torch.float32)["in_x"] is mixer.in_x
        old = mixer.in_x.clone()
        mixer.in_x.mul_(2.0)
        b = mixer.params(torch.bfloat16)["in_x"]
        assert b is not a and torch.equal(b, mixer.in_x.to(torch.bfloat16))
        mixer.in_x.copy_(old)
    assert mixer.params(torch.bfloat16)["in_x"].requires_grad  # grad mode: a fresh, tracked cast


@pytest.mark.parametrize("arch", sorted(a for a, c in ARCHS.items() if c.family != "ssm"))
def test_other_families_raise(arch):
    cfg = ARCHS[arch].reduced()
    with pytest.raises(NotImplementedError, match="slice 6b"):
        lm.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(NotImplementedError, match="slice 6b"):
        lm.init_cache(cfg, batch=1, max_len=8)
    with pytest.raises(NotImplementedError, match="slice 6b"):
        lm_params_from_reference(cfg, {})
