"""The port's LMs against the JAX package's, with the JAX package's weights
carried across by ``convert.lm_params_from_reference``: the Mamba2 LM
(``mamba2-370m`` reduced: 2 layers, d_model 64, N 16, chunk 16), and the
dense (qwen2-1.5b, yi-9b, yi-34b, minitron-8b), moe (deepseek-moe-16b,
moonshot-v1-16b-a3b: 8 experts of d_ff 32, top-2, one shared) and hybrid
(zamba2-2.7b) families at ``ArchConfig.reduced()`` (2 layers, d_model 64,
4 heads of 16; zamba2 one group of 2 Mamba2 layers and the shared block).

Tolerances: f32 rtol = atol = 1e-4 (sums in another order); bf16 5e-2,
because bf16 rounds at other places in XLA's fused conv sum and in eager
torch, and the kernel path rounds the intra-chunk SSD term before adding
the state term; the step-by-step-decode duality check 2e-2, as in
tests/test_arch_smoke.py. The moe family's aux loss within 1e-5 in f32
and 1e-3 in bf16.

The moe family is compared with the reference's routing recorded
(``reference_routing``, the reference run eagerly) and replayed in the
port (``moe_cases.replayed``): in f32 every routing decision must agree;
in bf16 a token whose k-th and (k+1)-th router logits lie closer than the
two packages' bf16 logits differ may go to other experts, and
``replayed`` checks that each such difference is a near tie before it
routes the port as the reference did."""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import cells as jax_cells
from repro.models import lm as JLM
from repro.models import moe as JMOE
from repro.models import ssm as JSSM

from repro_torch.configs import ARCHS, SHAPES, cells, get_arch
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import lm
from repro_torch.models import ssm as S

from moe_cases import dropped_share, replayed

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


# ------------------------------------------ the dense, moe and hybrid families
FAMILY_ARCHS = ["qwen2-1.5b", "yi-9b", "yi-34b", "minitron-8b", "deepseek-moe-16b", "zamba2-2.7b"]
MOE_AUX_TOL = {"f32": 1e-5, "bf16": 1e-3}


@functools.cache
def family_models(arch: str):
    """Both packages' reduced ``arch`` with the same weights (JAX's init;
    qwen2's zero QKV biases redrawn so the tests see them) and the jitted
    reference entry points."""
    jcfg, cfg = JARCHS[arch].reduced(), get_arch(arch).reduced()
    params = JLM.init_params(jax.random.PRNGKey(7), jcfg)
    if jcfg.qkv_bias:
        r = np.random.default_rng(1)
        params = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.asarray(r.standard_normal(a.shape).astype(np.float32) * 0.5)
            if str(path[-1].key).startswith("b") else a, params)
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    fns = {"forward": jax.jit(JLM.forward, static_argnums=(1,), static_argnames=("remat", "chunk", "dtype")),
           "prefill": jax.jit(JLM.prefill, static_argnums=(1, 3), static_argnames=("chunk", "dtype")),
           "decode": jax.jit(JLM.decode_step, static_argnums=(1,), static_argnames=("dtype",))}
    return jcfg, params, cfg, model, fns


@contextlib.contextmanager
def reference_routing(cfg, dtype: str):
    """For a moe ``cfg``: inside the block the reference runs eagerly and
    records each ``moe_apply`` call's router logits and experts, and the
    port's calls, in the same order, replay them (``moe_cases.replayed``);
    on leaving, in f32 every decision must have agreed. Yields (log,
    stats); for the other families it changes nothing and yields (None,
    None)."""
    if cfg.family != "moe":
        yield None, None
        return
    log, stats = [], {}
    orig = JMOE.moe_apply

    def rec(p, x, c):
        logits = (x @ p["router"].astype(x.dtype)).astype(jnp.float32)
        e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), c.moe_top_k)[1]
        log.append((torch.from_numpy(np.array(logits)), torch.from_numpy(np.array(e)).long()))
        return orig(p, x, c)

    JMOE.moe_apply = rec  # the reference's lm looks moe_apply up in its module at each call
    try:
        with jax.disable_jit(), replayed(log, stats):
            yield log, stats
    finally:
        JMOE.moe_apply = orig
    if dtype == "f32":
        assert stats["agreed"] == stats["decisions"], stats


def forward_matches(arch: str, dtype: str) -> None:
    """Training-forward logits of 2 x 40 tokens with an attention chunk of
    16 (a ragged block split: 10 of 40); the moe family's aux (the sum of
    its layers') too, with pairs dropped at the default capacity factor."""
    jcfg, params, cfg, model, fns = family_models(arch)
    jdt, tdt, tol = DT[dtype]
    toks = tokens(cfg, (2, 40), seed=8)
    with reference_routing(cfg, dtype) as (log, _stats):
        lj, aj = fns["forward"](params, jcfg, jnp.asarray(toks), remat=False, chunk=16, dtype=jdt)
        with torch.no_grad():
            lt, aux = lm.forward(model, cfg, torch.from_numpy(toks).long(), chunk=16, dtype=tdt)
    assert lt.shape == (2, 40, cfg.vocab) and lt.dtype == tdt
    close(lt, lj, tol)
    if cfg.family == "moe":
        assert len(log) == cfg.n_layers and dropped_share(log, cfg) > 0
        assert aux.dtype == torch.float32 and aux.dim() == 0
        np.testing.assert_allclose(float(aux), float(aj), rtol=MOE_AUX_TOL[dtype], atol=MOE_AUX_TOL[dtype])
    else:
        assert aux == 0.0


def test_family_models_match_reference_layout():
    """Every family's state_dict names map one to one onto the JAX
    package's leaves: qwen2 tied with biases, yi and minitron untied,
    minitron's non-gated MLP, deepseek's experts, router and shared expert
    under ``layers.<i>.moe``, zamba2's (groups, attn_every) layers and its
    shared block."""
    for arch in FAMILY_ARCHS:
        jcfg, params, cfg, model, _ = family_models(arch)
        sd = model.state_dict()
        n_leaves = sum(int(np.prod(np.asarray(a).shape)) for a in jax.tree.leaves(params))
        assert sum(v.numel() for v in sd.values()) == n_leaves, arch
        assert ("lm_head" in sd) == (not cfg.tie_embeddings)
        assert ("layers.0.mlp.gate" in sd) == (cfg.family == "dense" and cfg.gated_mlp)
    _, _, zcfg, zmodel, _ = family_models("zamba2-2.7b")
    assert isinstance(zmodel, lm.HybridLM) and len(zmodel.layers) == 1 and len(zmodel.layers[0]) == 2
    assert "layers.0.1.ssm.in_x" in zmodel.state_dict() and "shared_attn.mlp.gate" in zmodel.state_dict()
    assert isinstance(family_models("qwen2-1.5b")[3], lm.DenseLM)
    _, mparams, mcfg, mmodel, _ = family_models("deepseek-moe-16b")
    msd = mmodel.state_dict()
    assert isinstance(mmodel, lm.MoELM) and isinstance(mmodel.layers[1], lm.MoEBlock)
    for key in ("experts.up", "experts.gate", "experts.down", "router", "shared.up", "shared.gate", "shared.down"):
        leaf = functools.reduce(lambda d, k: d[k], key.split("."), mparams["layers"]["moe"])
        assert tuple(msd[f"layers.1.moe.{key}"].shape) == tuple(leaf.shape[1:]), key
    assert tuple(msd["layers.0.moe.experts.up"].shape) == (mcfg.n_experts, mcfg.d_model, mcfg.expert_d_ff)


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_forward_matches_reference(arch, dtype):
    """``forward_matches`` for every family of the port."""
    forward_matches(arch, dtype)


def test_moonshot_forward_matches_reference():
    """moonshot-v1-16b-a3b: its reduced cut differs from deepseek's only in
    RoPE's theta (and the vocab of the full model); ``forward_matches`` in
    f32."""
    assert dataclasses.replace(get_arch("moonshot-v1-16b-a3b").reduced(), rope_theta=1.0, name="") == \
        dataclasses.replace(get_arch("deepseek-moe-16b").reduced(), rope_theta=1.0, name="")
    forward_matches("moonshot-v1-16b-a3b", "f32")


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_prefill_and_decode_match_reference(arch, dtype):
    """Prefill of 2 x 40 tokens into 48 slots: the last-token logits and
    the whole cache (K and V padded to 48 slots; the hybrid's stacked SSM
    states); then four decode steps' logits and caches."""
    jcfg, params, cfg, model, fns = family_models(arch)
    jdt, tdt, tol = DT[dtype]
    toks = tokens(cfg, (2, 40), seed=5)

    def same_cache(ct, cj, what):
        assert sorted(ct) == sorted(cj), what
        for key in ct:
            if key == "ssm":
                close_state(ct["ssm"], cj["ssm"], tol)
            else:
                assert tuple(ct[key].shape) == tuple(cj[key].shape) and ct[key].dtype == tdt, key
                close(ct[key], cj[key], tol)

    with reference_routing(cfg, dtype):
        lj, cj = fns["prefill"](params, jcfg, jnp.asarray(toks), 48, chunk=16, dtype=jdt)
        lt, ct = lm.prefill(model, cfg, torch.from_numpy(toks).long(), 48, chunk=16, dtype=tdt)
        assert lt.shape == (2, 1, cfg.vocab) and lt.dtype == tdt
        close(lt, lj, tol)
        same_cache(ct, cj, "prefill")
        nxt = tokens(cfg, (2, 4), seed=6)
        for t in range(4):
            lj, cj = fns["decode"](params, jcfg, jnp.asarray(nxt[:, t : t + 1]), cj, jnp.int32(40 + t), dtype=jdt)
            lt, ct2 = lm.decode_step(model, cfg, torch.from_numpy(nxt[:, t : t + 1]).long(), ct, 40 + t, dtype=tdt)
            assert ct2 is ct
            close(lt, lj, tol)
            same_cache(ct, cj, f"decode step {t}")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_decode_matches_forward(arch):
    """The duality, port only, f32: step-by-step decode from an empty cache
    gives the training forward's logits (chunk 8: 3 KV blocks of 24
    tokens), and a chunked prefill the cache the steps built, within 2e-2
    as tests/test_arch_smoke.py holds the reference. The moe family runs
    at ``capacity_factor = n_experts / moe_top_k``, whose capacity (>= S)
    drops no pair: at the default factor a prefill of S tokens may drop
    pairs that one-token decode steps (capacity 8) keep, so the two differ
    by the reference's own contract."""
    _, _, cfg, model, _ = family_models(arch)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
    T = 24
    toks = torch.from_numpy(tokens(cfg, (2, T), seed=9)).long()
    with torch.no_grad():
        full, _ = lm.forward(model, cfg, toks, chunk=8, dtype=torch.float32)
    cache = lm.init_cache(cfg, batch=2, max_len=T, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(T):
        lg, cache = lm.decode_step(model, cfg, toks[:, t : t + 1], cache, t, dtype=torch.float32)
        outs.append(lg[:, 0])
    close(torch.stack(outs, dim=1), full, 2e-2)
    _, pre = lm.prefill(model, cfg, toks, T, chunk=8, dtype=torch.float32)
    for key in ("k", "v"):
        close(cache[key], pre[key], 2e-2)
    if "ssm" in pre:
        close_state(cache["ssm"], pre["ssm"], 2e-2)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_init_cache_matches_reference(arch):
    """init_cache: the same keys, shapes and dtypes as the JAX package's
    (bf16 K and V, f32 SSM states), all zeros, on the CPU when asked."""
    jcfg, _, cfg, _, _ = family_models(arch)
    ours = lm.init_cache(cfg, batch=3, max_len=20, device="cpu")
    theirs = JLM.init_cache(jcfg, batch=3, max_len=20)
    assert sorted(ours) == sorted(theirs)
    for key in ("k", "v"):
        assert tuple(ours[key].shape) == tuple(theirs[key].shape) and ours[key].dtype == torch.bfloat16
        assert not bool(ours[key].any())
    if "ssm" in ours:
        close_state(ours["ssm"], theirs["ssm"], 0)
        assert all(v.dtype == torch.float32 for v in ours["ssm"].values())


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-moe-16b", "zamba2-2.7b"])
def test_family_decode_step_writes_the_cache_in_place(arch):
    """decode_step writes the new K and V at cur_index (and the hybrid's
    new states) into the cache it is given and returns that cache; no slot
    but cur_index changes."""
    _, _, cfg, model, _ = family_models(arch)
    cache = lm.init_cache(cfg, batch=2, max_len=6, device="cpu")
    ptrs = {k: v.data_ptr() for k, v in cache.items() if k != "ssm"}
    toks = torch.from_numpy(tokens(cfg, (2, 1), seed=12)).long()
    _, out = lm.decode_step(model, cfg, toks, cache, 3)
    assert out is cache and {k: out[k].data_ptr() for k in ptrs} == ptrs
    for key in ("k", "v"):
        written = out[key].abs().sum(dim=(0, 1, 3, 4))
        assert bool(written[3] > 0) and not bool(written[[0, 1, 2, 4, 5]].any()), key
    if "ssm" in out:
        assert all(bool(v.abs().sum() > 0) for v in out["ssm"].values())
