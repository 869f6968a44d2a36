"""The port's serving path (``prompts_from_store`` -> ``ServingEngine``)
against the JAX package's on the same SageFile and the same weights
(``mamba2-370m`` reduced, and qwen2-1.5b and zamba2-2.7b reduced for the
dense and hybrid families; JAX weights carried across by ``convert``).

Teacher-forced logits (both models fed the JAX engine's tokens) agree
within 5e-2 at every step. Greedy tokens are compared step for step, per
prompt, for as long as the JAX model's top-2 margin exceeds twice the
logit difference between the two models: past that, bf16 rounding at other
places may rightly pick the other token."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.core import SageStore as RefStore
from repro.core.encoder import SageEncoder as RefEncoder
from repro.genomics.synth import ReadSet, make_reference
from repro.models import lm as JLM
from repro.serving.engine import ServeConfig as RefServeConfig
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.engine import prompts_from_store as ref_prompts

from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_reference, sage_file_from_reference
from repro_torch.core import SageStore
from repro_torch.kernels import cuda_lib
from repro_torch.models import lm
from repro_torch.serving import SageServer, ServeConfig, ServingEngine, prompts_from_store

from torch_cases import encoded_case

TOL = 5e-2
VOCAB = 259  # k = 4 k-mers with their three special ids


@pytest.fixture(scope="module")
def stores():
    _, sf = encoded_case("illumina")
    ours, theirs = SageStore(device="cpu"), RefStore()
    ours.register("ds", sage_file_from_reference(sf))
    theirs.register("ds", sf)
    return ours.session(), theirs.session()


def make_models(embed_scale=1.0, arch="mamba2-370m"):
    """Both packages' reduced ``arch`` with the same weights (JAX's init,
    the embedding and an untied head scaled by ``embed_scale``)."""
    jcfg = jax_arch(arch).reduced()
    cfg = get_arch(arch).reduced()
    params = JLM.init_params(jax.random.PRNGKey(11), jcfg)
    params = {**params, **{k: params[k] * embed_scale for k in ("embed", "lm_head") if k in params}}
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    return jcfg, params, cfg, model


@pytest.fixture(scope="module")
def models():
    return make_models()


def same_prompts(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_prompts,max_prompt,block_range", [
    (6, 32, (0, 2)),
    (10_000, 8, None),  # cutoff beyond the dataset: every read, short prompts
    (1, 64, (2, 5)),
])
def test_prompts_from_store_match_reference(stores, n_prompts, max_prompt, block_range):
    ours, theirs = stores
    kw = dict(vocab=VOCAB, n_prompts=n_prompts, max_prompt=max_prompt, block_range=block_range)
    got = prompts_from_store(ours, "ds", **kw)
    same_prompts(got, ref_prompts(theirs, "ds", **kw))
    assert all(0 < p.size <= max_prompt and p.min() >= 0 and p.max() < VOCAB for p in got)


def test_prompts_over_asking_returns_what_exists(stores):
    ours, theirs = stores
    out = ours.read("ds", (0, 1), fmt="kmer", kmer_k=4)
    lens = out["read_len"][0].numpy()
    eligible = int((lens[: int(out["n_reads"][0])] // 4 > 0).sum())
    kw = dict(vocab=VOCAB, n_prompts=10_000, kmer_k=4, block_range=(0, 1))
    got = prompts_from_store(ours, "ds", **kw)
    assert len(got) == eligible and all(p.size > 0 for p in got)
    same_prompts(got, ref_prompts(theirs, "ds", **kw))


def test_prompts_all_zero_kmer_blocks_return_empty():
    """A range where every read is shorter than one k-mer yields []."""
    ref = make_reference(8_000, seed=74)
    rng = np.random.default_rng(0)
    reads = [ref[p : p + 10].copy() for p in rng.integers(0, 7000, size=12)]
    rs = ReadSet(reads=reads, quals=[np.full(10, 70, np.uint8) for _ in reads], kind="short", profile="tiny")
    sf = RefEncoder(ref, token_target=2048, batched=False).encode(rs)
    store = SageStore(device="cpu")
    store.register("short", sage_file_from_reference(sf))
    assert prompts_from_store(store.session(), "short", vocab=4**8, kmer_k=15, n_prompts=4) == []
    ref_store = RefStore()
    ref_store.register("short", sf)
    assert ref_prompts(ref_store.session(), "short", vocab=4**8, kmer_k=15, n_prompts=4) == []


def test_prompts_max_prompt_prefix_parity(stores):
    """max_prompt keeps the k-mer PREFIX, the prefix the engine's slot keeps."""
    ours, _ = stores
    kw = dict(vocab=VOCAB, n_prompts=6, kmer_k=4, block_range=(0, 2))
    long = prompts_from_store(ours, "ds", max_prompt=32, **kw)
    short = prompts_from_store(ours, "ds", max_prompt=8, **kw)
    assert len(long) == len(short)
    for lo, sh in zip(long, short):
        assert sh.size == min(8, lo.size)
        np.testing.assert_array_equal(sh, lo[: sh.size])


def teacher_forced(step_fn, prefill_fn, toks, gen):
    """Last-position logits (f32 numpy) of the prefill and of each decode step
    fed the tokens ``gen`` (B, T): T arrays of (B, V)."""
    logits, cache = prefill_fn(toks)
    outs = [logits]
    for t in range(gen.shape[1] - 1):
        logits, cache = step_fn(gen[:, t : t + 1], cache, toks.shape[1] + t)
        outs.append(logits)
    return outs


def slots(prompts, P):
    """The slot layout both engines use: prompts left-padded to P tokens."""
    toks = np.zeros((len(prompts), P), np.int32)
    for i, p in enumerate(prompts):
        toks[i, -len(p[:P]):] = p[:P]
    return toks


def engines_and_logits(jcfg, params, cfg, model, prompts, sc):
    """Greedy tokens of both engines, then the last-position logits of both
    models fed the JAX engine's tokens (teacher forcing), step by step."""
    want = np.stack(RefEngine(jcfg, params, RefServeConfig(**sc)).generate(prompts))
    cuda_lib.reset_counts()
    got = np.stack(ServingEngine(cfg, model, ServeConfig(**sc)).generate(prompts))
    # one SSD launch (plain on the CPU) per Mamba2 layer for the prefill and each decode step
    n_ssd = cfg.n_layers * sc["max_new"] if cfg.family in ("ssm", "hybrid") else 0
    assert cuda_lib.counts() == ({"plain:ssd_intra": n_ssd, "plain:ssd_chain": n_ssd} if n_ssd else {})
    toks = slots(prompts, sc["max_prompt"])
    max_len = sc["max_prompt"] + sc["max_new"] + 1
    j_step = jax.jit(JLM.decode_step, static_argnums=(1,))  # one compile for every step
    j_logits = teacher_forced(
        lambda tok, c, i: (lambda lg, c2: (np.asarray(lg[:, -1], np.float32), c2))(
            *j_step(params, jcfg, jnp.asarray(tok), c, jnp.int32(i))),
        lambda tk: (lambda lg, c: (np.asarray(lg[:, -1], np.float32), c))(
            *JLM.prefill(params, jcfg, jnp.asarray(tk), max_len)),
        toks, want)
    t_logits = teacher_forced(
        lambda tok, c, i: (lambda lg, c2: (lg[:, -1].float().numpy(), c2))(
            *lm.decode_step(model, cfg, torch.from_numpy(tok).long(), c, i)),
        lambda tk: (lambda lg, c: (lg[:, -1].float().numpy(), c))(
            *lm.prefill(model, cfg, torch.from_numpy(tk).long(), max_len)),
        toks, want)
    return want, got, np.stack(j_logits), np.stack(t_logits)  # logits: (T, B, V)


SC = dict(max_prompt=16, max_new=8)


def test_teacher_forced_logits_match_reference(stores, models):
    """At JAX's init scale, both engines' logits agree within 5e-2 at every
    step, and both engines' tokens lie in the vocabulary."""
    ours_s, theirs_s = stores
    jcfg, params, cfg, model = models
    prompts = prompts_from_store(ours_s, "ds", vocab=cfg.vocab, n_prompts=4, block_range=(0, 3))
    same_prompts(prompts, ref_prompts(theirs_s, "ds", vocab=cfg.vocab, n_prompts=4, block_range=(0, 3)))
    want, got, lj, lt = engines_and_logits(jcfg, params, cfg, model, prompts, SC)
    assert got.shape == want.shape == (4, 8) and got.dtype == np.int32
    assert got.min() >= 0 and got.max() < cfg.vocab
    for t in range(lj.shape[0]):
        np.testing.assert_allclose(lt[t], lj[t], rtol=TOL, atol=TOL, err_msg=f"step {t}")


def test_greedy_generation_matches_reference(stores):
    """Greedy tokens equal JAX's wherever the choice is decided (see
    ``greedy_matches``), mamba2-370m with the tied embedding scaled x50."""
    greedy_matches(stores, "mamba2-370m", 50.0)


@pytest.mark.parametrize("arch,scale", [("qwen2-1.5b", 50.0), ("zamba2-2.7b", 20.0)])
def test_family_greedy_generation_matches_reference(stores, arch, scale):
    """``greedy_matches`` for the dense (qwen2-1.5b: tied, QKV biases) and
    hybrid (zamba2-2.7b: its embedding and untied head scaled x20)
    families."""
    greedy_matches(stores, arch, scale)


def greedy_matches(stores, arch, scale):
    """Greedy tokens equal JAX's wherever the choice is decided: per prompt,
    up to the first step whose JAX top-2 margin is within twice the largest
    logit difference between the two models at that step (past it, bf16
    rounding may rightly flip the choice). The embedding (and an untied
    head) is scaled so the choices are separated as a trained model's are:
    at the init scale every prompt's top-2 margin is below the logits'
    tolerance from the first step, and the comparison would be empty.
    Left-padded slots are valid attention keys in both packages."""
    ours_s, theirs_s = stores
    jcfg, params, cfg, model = make_models(embed_scale=scale, arch=arch)
    prompts = prompts_from_store(ours_s, "ds", vocab=cfg.vocab, n_prompts=4, block_range=(0, 3))
    want, got, lj, lt = engines_and_logits(jcfg, params, cfg, model, prompts, SC)
    scale = np.abs(lj).max()
    diff = np.abs(lt - lj).max(axis=-1)  # (T, B)
    assert diff.max() <= TOL * scale, (diff.max(), scale)  # bf16's tolerance at this logit scale
    np.testing.assert_array_equal(np.argmax(lj, -1).T, want)  # JAX's greedy choice is its argmax
    top2 = np.sort(lj, axis=-1)[..., -2:]
    undecided = (top2[..., 1] - top2[..., 0]) <= 2 * diff  # (T, B)
    n_cmp = [int(np.argmax(u)) if u.any() else want.shape[1] for u in undecided.T]
    print(f"greedy tokens compared for {n_cmp} of {want.shape[1]} steps per prompt")
    for i, n in enumerate(n_cmp):
        np.testing.assert_array_equal(got[i, :n], want[i, :n], err_msg=f"prompt {i}")
    assert sum(n_cmp) >= want.size // 2, n_cmp  # the comparison is not empty


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-moe-16b", "zamba2-2.7b"])
def test_greedy_generation_matches_reference_f32(stores, arch, monkeypatch):
    """Both engines with f32 activations (prefill and decode_step patched on
    both sides): every prompt's greedy tokens equal JAX's at every step,
    and the logits agree within 1e-4 (sums in another order); at the
    init scale the top-2 margins stay far above that. The moe family
    (deepseek-moe-16b) routes each step as the reference does."""
    ours_s, _ = stores
    jcfg, params, cfg, model = make_models(arch=arch)
    for mod, dt in ((JLM, jnp.float32), (lm, torch.float32)):
        monkeypatch.setattr(mod, "prefill", functools.partial(mod.prefill, dtype=dt))
        monkeypatch.setattr(mod, "decode_step", functools.partial(mod.decode_step, dtype=dt))
    prompts = prompts_from_store(ours_s, "ds", vocab=cfg.vocab, n_prompts=4, block_range=(0, 3))
    want, got, lj, lt = engines_and_logits(jcfg, params, cfg, model, prompts, SC)
    np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-4)
    top2 = np.sort(lj, axis=-1)[..., -2:]
    assert float((top2[..., 1] - top2[..., 0]).min()) > 2e-4  # every choice is decided
    np.testing.assert_array_equal(got, want)


def test_serve_config_not_shared_between_engines(models):
    _, _, cfg, model = models
    e1, e2 = ServingEngine(cfg, model), ServingEngine(cfg, model)
    assert e1.sc is not e2.sc
    e1.sc.temperature = 0.7
    assert e2.sc.temperature == 0.0
    assert (e1.sc.max_prompt, e1.sc.max_new) == (512, 64)
    assert e1.device == torch.device("cpu")


def test_temperature_guard_consistent_between_prefill_and_step(models):
    """Both sampling sites share one floor: a denormal temperature behaves
    exactly like the 1e-6 floor."""
    _, _, cfg, model = models
    prompts = [np.arange(1, 7, dtype=np.int32)]
    outs = {}
    for t in (1e-300, 1e-6):
        eng = ServingEngine(cfg, model, ServeConfig(max_prompt=16, max_new=6, temperature=t, seed=9))
        outs[t] = eng.generate(prompts)[0]
        assert outs[t].min() >= 0 and outs[t].max() < cfg.vocab
    np.testing.assert_array_equal(outs[1e-300], outs[1e-6])
    warm = ServingEngine(cfg, model, ServeConfig(max_prompt=16, max_new=6, temperature=1.0, seed=9))
    np.testing.assert_array_equal(warm.generate(prompts)[0], warm.generate(prompts)[0])  # seeded


def test_generate_empty_batch(models):
    _, _, cfg, model = models
    assert ServingEngine(cfg, model).generate([]) == []


def test_prompt_slot_truncation_matches_pretruncated(models):
    """A prompt longer than the slot equals its pre-truncated prefix."""
    _, _, cfg, model = models
    eng = ServingEngine(cfg, model, ServeConfig(max_prompt=16, max_new=8))
    long_prompt = np.arange(1, 16 + 9, dtype=np.int32)
    np.testing.assert_array_equal(eng.generate([long_prompt])[0], eng.generate([long_prompt[:16]])[0])


def test_sage_server_is_not_ported(stores, models):
    """Slice 5 (the serving frontend) is ported: a SageServer over the CPU
    store serves a generate request equal to a direct engine call."""
    ours, _ = stores
    _, _, cfg, model = models
    engine = ServingEngine(cfg, model, ServeConfig(**SC))
    srv = SageServer(store=ours.store, engine=engine)
    prompt = np.arange(1, 9, dtype=np.int32)
    h = srv.generate(prompt=prompt)
    srv.run_until_idle()
    np.testing.assert_array_equal(h.result(timeout=0)["tokens"], engine.generate([prompt])[0])
