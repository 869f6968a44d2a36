"""The vlm (qwen2-vl-72b) and encdec (whisper-small) families of the port
against the JAX package's, on the CPU, at ``ArchConfig.reduced()`` (2
layers, d_model 64, 4 heads of 16; whisper 2 encoder and 2 decoder
layers), with the JAX package's weights carried across by ``convert``:
LayerNorm, M-RoPE and its section map, the M-RoPE positions, the cross
attention on both of its paths, forward, prefill + decode and init_cache,
greedy generate, a train step under both remat policies, checkpoints
written by either package, and the three faults of the reference that the
port copies (ROADMAP Queue C: R1-R3).

qwen2-vl-72b runs at ``reduced({"mrope_sections": (2, 3, 3)})`` wherever
the h and w streams must turn: at the reduced head_dim 16 its own (16, 24,
24) map is cut to 8 pairs of the t stream alone.

Inputs are made from seeds with numpy and handed to both packages.
Tolerances, as tests/test_torch_lm.py and tests/test_kernels.py have them:
f32 within 1e-4 (rtol and atol; sums in another order), bf16 within 5e-2
(bf16 rounds at other places in XLA's fused ops and in eager torch); the
step-by-step-decode duality within 2e-2 (tests/test_arch_smoke.py's)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as RefManager
from repro.configs import ARCHS as JARCHS
from repro.core.encoder import SageEncoder as RefEncoder
from repro.core.layout import write_v2 as ref_write_v2
from repro.genomics.synth import make_reference, sample_read_set
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.serving.engine import ServeConfig as RefServeConfig
from repro.serving.engine import ServingEngine as RefEngine
from repro.training import optimizer as JO
from repro.training import steps as JS

from repro_torch.checkpoint.checkpoint import CheckpointManager, _flatten
from repro_torch.configs import get_arch
from repro_torch.convert import (lm_params_from_reference, sage_file_from_reference, train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.core.layout import write_v2
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.training import optimizer as TO
from repro_torch.training import steps as TS

from family_cases import family_inputs, prefix_duality
from train_cases import compare_step

DT = {"f32": (jnp.float32, torch.float32, 1e-4), "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
SECTIONS = {"mrope_sections": (2, 3, 3)}
VLM, ENCDEC = "qwen2-vl-72b", "whisper-small"
ARCHS_ = [VLM, ENCDEC]
KEY = {VLM: "patch_embeds", ENCDEC: "frames"}
N_EXTRA = {VLM: 9, ENCDEC: 20}  # 9 patches: a 3 x 3 grid; 20 frames for 40 tokens: the full-attention path


def f32(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def close(ours, theirs, tol, what=""):
    np.testing.assert_allclose(f32(ours), f32(theirs), rtol=tol, atol=tol, err_msg=what)


def randn(r, shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def cfgs(arch):
    over = SECTIONS if arch == VLM else None
    return JARCHS[arch].reduced(over), get_arch(arch).reduced(over)


@functools.cache
def pair(arch: str):
    """Both packages' reduced ``arch`` with the same weights: JAX's init,
    with its zero QKV biases and its LayerNorms' ones and zeros redrawn so
    the tests see them, carried into the port by ``convert``; and the
    jitted reference entry points."""
    jcfg, cfg = cfgs(arch)
    params = JLM.init_params(jax.random.PRNGKey(7), jcfg)
    r = np.random.default_rng(1)

    def redraw(path, a):
        name = str(path[-1].key)
        if name in ("bq", "bk", "bv", "bias", "scale"):
            return jnp.asarray((1.0 if name == "scale" else 0.0) + randn(r, a.shape, 0.5))
        return a

    params = jax.tree_util.tree_map_with_path(redraw, params)
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    fns = {"forward": jax.jit(JLM.forward, static_argnums=(1,), static_argnames=("remat", "chunk", "dtype")),
           "prefill": jax.jit(JLM.prefill, static_argnums=(1, 3), static_argnames=("chunk", "dtype")),
           "decode": jax.jit(JLM.decode_step, static_argnums=(1,), static_argnames=("dtype",))}
    return jcfg, params, cfg, model, fns


def extra_np(arch, cfg, n, seed=4, B=2):
    return {KEY[arch]: randn(np.random.default_rng(seed), (B, n, cfg.d_model))}


def both(extra: dict):
    """The same inputs for JAX and for the port."""
    return {k: jnp.asarray(v) for k, v in extra.items()}, {k: torch.from_numpy(v) for k, v in extra.items()}


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", sorted(DT))
def test_layernorm_matches_reference(dtype):
    """f32 inside, cast back to the input's dtype."""
    jdt, tdt, tol = DT[dtype]
    r = np.random.default_rng(2)
    x, sc, b = randn(r, (2, 7, 48), 3.0) + 1.5, randn(r, (48,)) + 1.0, randn(r, (48,))
    want = JL.layernorm(jnp.asarray(x, jdt), jnp.asarray(sc), jnp.asarray(b), 1e-5)
    got = L.layernorm(torch.from_numpy(x).to(tdt), torch.from_numpy(sc), torch.from_numpy(b), 1e-5)
    assert got.dtype == tdt
    close(got, want, tol)


def test_mrope_section_map_matches_reference():
    """The stream of each rotary pair, cut to head_dim/2 or filled with the
    last stream, as ``jnp.repeat(arange(3), sections, total_repeat_length=
    Dh // 2)``: at head_dim 16 the default (16, 24, 24) gives the t stream
    alone, (2, 3, 3) all three."""
    for dh, sections in ((16, (16, 24, 24)), (16, (2, 3, 3)), (16, (1, 1, 1)), (128, (16, 24, 24)), (8, (0, 2, 1))):
        want = np.asarray(jnp.repeat(jnp.arange(3), jnp.asarray(sections), total_repeat_length=dh // 2))
        np.testing.assert_array_equal(L.mrope_sections(dh, sections).numpy(), want, err_msg=str((dh, sections)))
    assert L.mrope_sections(16, (16, 24, 24)).tolist() == [0] * 8
    assert L.mrope_sections(16, (2, 3, 3)).tolist() == [0, 0, 1, 1, 1, 2, 2, 2]


@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24)], ids=["233", "default"])
@pytest.mark.parametrize("dtype", sorted(DT))
def test_mrope_apply_matches_reference(dtype, sections):
    """Three position streams that differ (an image grid, then text), per
    row; the reduced default (16, 24, 24), whose map is the t stream only,
    and (2, 3, 3)."""
    jdt, tdt, tol = DT[dtype]
    r = np.random.default_rng(3)
    x = randn(r, (2, 11, 3, 16))
    pos3 = r.integers(0, 400, (2, 3, 11))
    want = JL.mrope_apply(jnp.asarray(x, jdt), jnp.asarray(pos3, jnp.int32), 1e6, sections)
    got = L.mrope_apply(torch.from_numpy(x).to(tdt), torch.from_numpy(pos3), 1e6, sections)
    assert got.dtype == tdt
    close(got, want, tol)


@pytest.mark.parametrize("s_img", [0, 1, 4, 7, 16])
def test_mrope_positions_match_reference(s_img):
    """(B, 3, S_img + S_text): the patches on a grid of side
    floor(sqrt(S_img)) at t = 0, then text from max(grid) + 1. With no
    patch there is no grid: the reference takes the max of an empty array
    and raises ValueError; the port raises ValueError too."""
    jcfg, cfg = cfgs(VLM)
    if s_img == 0:
        with pytest.raises(ValueError):
            JLM._mrope_positions(jcfg, 2, 0, 5)
        with pytest.raises(ValueError, match="image patch"):
            lm._mrope_positions(cfg, 2, 0, 5)
        return
    got = lm._mrope_positions(cfg, 2, s_img, 5)
    assert got.shape == (2, 3, s_img + 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JLM._mrope_positions(jcfg, 2, s_img, 5)))


@pytest.mark.parametrize("T", [12, 7], ids=["flash", "full"])
@pytest.mark.parametrize("dtype", sorted(DT))
def test_cross_attention_matches_reference(dtype, T):
    """12 queries over 12 encoder positions (S == T: the bidirectional flash
    path) or over 7 (``_full_attn``), GQA 4 / 2 heads; and ``_full_attn``
    itself."""
    jdt, tdt, tol = DT[dtype]
    jcfg, cfg = cfgs(ENCDEC)
    jcfg, cfg = (dataclasses.replace(c, n_kv_heads=2) for c in (jcfg, cfg))
    r = np.random.default_rng(5)
    p = {k: randn(r, s, 0.2) for k, s in (("wq", (64, 64)), ("wk", (64, 32)), ("wv", (64, 32)), ("wo", (64, 64)))}
    x, kv = randn(r, (2, 12, 64)), randn(r, (2, T, 64))
    want = JL.cross_attention({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x, jdt), jnp.asarray(kv, jdt),
                              jcfg)
    got = L.cross_attention({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x).to(tdt),
                            torch.from_numpy(kv).to(tdt), cfg)
    assert got.dtype == tdt
    close(got, want, tol)
    q, k, v = randn(r, (2, 12, 4, 16)), randn(r, (2, T, 2, 16)), randn(r, (2, T, 2, 16))
    want = JL._full_attn(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt))
    got = L._full_attn(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    close(got, want, tol)


# ------------------------------------------------------------------ models
def test_family_layout_matches_reference():
    """Every state_dict name maps one to one onto the JAX package's leaves:
    the vlm family the dense layout (untied, QKV biases); the encdec family
    ``enc_layers.<i>.{ln1, ln2, attn, enc_mlp}``, ``dec_layers.<i>.{ln1,
    ln2, ln3, attn, xattn, dec_mlp}``, ``enc_norm_f``, the unused
    ``norm_f``, ``pos_emb_enc`` and ``pos_emb_dec`` of 32768 rows; the
    gradient compression's ``_stacked`` names each by its JAX leaf."""
    for arch in ARCHS_:
        jcfg, params, cfg, model, _ = pair(arch)
        sd = model.state_dict()
        leaves = {".".join(str(k.key) for k in path): np.asarray(a).shape
                  for path, a in jax.tree_util.tree_flatten_with_path(params)[0]}
        assert {TS._stacked(k) for k in sd} == set(leaves), arch
        for k, v in sd.items():
            lead = leaves[TS._stacked(k)]
            assert tuple(v.shape) == lead[len(lead) - v.dim():], k
        assert sum(v.numel() for v in sd.values()) == sum(int(np.prod(s)) for s in leaves.values())
    _, _, cfg, model, _ = pair(ENCDEC)
    assert isinstance(model, lm.EncDecLM) and len(model.enc_layers) == cfg.n_enc_layers
    assert tuple(model.pos_emb_dec.shape) == (lm.N_POS, cfg.d_model) and "norm_f" in model.state_dict()
    assert isinstance(pair(VLM)[3], lm.VlmLM) and isinstance(pair(VLM)[3].layers[0], lm.AttnBlock)
    assert TS._stacked("dec_layers.11.xattn.wq") == "dec_layers.xattn.wq"
    assert TS._stacked("enc_layers.3.ln1.scale") == "enc_layers.ln1.scale"


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("arch", ARCHS_)
def test_forward_matches_reference(arch, dtype):
    """Training-forward logits of 2 x 40 tokens, attention chunk 16 (a
    ragged split, 10 of 40): the vlm with 9 patches before them (logits of
    the text positions only), the encdec with 20 frames."""
    jcfg, params, cfg, model, fns = pair(arch)
    jdt, tdt, tol = DT[dtype]
    toks = tokens(cfg, (2, 40), seed=8)
    je, te = both(extra_np(arch, cfg, N_EXTRA[arch]))
    lj, _ = fns["forward"](params, jcfg, jnp.asarray(toks), remat=False, chunk=16, dtype=jdt, **je)
    with torch.no_grad():
        lt, aux = lm.forward(model, cfg, torch.from_numpy(toks).long(), chunk=16, dtype=tdt, **te)
    assert lt.shape == (2, 40, cfg.vocab) and lt.dtype == tdt and aux == 0.0
    close(lt, lj, tol)


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("arch", ARCHS_)
def test_prefill_and_decode_match_reference(arch, dtype):
    """Prefill of 2 x 40 tokens (the vlm after 9 patches: 49 positions; the
    encdec with 20 frames) into 56 slots: the last-token logits and the
    whole cache (k, v; the encdec's xk, xv); then four decode steps'
    logits and caches."""
    jcfg, params, cfg, model, fns = pair(arch)
    jdt, tdt, tol = DT[dtype]
    toks = tokens(cfg, (2, 40), seed=5)
    je, te = both(extra_np(arch, cfg, N_EXTRA[arch]))
    lj, cj = fns["prefill"](params, jcfg, jnp.asarray(toks), 56, chunk=16, dtype=jdt, **je)
    lt, ct = lm.prefill(model, cfg, torch.from_numpy(toks).long(), 56, chunk=16, dtype=tdt, **te)
    assert lt.shape == (2, 1, cfg.vocab) and lt.dtype == tdt

    def same(what):
        close(lt, lj, tol, what)
        assert sorted(ct) == sorted(cj), what
        for key in ct:
            assert tuple(ct[key].shape) == tuple(cj[key].shape) and ct[key].dtype == tdt, key
            close(ct[key], cj[key], tol, f"{what} {key}")

    same("prefill")
    start = 40 + (N_EXTRA[arch] if arch == VLM else 0)
    nxt = tokens(cfg, (2, 4), seed=6)
    for t in range(4):
        lj, cj = fns["decode"](params, jcfg, jnp.asarray(nxt[:, t:t + 1]), cj, jnp.int32(start + t), dtype=jdt)
        lt, ct2 = lm.decode_step(model, cfg, torch.from_numpy(nxt[:, t:t + 1]).long(), ct, start + t, dtype=tdt)
        assert ct2 is ct
        same(f"decode step {t}")


@pytest.mark.parametrize("arch", ARCHS_)
def test_init_cache_matches_reference(arch):
    """The same keys (the encdec's k, v, xk, xv), shapes and dtypes (bf16)
    as the JAX package's, all zeros, on the CPU when asked."""
    jcfg, _, cfg, _, _ = pair(arch)
    ours = lm.init_cache(cfg, batch=3, max_len=20, device="cpu")
    theirs = JLM.init_cache(jcfg, batch=3, max_len=20)
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        assert tuple(ours[key].shape) == tuple(theirs[key].shape) and ours[key].dtype == torch.bfloat16
        assert not bool(ours[key].any())


@pytest.mark.parametrize("arch", ARCHS_)
def test_decode_matches_forward_where_the_reference_holds_it(arch):
    """The duality, port only, f32 (``family_cases.prefix_duality``): a
    prefill of the first token, then one decode step a token, against the
    training forward (chunk 8: 3 KV blocks of 24), and the stepped cache
    against a prefill of all 24 tokens, within 2e-2. It holds where the
    reference's decode agrees with its forward: the vlm with one patch
    (text positions start at max(grid) + 1 = 1, the cache index of the
    first token), the encdec with as many frames as cache slots (its
    decode reads every xk / xv slot)."""
    _, _, cfg, model, _ = pair(arch)
    toks = torch.from_numpy(tokens(cfg, (2, 24), seed=9)).long()
    extra = family_inputs(cfg, 2, 1 if arch == VLM else 24, seed=10)
    dec, full, cache, pre = prefix_duality(model, cfg, toks, extra, chunk=8)
    close(dec, full, 2e-2)
    assert sorted(cache) == sorted(pre)
    for key in cache:
        close(cache[key], pre[key], 2e-2, key)


# ---------------------------------------------- faults of the reference (R1-R3)
def test_reference_fault_r2_vlm_decode_positions():
    """ROADMAP C-2 (R2): the vlm decode turns by M-RoPE at the cache index,
    while the prefill's text positions start at max(grid) + 1. With 4
    patches (grid side 2, text from position 2, cache index 4) both
    packages' step-by-step decode misses their forward (by > 0.1 in the
    logits, the first step already), and the port's decode equals the
    reference's within 1e-4 (f32): the port copies the fault."""
    jcfg, params, cfg, model, fns = pair(VLM)
    toks = tokens(cfg, (2, 8), seed=11)
    ext = extra_np(VLM, cfg, 4, seed=12)
    je, te = both(ext)
    dec, full, _, _ = prefix_duality(model, cfg, torch.from_numpy(toks).long(), te, chunk=8)
    lj, cj = fns["prefill"](params, jcfg, jnp.asarray(toks[:, :1]), 12, chunk=8, dtype=jnp.float32, **je)
    outs = [np.asarray(lj[:, 0])]
    for t in range(1, 8):
        lj, cj = fns["decode"](params, jcfg, jnp.asarray(toks[:, t:t + 1]), cj, jnp.int32(4 + t), dtype=jnp.float32)
        outs.append(np.asarray(lj[:, 0]))
    jdec = np.stack(outs, axis=1)
    jfull = np.asarray(fns["forward"](params, jcfg, jnp.asarray(toks), remat=False, chunk=8, dtype=jnp.float32,
                                      **je)[0])
    close(dec, jdec, 1e-4)
    close(full, jfull, 1e-4)
    for d, f in ((f32(dec), f32(full)), (jdec, jfull)):
        assert np.abs(d[:, 1] - f[:, 1]).max() > 0.1
        np.testing.assert_allclose(d[:, 0], f[:, 0], rtol=1e-4, atol=1e-4)  # the prefill itself agrees


def test_reference_fault_r3_encdec_cross_attention_reads_padded_slots():
    """ROADMAP C-3 (R3): the encdec decode's cross attention runs over all
    max_len slots of xk / xv, and the prefill zero-pads those past the T
    frames. With T = 5 and max_len 9 both packages' decode misses their
    forward (by > 0.1 from the first decode step; the prefill's own logits
    agree), and the port's decode equals the reference's within 1e-4 (f32)."""
    jcfg, params, cfg, model, fns = pair(ENCDEC)
    toks = tokens(cfg, (2, 6), seed=13)
    je, te = both(extra_np(ENCDEC, cfg, 5, seed=14))
    dec, full, _, _ = prefix_duality(model, cfg, torch.from_numpy(toks).long(), te, chunk=8, max_len=9)
    lj, cj = fns["prefill"](params, jcfg, jnp.asarray(toks[:, :1]), 9, chunk=8, dtype=jnp.float32, **je)
    outs = [np.asarray(lj[:, 0])]
    for t in range(1, 6):
        lj, cj = fns["decode"](params, jcfg, jnp.asarray(toks[:, t:t + 1]), cj, jnp.int32(t), dtype=jnp.float32)
        outs.append(np.asarray(lj[:, 0]))
    jdec = np.stack(outs, axis=1)
    jfull = np.asarray(fns["forward"](params, jcfg, jnp.asarray(toks), remat=False, chunk=8, dtype=jnp.float32,
                                      **je)[0])
    close(dec, jdec, 1e-4)
    close(full, jfull, 1e-4)
    for d, f in ((f32(dec), f32(full)), (jdec, jfull)):
        assert np.abs(d[:, 1:] - f[:, 1:]).max() > 0.1
        np.testing.assert_allclose(d[:, 0], f[:, 0], rtol=1e-4, atol=1e-4)


def test_reference_fault_r1_vlm_generate_with_default_frames_raises():
    """ROADMAP C-4 (R1): ``generate`` with its default frames gives the vlm
    family (B, P, d_model) zero patches, so its prefill holds 2P positions
    and cannot fit the P + max_new + 1 cache slots: the reference raises
    ValueError while padding, the port ValueError naming the patches."""
    jcfg, params, cfg, model, _ = pair(VLM)
    prompts = [np.arange(1, 7, dtype=np.int32), np.arange(3, 12, dtype=np.int32)]
    with pytest.raises(ValueError):
        RefEngine(jcfg, params, RefServeConfig(**SC)).generate(prompts)
    with pytest.raises(ValueError, match="16 image patches and 16 tokens"):
        ServingEngine(cfg, model, ServeConfig(**SC)).generate(prompts)


def test_encdec_frames_longer_than_the_cache_raise():
    """T frames > max_len: the reference fails to pad the cross attention's
    keys (ValueError); the port raises ValueError naming the frames."""
    jcfg, params, cfg, model, fns = pair(ENCDEC)
    toks = tokens(cfg, (1, 4), seed=15)
    je, te = both(extra_np(ENCDEC, cfg, 12, B=1))
    with pytest.raises(ValueError):
        JLM.prefill(params, jcfg, jnp.asarray(toks), 8, dtype=jnp.float32, **je)
    with pytest.raises(ValueError, match="4 tokens and 12 frames"):
        lm.prefill(model, cfg, torch.from_numpy(toks).long(), 8, dtype=torch.float32, **te)


def test_reference_fault_write_v2_header_layout_oscillates(tmp_path):
    """ROADMAP C-5, found when chip_smoke's vlm phase wrote its training
    tiles: ``write_v2``'s codec header loop looks for a fixed point of the
    data offset, which the header's size depends on; when the header's
    size sits at an alignment boundary the loop alternates between two
    offsets and raises RuntimeError after 16 rounds. A small Illumina set
    (seed 19, 5 blocks) at align 128 does it in both packages; at align 64
    both write it."""
    ref = make_reference(20_000, seed=3)
    sf = RefEncoder(ref, token_target=4096).encode(sample_read_set(ref, "illumina", depth=1, seed=19))
    for write, f in ((ref_write_v2, sf), (write_v2, sage_file_from_reference(sf))):
        with pytest.raises(RuntimeError, match="failed to converge"):
            write(f, tmp_path / "a.sage2", align=128)
        write(f, tmp_path / "b.sage2", align=64)


@pytest.mark.parametrize("arch", ARCHS_)
def test_token_batches_alone_raise_naming_the_missing_input(arch):
    """A batch of tokens alone (the token pipeline's): the reference fails
    (an AssertionError for vlm, an AttributeError for encdec); the port's
    forward and prefill raise ValueError naming patch_embeds / frames."""
    jcfg, params, cfg, model, _ = pair(arch)
    toks = tokens(cfg, (1, 4), seed=16)
    with pytest.raises(AssertionError if arch == VLM else AttributeError):
        JLM.forward(params, jcfg, jnp.asarray(toks), remat=False)
    for call in (lm.forward, lm.prefill):
        with pytest.raises(ValueError, match=KEY[arch]):
            call(model, cfg, torch.from_numpy(toks).long())


# ------------------------------------------------------------------ serving
SC = dict(max_prompt=16, max_new=8)
GEN_CASES = [(ENCDEC, None), (ENCDEC, 16), (ENCDEC, 7), (VLM, 4)]


@pytest.mark.parametrize("arch,n", GEN_CASES, ids=["encdec-default", "encdec-16", "encdec-7", "vlm-4"])
def test_greedy_generation_matches_reference(arch, n, monkeypatch):
    """Both engines with f32 activations (prefill and decode_step patched
    on both sides), 3 prompts in 16-token slots, 8 new tokens: every
    prompt's greedy tokens equal the reference's at every step. whisper
    with its default zero frames and with 16 or 7 seeded frames;
    qwen2-vl with 4 seeded patches (``generate`` fits at most max_new + 1
    patches, R1). The decode steps go on at max_prompt + t, as both
    engines' loops do (R2)."""
    jcfg, params, cfg, model, _ = pair(arch)
    for mod, dt in ((JLM, jnp.float32), (lm, torch.float32)):
        monkeypatch.setattr(mod, "prefill", functools.partial(mod.prefill, dtype=dt))
        monkeypatch.setattr(mod, "decode_step", functools.partial(mod.decode_step, dtype=dt))
    prompts = [np.arange(1, 7, dtype=np.int32), tokens(cfg, (16,), seed=17), tokens(cfg, (11,), seed=18)]
    frames = None if n is None else extra_np(arch, cfg, n, seed=19, B=3)[KEY[arch]]
    want = np.stack(RefEngine(jcfg, params, RefServeConfig(**SC)).generate(prompts, frames))
    got = np.stack(ServingEngine(cfg, model, ServeConfig(**SC)).generate(prompts, frames))
    assert got.shape == (3, SC["max_new"]) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ training
ADAMW = dict(lr=1e-3, total_steps=8, warmup_steps=2)


@functools.cache
def start_of(arch: str):
    """A reduced ``arch``'s initial train state from the JAX package, as
    host numpy."""
    jcfg, _ = cfgs(arch)
    params, opt = JS.init_train_state(jax.random.PRNGKey(0), jcfg, JS.TrainOptions(adamw=JO.AdamWConfig(**ADAMW)))
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt)


def port_state(cfg, params, opt):
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    sd, topt = train_state_from_reference(cfg, params, opt)
    model.load_state_dict(sd)
    return model, topt


def train_batch(arch, cfg):
    """2 x 32: the vlm 8 patches and 24 tokens (the specs' img_frac 0.25),
    the encdec 32 frames and 32 tokens."""
    r = np.random.default_rng(20)
    n_img = 8 if arch == VLM else 0
    t = r.integers(0, cfg.vocab, (2, 32 - n_img + 1)).astype(np.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:], KEY[arch]: randn(r, (2, 8 if arch == VLM else 32, cfg.d_model))}


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("arch", ARCHS_)
def test_train_step_matches_reference(arch, policy, monkeypatch):
    """One f32 train step (both forwards patched to f32; attention chunk 8)
    with remat under ``nothing`` and ``dots`` on both sides: the loss,
    grad_norm and every leaf of the state within tests/train_cases.py's
    AdamW-aware bounds (``compare_step``)."""
    jcfg, cfg = cfgs(arch)
    params, opt = start_of(arch)
    monkeypatch.setattr(JLM, "forward", functools.partial(JLM.forward, dtype=jnp.float32))
    monkeypatch.setattr(lm, "forward", functools.partial(lm.forward, dtype=torch.float32))
    kw = dict(chunk=8, remat_policy=policy)
    jstep = jax.jit(JS.make_train_step(jcfg, JS.TrainOptions(adamw=JO.AdamWConfig(**ADAMW), **kw)))
    tstep = TS.make_train_step(cfg, TS.TrainOptions(adamw=TO.AdamWConfig(**ADAMW), **kw))
    b = train_batch(arch, cfg)
    jp, jopt, jm = jstep(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, opt),
                         {k: jnp.asarray(v) for k, v in b.items()})
    model, topt = port_state(cfg, params, opt)
    model, topt, tm = tstep(model, topt, {k: torch.from_numpy(v) for k, v in b.items()})
    ours = dict(_flatten(train_state_to_reference(cfg, model, topt)))
    theirs = dict(_flatten({"params": jax.tree.map(np.asarray, jp), "opt": jax.tree.map(np.asarray, jopt)}))
    compare_step(({k: float(v) for k, v in tm.items()}, ours), ({k: float(v) for k, v in jm.items()}, theirs))


@pytest.mark.parametrize("arch", ARCHS_)
def test_checkpoints_cross_between_packages(arch, tmp_path):
    """A train state written by ``repro``'s CheckpointManager restores in
    the port (through ``convert``), and one written by the port restores in
    ``repro``, every array equal bit for bit, with the same manifest: the
    vlm's dense layout, the encdec's two stacks, LayerNorms and position
    tables."""
    _, cfg = cfgs(arch)
    params, opt = start_of(arch)
    r = np.random.default_rng(8)
    jstate = {"params": jax.tree.map(lambda a: a + r.standard_normal(a.shape).astype(a.dtype), params),
              "opt": {**opt, "step": np.asarray(5, np.int32)}}
    RefManager(tmp_path / "jax").save(5, jstate, block=True)
    model, topt = port_state(cfg, params, opt)
    got, _extra, step = CheckpointManager(tmp_path / "jax").restore(
        train_state_to_reference(cfg, model, topt, shapes_only=True), verify=True)
    assert step == 5
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
