"""Language models over SAGe's k-mer tokens, the six families of the JAX
package's ``lm.py``:

  ssm     embed -> [Mamba2 block] x L -> norm -> head
  dense   embed -> [GQA attention + MLP] x L -> norm -> head
  vlm     [patch embeddings ; embed] -> [GQA attention (M-RoPE) + MLP] x L
          -> norm -> head over the text positions (qwen2-vl)
  moe     embed -> [GQA attention + MoE] x L -> norm -> head
  hybrid  embed -> [groups: attn_every Mamba2 blocks + ONE shared
          attention block] -> norm -> head (zamba2)
  encdec  frames + learned positions -> [bidirectional attention + MLP] x
          n_enc; embed + learned positions -> [causal attention + cross
          attention + MLP] x L -> LayerNorm -> head (whisper; the frames
          are the stub frontend's embeddings)

Activations flow in bf16 by default and parameters live in f32, as in the
JAX package; ``dtype=`` runs the same code in f32. Parameter names follow
the JAX package's keys (``embed``, ``norm_f``, ``layers.<i>.norm1``,
``layers.<i>.attn.wq``, the moe family's ``layers.<i>.moe.experts.up``,
the hybrid's ``layers.<g>.<j>.ssm.in_x`` and ``shared_attn.mlp.up``, the
encdec family's ``enc_layers.<i>.ln1.scale``, ``dec_layers.<i>.xattn.wq``,
``enc_norm_f.bias`` and ``pos_emb_dec``, ...), matrices keep its
``(d_in, d_out)`` layout, and the JAX package's
stacked layer parameters map onto them through
``repro_torch.convert.lm_params_from_reference``.

The entry points (``init_params``, ``init_cache``) build on the card
unless the caller asks for the CPU (``device="cpu"``); without a card,
``device="cuda"`` raises rather than run the plain versions in its place.
``init_params``, ``forward``, ``prefill``, ``decode_step`` and
``init_cache`` dispatch on ``cfg.family`` as the JAX package does.

Training runs ``forward`` under autograd (``training.steps``), with each
block checkpointed (``remat``) as the JAX package does: every dense, vlm
and moe block, every encoder and decoder layer, and every Mamba2 block of
the hybrid, whose shared attention block is not checkpointed. The moe
family's ``forward`` also returns the sum of its layers' load-balance aux
losses. Serving (``prefill``,
``decode_step``) runs without autograd. With grad mode off every layer
keeps one copy of its matrices (and the model one of its embedding) in
the compute dtype, made once (``layers.cast_once``); the values equal
JAX's per-call ``astype``.

Where the JAX package fails on an input (a vlm or encdec forward without
its patches or frames, a prefill longer than its cache), the port raises
``ValueError`` naming the cause.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch import obs
from repro_torch.core.decode_torch import resolve_device
from repro_torch.distributed.sharding import current_rules, is_dtensor, shard_act, use_rules, whole_seq
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.layers import BF16, cast_once, dense_init, embed_init, layernorm, rmsnorm

N_POS = 32_768  #: rows of the encdec family's learned position tables


class Mamba2Block(nn.Module):
    """Pre-norm residual Mamba2 block: ``x + ssm(rmsnorm(x))``."""

    def __init__(self, cfg, gen: torch.Generator) -> None:
        super().__init__()
        self.norm1 = nn.Parameter(torch.zeros((cfg.d_model,), device=gen.device))
        self.ssm = S.Mamba2Mixer(S.ssm_init(gen, cfg))

    def forward(self, x, cfg, state=None):
        mix = S.ssm_forward if state is None else S.ssm_decode_step
        h, st = mix(self.ssm.params(x.dtype), rmsnorm(x, self.norm1, cfg.norm_eps), cfg, state)
        return x + h, st


class AttnBlock(nn.Module):
    """Pre-norm residual attention + MLP block: a dense layer, and the
    hybrid's shared block (the same keys: norm1, norm2, attn, mlp)."""

    def __init__(self, cfg, gen: torch.Generator) -> None:
        super().__init__()
        self.norm1 = nn.Parameter(torch.zeros((cfg.d_model,), device=gen.device))
        self.norm2 = nn.Parameter(torch.zeros((cfg.d_model,), device=gen.device))
        self.attn = L.Params(L.attn_init(gen, cfg))
        self.mlp = L.Params(L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp))

    def _mlp(self, x, cfg):
        return x + L.mlp_apply(self.mlp.params(x.dtype), rmsnorm(x, self.norm2, cfg.norm_eps), cfg.act, cfg.gated_mlp)

    def forward(self, x, cfg, chunk: int = 1024, collect_kv: bool = False, positions3=None):
        """Training / prefill over (B, S, d) (the vlm family's M-RoPE at
        ``positions3``); with ``collect_kv`` returns (x, (k, v)) for the
        cache."""
        h = L.attention_train(self.attn.params(x.dtype), rmsnorm(x, self.norm1, cfg.norm_eps), cfg,
                              positions3=positions3, chunk=chunk, collect_kv=collect_kv)
        if collect_kv:
            h, kv = h
            return self._mlp(x + h, cfg), kv
        return self._mlp(x + h, cfg)

    def decode(self, x, cfg, cache_k, cache_v, cur_index: int, positions3=None):
        """One token (B, 1, d); writes its K and V into the cache views."""
        h, _, _ = L.attention_decode(self.attn.params(x.dtype), rmsnorm(x, self.norm1, cfg.norm_eps),
                                     cache_k, cache_v, cur_index, cfg, positions3=positions3)
        return self._mlp(x + h, cfg)


class MoEBlock(nn.Module):
    """Pre-norm residual attention + MoE block (the moe family's layer):
    :class:`AttnBlock`'s attention, then the MoE in place of the MLP, under
    the reference's keys norm1, norm2, attn and moe."""

    def __init__(self, cfg, gen: torch.Generator) -> None:
        super().__init__()
        self.norm1 = nn.Parameter(torch.zeros((cfg.d_model,), device=gen.device))
        self.norm2 = nn.Parameter(torch.zeros((cfg.d_model,), device=gen.device))
        self.attn = L.Params(L.attn_init(gen, cfg))
        self.moe = M.MoE(M.moe_init(gen, cfg))

    def _moe(self, x, cfg):
        h, aux = M.moe_apply(self.moe.params(x.dtype), rmsnorm(x, self.norm2, cfg.norm_eps), cfg)
        return x + h, aux

    def forward(self, x, cfg, chunk: int = 1024, collect_kv: bool = False, positions3=None):
        """Training / prefill over (B, S, d): (x, aux), and with
        ``collect_kv`` (x, aux, (k, v)) for the cache."""
        h = L.attention_train(self.attn.params(x.dtype), rmsnorm(x, self.norm1, cfg.norm_eps), cfg,
                              positions3=positions3, chunk=chunk, collect_kv=collect_kv)
        if collect_kv:
            h, kv = h
            return (*self._moe(x + h, cfg), kv)
        return self._moe(x + h, cfg)

    def decode(self, x, cfg, cache_k, cache_v, cur_index: int, positions3=None):
        """One token (B, 1, d); writes its K and V into the cache views. The
        aux loss is dropped, as the reference's decode drops it."""
        h, _, _ = L.attention_decode(self.attn.params(x.dtype), rmsnorm(x, self.norm1, cfg.norm_eps),
                                     cache_k, cache_v, cur_index, cfg, positions3=positions3)
        return self._moe(x + h, cfg)[0]


def _ln(gen: torch.Generator, d: int) -> L.Params:
    """A LayerNorm's ``scale`` (ones) and ``bias`` (zeros), kept in f32."""
    return L.Params({"scale": torch.ones((d,), device=gen.device), "bias": torch.zeros((d,), device=gen.device)},
                    cast=())


def _norm(ln: L.Params, x, cfg):
    return layernorm(x, ln.scale, ln.bias, cfg.norm_eps)


class EncLayer(nn.Module):
    """The encdec family's encoder layer: ``x + attn(ln1(x))`` over every
    frame (bidirectional), then ``x + enc_mlp(ln2(x))``; keys ln1, ln2,
    attn, enc_mlp."""

    def __init__(self, cfg, gen: torch.Generator) -> None:
        super().__init__()
        self.ln1, self.ln2 = _ln(gen, cfg.d_model), _ln(gen, cfg.d_model)
        self.attn = L.Params(L.attn_init(gen, cfg))
        self.enc_mlp = L.Params(L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp))

    def forward(self, x, cfg, chunk: int = 1024):
        x = x + L.attention_train(self.attn.params(x.dtype), _norm(self.ln1, x, cfg), cfg, chunk=chunk,
                                  bidirectional=True)
        return x + L.mlp_apply(self.enc_mlp.params(x.dtype), _norm(self.ln2, x, cfg), cfg.act, cfg.gated_mlp)


class DecLayer(nn.Module):
    """The encdec family's decoder layer: causal self attention, cross
    attention over the encoder's output, MLP, each pre-LayerNorm residual;
    keys ln1, ln2, ln3, attn, xattn, dec_mlp."""

    def __init__(self, cfg, gen: torch.Generator) -> None:
        super().__init__()
        self.ln1, self.ln2, self.ln3 = (_ln(gen, cfg.d_model) for _ in range(3))
        self.attn = L.Params(L.attn_init(gen, cfg))
        self.xattn = L.Params(L.attn_init(gen, cfg))
        self.dec_mlp = L.Params(L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp))

    def _mlp(self, x, cfg):
        return x + L.mlp_apply(self.dec_mlp.params(x.dtype), _norm(self.ln3, x, cfg), cfg.act, cfg.gated_mlp)

    def forward(self, x, cfg, chunk: int, enc_out, collect_kv: bool = False):
        """Training / prefill over (B, S, d); with ``collect_kv`` returns
        (x, (k, v, xk, xv)): the self attention's and the cross
        attention's keys and values, for the cache."""
        h = L.attention_train(self.attn.params(x.dtype), _norm(self.ln1, x, cfg), cfg, chunk=chunk,
                              collect_kv=collect_kv)
        if collect_kv:
            h, kv = h
        x = x + h
        xp = self.xattn.params(x.dtype)
        xkv = L.cross_kv(xp, enc_out, cfg) if collect_kv else None
        x = self._mlp(x + L.cross_attention(xp, _norm(self.ln2, x, cfg), enc_out, cfg, kv=xkv), cfg)
        return (x, (*kv, *xkv)) if collect_kv else x

    def decode(self, x, cfg, cache: dict, i: int, cur_index: int):
        """One token (B, 1, d): self attention writing its K and V at
        ``cur_index`` of layer ``i``'s cache, then cross attention over all
        of its cached ``xk`` / ``xv`` slots (``layers.cached_cross``)."""
        h, _, _ = L.attention_decode(self.attn.params(x.dtype), _norm(self.ln1, x, cfg), cache["k"][i],
                                     cache["v"][i], cur_index, cfg)
        x = x + h
        xp = self.xattn.params(x.dtype)
        q = L.split_heads(_norm(self.ln2, x, cfg) @ xp["wq"], cfg, "q")
        x = x + L.cached_cross(q, cache["xk"][i], cache["xv"][i]) @ xp["wo"]
        return self._mlp(x, cfg)


class _LM(nn.Module):
    """Embedding, final norm and head; weights are drawn from ``gen`` on
    ``device`` (``gen`` must live there). The families add their layers."""

    def __init__(self, cfg, gen: torch.Generator, device="cuda") -> None:
        dev = resolve_device(device)
        if gen.device.type != dev.type or (dev.index is not None and gen.device.index != dev.index):
            raise ValueError(f"the generator lives on {gen.device}, the weights are asked for on {dev}")
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed_init(gen, cfg.vocab, cfg.d_model))
        self.norm_f = nn.Parameter(torch.zeros((cfg.d_model,), device=gen.device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(dense_init(gen, cfg.d_model, cfg.vocab))
        self._casts: dict = {}

    def head_weight(self, dtype) -> torch.Tensor:
        """The head as ``(d, vocab)`` in ``dtype``: the tied embedding's
        transpose, or ``lm_head``."""
        name = "embed" if self.cfg.tie_embeddings else "lm_head"
        w = cast_once(self._casts, {name: getattr(self, name)}, dtype)[name]
        return w.T if self.cfg.tie_embeddings else w


class Mamba2LM(_LM):
    """The ssm family: ``layers`` holds ``cfg.n_layers`` :class:`Mamba2Block`."""

    def __init__(self, cfg, gen: torch.Generator, device="cuda") -> None:
        super().__init__(cfg, gen, device)
        self.layers = nn.ModuleList(Mamba2Block(cfg, gen) for _ in range(cfg.n_layers))


class DenseLM(_LM):
    """The dense family: ``layers`` holds ``cfg.n_layers`` :class:`AttnBlock`."""

    def __init__(self, cfg, gen: torch.Generator, device="cuda") -> None:
        super().__init__(cfg, gen, device)
        self.layers = nn.ModuleList(AttnBlock(cfg, gen) for _ in range(cfg.n_layers))


class VlmLM(DenseLM):
    """The vlm family (qwen2-vl): the dense layout (``layers`` holds
    ``cfg.n_layers`` :class:`AttnBlock`); its inputs put patch embeddings
    before the tokens, and its attention turns by M-RoPE."""


class EncDecLM(_LM):
    """The encdec family (whisper): ``enc_layers`` holds ``n_enc_layers``
    :class:`EncLayer`, ``dec_layers`` ``n_layers`` :class:`DecLayer`;
    ``enc_norm_f`` (a LayerNorm) is the decoder's final norm, as in the JAX
    package, whose ``norm_f`` this model also carries, unused, for the
    checkpoints; ``pos_emb_enc`` / ``pos_emb_dec`` are learned position
    tables of ``N_POS`` rows drawn at 0.01 x normal."""

    def __init__(self, cfg, gen: torch.Generator, device="cuda") -> None:
        super().__init__(cfg, gen, device)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, gen) for _ in range(cfg.n_enc_layers))
        self.dec_layers = nn.ModuleList(DecLayer(cfg, gen) for _ in range(cfg.n_layers))
        self.enc_norm_f = _ln(gen, cfg.d_model)
        for name in ("pos_emb_enc", "pos_emb_dec"):
            self.register_parameter(name, nn.Parameter(
                torch.randn((N_POS, cfg.d_model), generator=gen, device=gen.device) * 0.01))


class MoELM(_LM):
    """The moe family: ``layers`` holds ``cfg.n_layers`` :class:`MoEBlock`."""

    def __init__(self, cfg, gen: torch.Generator, device="cuda") -> None:
        super().__init__(cfg, gen, device)
        self.layers = nn.ModuleList(MoEBlock(cfg, gen) for _ in range(cfg.n_layers))


class HybridLM(_LM):
    """The hybrid family (zamba2): ``layers`` holds ``n_layers //
    attn_every`` groups of ``attn_every`` :class:`Mamba2Block`, and
    ``shared_attn`` is the one :class:`AttnBlock` every group ends in."""

    def __init__(self, cfg, gen: torch.Generator, device="cuda") -> None:
        if cfg.attn_every <= 0 or cfg.n_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple of attn_every {cfg.attn_every}")
        super().__init__(cfg, gen, device)
        self.layers = nn.ModuleList(
            nn.ModuleList(Mamba2Block(cfg, gen) for _ in range(cfg.attn_every))
            for _ in range(cfg.n_layers // cfg.attn_every))
        self.shared_attn = AttnBlock(cfg, gen)


MODELS = {"ssm": Mamba2LM, "dense": DenseLM, "vlm": VlmLM, "moe": MoELM, "hybrid": HybridLM,
          "encdec": EncDecLM}


def init_params(gen: torch.Generator, cfg, *, device="cuda") -> _LM:
    """A model of ``cfg`` (its family's class) with weights drawn from
    ``gen`` on ``device``."""
    if cfg.family not in MODELS:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    return MODELS[cfg.family](cfg, gen, device)


def _embed(model: _LM, tokens, dtype):
    x = L.vocab_parallel_embed(model.embed, tokens)
    return (model.embed[tokens] if x is None else x).to(dtype)


def _head(model: _LM, x):
    return shard_act(whole_seq(x) @ model.head_weight(x.dtype), "act_btv")


def _mrope_positions(cfg, B: int, S_img: int, S_text: int, device="cpu") -> torch.Tensor:
    """(B, 3, S_img + S_text) position streams: the image patches on an
    (h, w) grid of side floor(sqrt(S_img)) at t = 0, then the text tokens
    advancing all three streams together from max(grid) + 1."""
    if S_img == 0:  # the JAX package takes the max of the empty grid, which raises
        raise ValueError(f"{cfg.name}: M-RoPE positions need at least one image patch")
    side = max(int(S_img ** 0.5), 1)
    i = torch.arange(S_img)
    img = torch.stack([torch.zeros_like(i), i // side, i % side])
    top = max((S_img - 1) // side, min(S_img, side) - 1)  # img.max(), from the shapes (no host sync)
    t = torch.arange(S_text) + max(top + 1, 1)
    pos = torch.cat([img, torch.stack([t, t, t])], dim=1)
    return pos[None].expand(B, 3, S_img + S_text).to(device)


def _need(cfg, what: str, value):
    if value is None:
        shape = {"patch_embeds": "(B, S_img, d_model), the image patches put before the tokens",
                 "frames": "(B, T, d_model), the encoder's input"}[what]
        raise ValueError(f"{cfg.name}: the {cfg.family} family needs {what}= {shape}; "
                         f"a batch of tokens alone has none")
    return value


def _vlm_inputs(cfg, x, patch_embeds, dtype):
    """[patch embeddings ; token embeddings x] and their M-RoPE positions."""
    patches = _need(cfg, "patch_embeds", patch_embeds)
    pos3 = _mrope_positions(cfg, x.shape[0], patches.shape[1], x.shape[1], x.device)
    return torch.cat([patches.to(dtype), x], dim=1), pos3


def _enc_inputs(model: _LM, cfg, frames, dtype):
    frames = _need(cfg, "frames", frames)
    return frames.to(dtype) + model.pos_emb_enc[: frames.shape[1]].to(dtype)[None]


def _dec_inputs(model: _LM, tokens, dtype):
    return _embed(model, tokens, dtype) + model.pos_emb_dec[: tokens.shape[1]].to(dtype)[None]


#: matmul outputs a ``"dots"`` block keeps (the 2-D products ``x @ W``; as
#: JAX's ``dots_with_no_batch_dims_saveable``, batched products are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _under(rules, ctx):
    """``ctx`` with ``rules`` installed in the thread that enters it."""
    with use_rules(rules), ctx:
        yield


def _block(layer, x, cfg, chunk, extra=None):
    """A layer's training forward: x, or the moe block's (x, aux).
    ``extra`` is the vlm family's M-RoPE positions, or a decoder layer's
    encoder output. Its ``rt.lm.block`` span is inside the checkpoint, so a
    remat's recompute opens it again."""
    with obs.span("rt.lm.block"):
        if isinstance(layer, Mamba2Block):
            return layer(x, cfg)[0]
        if isinstance(layer, DecLayer):
            return layer(x, cfg, chunk, extra)
        if isinstance(layer, EncLayer):
            return layer(x, cfg, chunk)
        return layer(x, cfg, chunk, positions3=extra)


def forward(model: _LM, cfg, tokens, *, patch_embeds=None, frames=None, remat: bool = True,
            remat_policy: str = "nothing", chunk: int = 1024, dtype=BF16):
    """Training/prefill forward over ``tokens`` (B, S). Returns (logits
    (B, S, V), aux loss): the moe family's aux is the sum of its layers'
    load-balance losses, a 0-d f32 tensor; the other families give 0.0.
    The vlm family takes ``patch_embeds`` (B, S_img, d), put before the
    tokens with M-RoPE positions (``_mrope_positions``), and returns the
    logits of the text positions only; the encdec family takes ``frames``
    (B, T, d), the encoder's input (its attention is bidirectional, its
    decoder's causal).

    With ``remat`` and grad mode on, each dense, vlm or moe block, each
    encoder and decoder layer and each Mamba2 block runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    dropped and recomputed in the backward, so its forward (B6, the
    attention, the MoE dispatch) runs twice a step; a moe block's aux
    leaves the checkpoint beside x, as a tuple output. The hybrid's shared
    block is not checkpointed (``lm.py:196-208`` of the JAX package).
    ``remat_policy`` ``"nothing"`` keeps only each block's input, ``"dots"``
    also the outputs of its 2-D matrix products. ``chunk`` is the
    attention's KV block size."""
    if remat_policy not in ("nothing", "dots"):
        raise ValueError(f"remat_policy must be 'nothing' or 'dots', got {remat_policy!r}")
    ckpt = remat and torch.is_grad_enabled()
    kw = {}
    if remat_policy == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(_dots_policy)
    rules = current_rules()
    if rules is not None and ckpt:  # the recompute may run on autograd's device thread, which has no rules
        contexts = kw.get("context_fn", lambda: (contextlib.nullcontext(), contextlib.nullcontext()))

        def with_rules():
            fwd, rec = contexts()
            return fwd, _under(rules, rec)

        kw["context_fn"] = with_rules

    def run(layer, x, extra=None):
        if not ckpt:
            return _block(layer, x, cfg, chunk, extra)
        return checkpoint(_block, layer, x, cfg, chunk, extra, use_reentrant=False, **kw)

    if cfg.family == "encdec":
        enc_out = shard_act(_enc_inputs(model, cfg, frames, dtype), "act_btd")
        for layer in model.enc_layers:
            enc_out = shard_act(run(layer, enc_out), "act_btd")
        x = shard_act(_dec_inputs(model, tokens, dtype), "act_btd")
        for layer in model.dec_layers:
            x = shard_act(run(layer, x, enc_out), "act_btd")
        return _head(model, _norm(model.enc_norm_f, x, cfg)), 0.0
    with obs.span("rt.lm.embed"):
        x = _embed(model, tokens, dtype)
    pos3 = None
    if cfg.family == "vlm":
        x, pos3 = _vlm_inputs(cfg, x, patch_embeds, dtype)
    x = shard_act(x, "act_btd")
    aux_total = 0.0
    if cfg.family == "hybrid":
        for group in model.layers:
            for layer in group:
                x = shard_act(run(layer, x), "act_btd")
            x = shard_act(model.shared_attn(x, cfg, chunk), "act_btd")
    elif cfg.family == "moe":
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in model.layers:
            x, aux = run(layer, x)
            x = shard_act(x, "act_btd")
            aux_total = aux_total + aux
    else:
        for layer in model.layers:
            x = shard_act(run(layer, x, pos3), "act_btd")
    with obs.span("rt.lm.head"):
        x = rmsnorm(x, model.norm_f, cfg.norm_eps)
        if cfg.family == "vlm":
            x = x[:, -tokens.shape[1]:]
        return _head(model, x), aux_total


def _stacked_state(cfg, lead: tuple, batch: int, device) -> dict:
    st = S.ssm_init_state(cfg, batch, device=device)
    return {k: v.expand(lead + v.shape).clone() for k, v in st.items()}


def init_cache(cfg, batch: int, max_len: int, dtype=BF16, device="cuda") -> dict:
    """Decode state on ``device``:

    * ssm: ``{"ssm"}``, each layer's conv tails and SSM state stacked on a
      leading L axis (f32, as the JAX package makes it);
    * dense, vlm and moe: ``{"k", "v"}``, (L, batch, max_len, KV, Dh) in
      ``dtype``;
    * encdec: ``{"k", "v", "xk", "xv"}``, the decoder's self attention and
      its cross attention's encoder keys and values, each (L, batch,
      max_len, KV, Dh) in ``dtype``;
    * hybrid: ``{"ssm"}`` stacked on (groups, attn_every) and ``{"k", "v"}``
      of the shared block, (groups, batch, max_len, KV, Dh).

    ``max_len`` and ``dtype`` are unused by the SSM family, whose state has
    constant size."""
    dev = resolve_device(device)
    if cfg.family == "ssm":
        return {"ssm": _stacked_state(cfg, (cfg.n_layers,), batch, dev)}
    n = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers
    shape = (n, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    keys = ("k", "v", "xk", "xv") if cfg.family == "encdec" else ("k", "v")
    cache = {k: torch.zeros(shape, dtype=dtype, device=dev) for k in keys}
    if cfg.family == "hybrid":
        cache["ssm"] = _stacked_state(cfg, (n, cfg.attn_every), batch, dev)
    return cache


def _write_states(sc: dict, states: list) -> None:
    """Every Mamba2 layer's new state, in layer order, into the stacked
    cache tensors ``sc`` (one copy a key)."""
    for k, v in sc.items():  # every layer has read its old state by now
        new = [st[k] for st in states]
        if is_dtensor(v):  # DTensor has no stack with out=
            v.copy_(torch.stack(new).view(v.shape))
        else:
            torch.stack(new, out=v.view(len(states), *v.shape[v.dim() - new[0].dim():]))


@torch.no_grad()
def decode_step(model: _LM, cfg, token, cache, cur_index: int, *, dtype=BF16):
    """One serving step: token (B, 1) int -> (logits (B, 1, V), cache).

    Unlike the JAX package, which returns a new cache, the step writes the
    layers' new states, and the new K and V at ``cur_index`` (tokens
    already in the cache; unused by the SSM family), into ``cache``'s own
    tensors and returns it: serving keeps one cache and allocates no new
    one a step. As in the JAX package, the vlm family's M-RoPE position is
    ``cur_index`` on all three streams, and the encdec family's cross
    attention reads every ``xk`` / ``xv`` slot."""
    x = _embed(model, token, dtype)
    if cfg.family == "encdec":
        x = x + model.pos_emb_dec[cur_index].to(dtype)
        for i, layer in enumerate(model.dec_layers):
            x = layer.decode(x, cfg, cache, i, cur_index)
        return _head(model, _norm(model.enc_norm_f, x, cfg)), cache
    if cfg.family in ("dense", "vlm", "moe"):
        pos3 = torch.full((x.shape[0], 3, 1), cur_index, device=x.device) if cfg.mrope else None
        for i, layer in enumerate(model.layers):
            x = layer.decode(x, cfg, cache["k"][i], cache["v"][i], cur_index, positions3=pos3)
    else:
        sc = cache["ssm"]
        hybrid = cfg.family == "hybrid"
        groups = model.layers if hybrid else [model.layers]
        flat = {k: v.flatten(0, 1) if hybrid else v for k, v in sc.items()}  # views: one row a Mamba2 layer
        new, i = [], 0
        for g, group in enumerate(groups):
            for layer in group:
                x, st = layer(x, cfg, {k: v[i] for k, v in flat.items()})
                new.append(st)
                i += 1
            if hybrid:
                x = model.shared_attn.decode(x, cfg, cache["k"][g], cache["v"][g], cur_index)
        _write_states(sc, new)
    x = rmsnorm(x, model.norm_f, cfg.norm_eps)
    return _head(model, x), cache


def _padded(parts: list, max_len: int) -> torch.Tensor:
    """The layers' (B, n, KV, Dh) tensors stacked as (L, B, max_len, KV, Dh),
    zeros after position n."""
    return F.pad(torch.stack(parts), (0, 0, 0, 0, 0, max_len - parts[0].shape[1]))


@torch.no_grad()
def prefill(model: _LM, cfg, tokens, max_len: Optional[int] = None, *, patch_embeds=None, frames=None,
            chunk: int = 1024, dtype=BF16):
    """Process whole prompts (B, S): returns (last-token logits (B, 1, V),
    cache). The cache holds each Mamba2 layer's final recurrent state and
    the attention's K and V (after the rotation, in the compute dtype) at
    positions 0..n-1 of ``max_len`` (default n) slots, zeros after, so
    decode goes on in place: n is S, the vlm family's S_img + S (its
    ``patch_embeds`` first), and for the encdec family's ``xk`` / ``xv``
    (the cross attention's keys and values of its ``frames``) the T frames.
    A prefill longer than ``max_len`` raises ``ValueError`` (the JAX
    package fails to pad it)."""
    B, S_ = tokens.shape
    x = _embed(model, tokens, dtype)
    states, kvs, pos3 = [], [], None
    if cfg.family == "vlm":
        x, pos3 = _vlm_inputs(cfg, x, patch_embeds, dtype)
    T = None
    if cfg.family == "encdec":
        enc_out = _enc_inputs(model, cfg, frames, dtype)
        T = enc_out.shape[1]
    n = x.shape[1] if T is None else max(S_, T)
    max_len = n if max_len is None else max_len
    if cfg.family != "ssm" and n > max_len:
        what = {"vlm": f"{n - S_} image patches and {S_} tokens", "encdec": f"{S_} tokens and {T} frames"}
        raise ValueError(f"{cfg.name}: a prefill of {what.get(cfg.family, f'{S_} tokens')} "
                         f"does not fit a cache of max_len {max_len}")
    if cfg.family == "encdec":
        enc_out = shard_act(enc_out, "act_btd")
        for layer in model.enc_layers:
            enc_out = shard_act(layer(enc_out, cfg, chunk), "act_btd")
        x = shard_act(_dec_inputs(model, tokens, dtype), "act_btd")
        for layer in model.dec_layers:
            x, kv = layer(x, cfg, chunk, enc_out, collect_kv=True)
            x = shard_act(x, "act_btd")
            kvs.append(kv)
        x = _norm(model.enc_norm_f, x, cfg)
        cache = {name: _padded([kv[j] for kv in kvs], max_len) for j, name in enumerate(("k", "v", "xk", "xv"))}
        return _head(model, x[:, -1:]), cache
    x = shard_act(x, "act_btd")
    if cfg.family in ("dense", "vlm", "moe"):
        for layer in model.layers:
            out = layer(x, cfg, chunk, collect_kv=True, positions3=pos3)  # (x, kv), or the moe block's (x, aux, kv)
            x = shard_act(out[0], "act_btd")
            kvs.append(out[-1])
    else:
        hybrid = cfg.family == "hybrid"
        for group in (model.layers if hybrid else [model.layers]):
            for layer in group:
                x, st = layer(x, cfg)
                x = shard_act(x, "act_btd")
                states.append(st)
            if hybrid:
                x, kv = model.shared_attn(x, cfg, chunk, collect_kv=True)
                x = shard_act(x, "act_btd")
                kvs.append(kv)
    x = rmsnorm(x, model.norm_f, cfg.norm_eps)
    cache = {}
    if states:
        lead = (cfg.n_layers // cfg.attn_every, cfg.attn_every) if cfg.family == "hybrid" else (cfg.n_layers,)
        cache["ssm"] = {k: torch.stack([st[k] for st in states]).view(*lead, *states[0][k].shape)
                        for k in states[0]}
    if kvs:
        cache.update({name: _padded([kv[j] for kv in kvs], max_len) for j, name in enumerate(("k", "v"))})
    return _head(model, x[:, -1:]), cache


__all__ = ["MODELS", "Mamba2Block", "AttnBlock", "MoEBlock", "EncLayer", "DecLayer", "Mamba2LM", "DenseLM",
           "VlmLM", "MoELM", "HybridLM", "EncDecLM", "init_params", "forward", "init_cache", "decode_step",
           "prefill"]
