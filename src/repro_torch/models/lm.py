"""Language models over SAGe's k-mer tokens, three families of the JAX
package's ``lm.py``:

  ssm     embed -> [Mamba2 block] x L -> norm -> head
  dense   embed -> [GQA attention + MLP] x L -> norm -> head
  hybrid  embed -> [groups: attn_every Mamba2 blocks + ONE shared
          attention block] -> norm -> head (zamba2)

Activations flow in bf16 by default and parameters live in f32, as in the
JAX package; ``dtype=`` runs the same code in f32. Parameter names follow
the JAX package's keys (``embed``, ``norm_f``, ``layers.<i>.norm1``,
``layers.<i>.attn.wq``, the hybrid's ``layers.<g>.<j>.ssm.in_x`` and
``shared_attn.mlp.up``, ...), matrices keep its ``(d_in, d_out)`` layout,
and the JAX package's stacked layer parameters map onto them through
``repro_torch.convert.lm_params_from_reference``.

The entry points (``init_params``, ``init_cache``) build on the card
unless the caller asks for the CPU (``device="cpu"``); without a card,
``device="cuda"`` raises rather than run the plain versions in its place.
``init_params``, ``forward``, ``prefill``, ``decode_step`` and
``init_cache`` dispatch on ``cfg.family`` as the JAX package does.

Training runs ``forward`` under autograd (``training.steps``), with each
block checkpointed (``remat``) as the JAX package does: every dense block,
and every Mamba2 block of the hybrid, whose shared attention block is not
checkpointed. Serving (``prefill``, ``decode_step``) runs without
autograd. With grad mode off every layer keeps one copy of its matrices
(and the model one of its embedding) in the compute dtype, made once
(``layers.cast_once``); the values equal JAX's per-call ``astype``.

The moe, vlm and encdec families raise ``NotImplementedError`` naming the
ROADMAP slice that brings them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.core.decode_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.layers import BF16, cast_once, dense_init, embed_init, rmsnorm

_NOT_PORTED = {
    "moe": "attention and expert layers (models/moe.py)",
    "vlm": "M-RoPE and patch embeddings",
    "encdec": "the encoder-decoder stack (LayerNorm, cross attention, learned positions)",
}


def _require_ported(cfg) -> None:
    if cfg.family not in MODELS:
        why = _NOT_PORTED.get(cfg.family, "its layers")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet ({why}); it comes with "
            f"ROADMAP Queue A, slice 6b part 3: the moe, vlm and encdec families"
        )


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

    def forward(self, x, cfg, chunk: int = 1024, collect_kv: bool = False):
        """Training / prefill over (B, S, d); with ``collect_kv`` returns
        (x, (k, v)) for the cache."""
        h = L.attention_train(self.attn.params(x.dtype), rmsnorm(x, self.norm1, cfg.norm_eps), cfg,
                              chunk=chunk, collect_kv=collect_kv)
        if collect_kv:
            h, kv = h
            return self._mlp(x + h, cfg), kv
        return self._mlp(x + h, cfg)

    def decode(self, x, cfg, cache_k, cache_v, cur_index: int):
        """One token (B, 1, d); writes its K and V into the cache views."""
        h, _, _ = L.attention_decode(self.attn.params(x.dtype), rmsnorm(x, self.norm1, cfg.norm_eps),
                                     cache_k, cache_v, cur_index, cfg)
        return self._mlp(x + h, cfg)


class _LM(nn.Module):
    """Embedding, final norm and head; weights are drawn from ``gen`` on
    ``device`` (``gen`` must live there). The families add their layers."""

    def __init__(self, cfg, gen: torch.Generator, device="cuda") -> None:
        _require_ported(cfg)
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


MODELS = {"ssm": Mamba2LM, "dense": DenseLM, "hybrid": HybridLM}


def init_params(gen: torch.Generator, cfg, *, device="cuda") -> _LM:
    """A model of ``cfg`` (its family's class) with weights drawn from
    ``gen`` on ``device``."""
    _require_ported(cfg)
    return MODELS[cfg.family](cfg, gen, device)


def _embed(model: _LM, tokens, dtype):
    return model.embed[tokens].to(dtype)


def _head(model: _LM, x):
    return x @ model.head_weight(x.dtype)


#: matmul outputs a ``"dots"`` block keeps (the 2-D products ``x @ W``; as
#: JAX's ``dots_with_no_batch_dims_saveable``, batched products are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _block(layer, x, cfg, chunk):
    if isinstance(layer, Mamba2Block):
        return layer(x, cfg)[0]
    return layer(x, cfg, chunk)


def forward(model: _LM, cfg, tokens, *, remat: bool = True, remat_policy: str = "nothing",
            chunk: int = 1024, dtype=BF16):
    """Training/prefill forward over ``tokens`` (B, S). Returns (logits
    (B, S, V), aux loss 0.0).

    With ``remat`` and grad mode on, each dense block and each Mamba2 block
    runs under ``torch.utils.checkpoint`` (non-reentrant): its activations
    are dropped and recomputed in the backward, so its forward (B6, the
    attention) runs twice a step; the hybrid's shared block is not
    checkpointed (``lm.py:196-208`` of the JAX package). ``remat_policy``
    ``"nothing"`` keeps only each block's input, ``"dots"`` also the
    outputs of its 2-D matrix products. ``chunk`` is the attention's KV
    block size."""
    _require_ported(cfg)
    if remat_policy not in ("nothing", "dots"):
        raise ValueError(f"remat_policy must be 'nothing' or 'dots', got {remat_policy!r}")
    x = _embed(model, tokens, dtype)
    ckpt = remat and torch.is_grad_enabled()
    kw = {}
    if remat_policy == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(_dots_policy)

    def run(layer, x):
        if not ckpt:
            return _block(layer, x, cfg, chunk)
        return checkpoint(_block, layer, x, cfg, chunk, use_reentrant=False, **kw)

    if cfg.family == "hybrid":
        for group in model.layers:
            for layer in group:
                x = run(layer, x)
            x = model.shared_attn(x, cfg, chunk)
    else:
        for layer in model.layers:
            x = run(layer, x)
    x = rmsnorm(x, model.norm_f, cfg.norm_eps)
    return _head(model, x), 0.0


def _stacked_state(cfg, lead: tuple, batch: int, device) -> dict:
    st = S.ssm_init_state(cfg, batch, device=device)
    return {k: v.expand(lead + v.shape).clone() for k, v in st.items()}


def init_cache(cfg, batch: int, max_len: int, dtype=BF16, device="cuda") -> dict:
    """Decode state on ``device``:

    * ssm: ``{"ssm"}``, each layer's conv tails and SSM state stacked on a
      leading L axis (f32, as the JAX package makes it);
    * dense: ``{"k", "v"}``, (L, batch, max_len, KV, Dh) in ``dtype``;
    * hybrid: ``{"ssm"}`` stacked on (groups, attn_every) and ``{"k", "v"}``
      of the shared block, (groups, batch, max_len, KV, Dh).

    ``max_len`` and ``dtype`` are unused by the SSM family, whose state has
    constant size."""
    _require_ported(cfg)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        return {"ssm": _stacked_state(cfg, (cfg.n_layers,), batch, dev)}
    n = cfg.n_layers if cfg.family == "dense" else cfg.n_layers // cfg.attn_every
    shape = (n, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=dev), "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if cfg.family == "hybrid":
        cache["ssm"] = _stacked_state(cfg, (n, cfg.attn_every), batch, dev)
    return cache


def _write_states(sc: dict, states: list) -> None:
    """Every Mamba2 layer's new state, in layer order, into the stacked
    cache tensors ``sc`` (one copy a key)."""
    for k, v in sc.items():  # every layer has read its old state by now
        torch.stack([st[k] for st in states], out=v.view(len(states), *v.shape[v.dim() - states[0][k].dim():]))


@torch.no_grad()
def decode_step(model: _LM, cfg, token, cache, cur_index: int, *, dtype=BF16):
    """One serving step: token (B, 1) int -> (logits (B, 1, V), cache).

    Unlike the JAX package, which returns a new cache, the step writes the
    layers' new states, and the new K and V at ``cur_index`` (tokens
    already in the cache; unused by the SSM family), into ``cache``'s own
    tensors and returns it: serving keeps one cache and allocates no new
    one a step."""
    _require_ported(cfg)
    x = _embed(model, token, dtype)
    if cfg.family == "dense":
        for i, layer in enumerate(model.layers):
            x = layer.decode(x, cfg, cache["k"][i], cache["v"][i], cur_index)
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


@torch.no_grad()
def prefill(model: _LM, cfg, tokens, max_len: Optional[int] = None, *, chunk: int = 1024, dtype=BF16):
    """Process whole prompts (B, S): returns (last-token logits (B, 1, V),
    cache). The cache holds each Mamba2 layer's final recurrent state and
    the attention's K and V (after RoPE, in the compute dtype) at positions
    0..S-1 of ``max_len`` (default S) slots, zeros after, so decode goes on
    in place."""
    _require_ported(cfg)
    B, S_ = tokens.shape
    max_len = S_ if max_len is None else max_len
    x = _embed(model, tokens, dtype)
    states, kvs = [], []
    if cfg.family == "dense":
        for layer in model.layers:
            x, kv = layer(x, cfg, chunk, collect_kv=True)
            kvs.append(kv)
    else:
        hybrid = cfg.family == "hybrid"
        for group in (model.layers if hybrid else [model.layers]):
            for layer in group:
                x, st = layer(x, cfg)
                states.append(st)
            if hybrid:
                x, kv = model.shared_attn(x, cfg, chunk, collect_kv=True)
                kvs.append(kv)
    x = rmsnorm(x, model.norm_f, cfg.norm_eps)
    cache = {}
    if states:
        lead = (cfg.n_layers // cfg.attn_every, cfg.attn_every) if cfg.family == "hybrid" else (cfg.n_layers,)
        cache["ssm"] = {k: torch.stack([st[k] for st in states]).view(*lead, *states[0][k].shape)
                        for k in states[0]}
    if kvs:
        k0 = kvs[0][0]
        for name, part in (("k", 0), ("v", 1)):
            buf = torch.zeros((len(kvs), B, max_len) + k0.shape[2:], dtype=k0.dtype, device=k0.device)
            buf[:, :, :S_] = torch.stack([kv[part] for kv in kvs])
            cache[name] = buf
    return _head(model, x[:, -1:]), cache


__all__ = ["MODELS", "Mamba2Block", "AttnBlock", "Mamba2LM", "DenseLM", "HybridLM", "init_params", "forward", "init_cache",
           "decode_step", "prefill"]
