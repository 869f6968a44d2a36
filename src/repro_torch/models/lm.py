"""Language model over SAGe's k-mer tokens, the SSM family:

  ssm   embed -> [Mamba2 block] x L -> norm -> head (tied embeddings)

Activations flow in bf16 by default and parameters live in f32, as in the
JAX package; ``dtype=`` runs the same code in f32. Parameter names follow
the JAX package's keys (``embed``, ``norm_f``, ``layers.<i>.norm1``,
``layers.<i>.ssm.in_x``, ...), matrices keep its ``(d_in, d_out)`` layout,
and the JAX package's stacked layer parameters map onto them through
``repro_torch.convert.lm_params_from_reference``.

The entry points (``init_params``, ``init_cache``) build on the card
unless the caller asks for the CPU (``device="cpu"``); without a card,
``device="cuda"`` raises rather than run the plain versions in its place.

Training runs ``forward`` under autograd (``training.steps``), with each
block checkpointed (``remat``). Serving (``prefill``, ``decode_step``) runs
without autograd. With grad
mode off every layer keeps one copy of its matrices (and the model one of
its embedding) in the compute dtype, made once (``ssm.cast_once``); the
values equal JAX's per-call ``astype``.

Every other family raises ``NotImplementedError`` naming the ROADMAP slice
that brings it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.core.decode_torch import resolve_device
from repro_torch.models import ssm as S
from repro_torch.models.layers import BF16, dense_init, embed_init, rmsnorm

_NOT_PORTED = {
    "hybrid": "its shared attention block needs attention_train / attention_decode",
    "dense": "attention and MLP layers", "moe": "attention and expert layers",
    "vlm": "attention, M-RoPE and patch embeddings", "encdec": "the encoder-decoder stack",
}


def _require_ssm(cfg) -> None:
    if cfg.family != "ssm":
        why = _NOT_PORTED.get(cfg.family, "its layers")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet ({why}); it comes with "
            f"ROADMAP Queue A, slice 6b part 2: the other LM families and their training"
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


class Mamba2LM(nn.Module):
    """Embedding, ``cfg.n_layers`` Mamba2 blocks, final norm, head. Weights
    are drawn from ``gen`` on ``device`` (``gen`` must live there)."""

    def __init__(self, cfg, gen: torch.Generator, device="cuda") -> None:
        _require_ssm(cfg)
        dev = resolve_device(device)
        if gen.device.type != dev.type or (dev.index is not None and gen.device.index != dev.index):
            raise ValueError(f"the generator lives on {gen.device}, the weights are asked for on {dev}")
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed_init(gen, cfg.vocab, cfg.d_model))
        self.norm_f = nn.Parameter(torch.zeros((cfg.d_model,), device=gen.device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(dense_init(gen, cfg.d_model, cfg.vocab))
        self.layers = nn.ModuleList(Mamba2Block(cfg, gen) for _ in range(cfg.n_layers))
        self._casts: dict = {}

    def head_weight(self, dtype) -> torch.Tensor:
        """The head as ``(d, vocab)`` in ``dtype``: the tied embedding's
        transpose, or ``lm_head``."""
        name = "embed" if self.cfg.tie_embeddings else "lm_head"
        w = S.cast_once(self._casts, {name: getattr(self, name)}, dtype)[name]
        return w.T if self.cfg.tie_embeddings else w


def init_params(gen: torch.Generator, cfg, *, device="cuda") -> Mamba2LM:
    """A model of ``cfg`` with weights drawn from ``gen`` on ``device``."""
    return Mamba2LM(cfg, gen, device)


def _embed(model: Mamba2LM, tokens, dtype):
    return model.embed[tokens].to(dtype)


def _head(model: Mamba2LM, x):
    return x @ model.head_weight(x.dtype)


#: matmul outputs a ``"dots"`` block keeps (the 2-D products ``x @ W``; as
#: JAX's ``dots_with_no_batch_dims_saveable``, batched products are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _block(layer, x, cfg):
    return layer(x, cfg)[0]


def forward(model: Mamba2LM, cfg, tokens, *, remat: bool = True, remat_policy: str = "nothing",
            chunk: int = 1024, dtype=BF16):
    """Training/prefill forward over ``tokens`` (B, S). Returns (logits
    (B, S, V), aux loss 0.0).

    With ``remat`` and grad mode on, each block runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are dropped
    and recomputed in the backward, so B6's forward runs twice a layer a
    step. ``remat_policy`` ``"nothing"`` keeps only each block's input,
    ``"dots"`` also the outputs of its 2-D matrix products. ``chunk`` (the
    attention block size) is unused by the SSM family."""
    _require_ssm(cfg)
    if remat_policy not in ("nothing", "dots"):
        raise ValueError(f"remat_policy must be 'nothing' or 'dots', got {remat_policy!r}")
    x = _embed(model, tokens, dtype)
    ckpt = remat and torch.is_grad_enabled()
    for layer in model.layers:
        if not ckpt:
            x, _ = layer(x, cfg)
            continue
        kw = {}
        if remat_policy == "dots":
            kw["context_fn"] = lambda: create_selective_checkpoint_contexts(_dots_policy)
        x = checkpoint(_block, layer, x, cfg, use_reentrant=False, **kw)
    x = rmsnorm(x, model.norm_f, cfg.norm_eps)
    return _head(model, x), 0.0


def init_cache(cfg, batch: int, max_len: int, dtype=BF16, device="cuda") -> dict:
    """Decode state on ``device``: per layer the conv tails and the SSM
    state, stacked on a leading L axis (f32, as the JAX package makes it).
    ``max_len`` and ``dtype`` are unused by the SSM family, whose state has
    constant size."""
    _require_ssm(cfg)
    st = S.ssm_init_state(cfg, batch, device=resolve_device(device))
    return {"ssm": {k: v[None].expand((cfg.n_layers,) + v.shape).clone() for k, v in st.items()}}


def _stack_states(states: list) -> dict:
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


@torch.no_grad()
def decode_step(model: Mamba2LM, cfg, token, cache, cur_index, *, dtype=BF16):
    """One serving step: token (B, 1) int -> (logits (B, 1, V), cache).

    Unlike the JAX package, which returns a new cache, the step stacks the
    layers' new states into ``cache``'s own tensors (one copy a key, in
    their dtype) and returns it: serving keeps one cache and allocates no
    new one a step. ``cur_index`` (tokens already in the cache) is unused
    by the SSM family."""
    _require_ssm(cfg)
    x = _embed(model, token, dtype)
    sc = cache["ssm"]
    new = []
    for i, layer in enumerate(model.layers):
        x, st = layer(x, cfg, {k: v[i] for k, v in sc.items()})
        new.append(st)
    for k, v in sc.items():  # every layer has read its old state by now
        torch.stack([st[k] for st in new], out=v)
    x = rmsnorm(x, model.norm_f, cfg.norm_eps)
    return _head(model, x), cache


@torch.no_grad()
def prefill(model: Mamba2LM, cfg, tokens, max_len: Optional[int] = None, *, dtype=BF16):
    """Process whole prompts (B, S): returns (last-token logits (B, 1, V),
    cache with each layer's final recurrent state)."""
    _require_ssm(cfg)
    x = _embed(model, tokens, dtype)
    states = []
    for layer in model.layers:
        x, st = layer(x, cfg)
        states.append(st)
    x = rmsnorm(x, model.norm_f, cfg.norm_eps)
    return _head(model, x[:, -1:]), {"ssm": _stack_states(states)}


__all__ = ["Mamba2Block", "Mamba2LM", "init_params", "forward", "init_cache", "decode_step", "prefill"]
