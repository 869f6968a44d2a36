"""Shared model layers (torch): norms (RMS and Layer), rotary embeddings
(RoPE and Qwen2-VL's M-RoPE), GQA attention (the blockwise ``causal_flash``
with its written-out backward, cached decode attention, the
encoder-decoder cross attention), the MLP, and the loss.

Conventions, as in the JAX package: activations flow in a compute dtype
(bf16 by default), parameters live in f32, matrices are ``(d_in, d_out)``
and applied as ``x @ W``. Initialisers draw from an explicit
``torch.Generator`` on the device that holds the result; their numbers differ from ``jax.random``'s, so tests
carry the JAX package's weights across (``repro_torch.convert``).

Where the JAX package writes ``einsum(..., preferred_element_type=F32)`` on
bf16 operands, the port upcasts the operands to f32 (exact) and multiplies
in f32: ``torch.matmul`` on bf16 would round the product to bf16. The
attention is plain torch ops, the same code on the CPU and the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import (attention_split, batch_partial, grad_placed, heads_layout, is_dtensor,
                                              row_out, shard_act, tp_rules, whole_seq)

F32 = torch.float32
BF16 = torch.bfloat16


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype=F32, scale: Optional[float] = None):
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return torch.randn((d_in, d_out), generator=gen, dtype=dtype, device=gen.device) * s


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=F32):
    return torch.randn((vocab, d), generator=gen, dtype=dtype, device=gen.device) * 0.02


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm computed in f32 and cast back to ``x``'s dtype; the scale is
    stored as an offset from 1."""
    xf = x.to(F32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + scale.to(F32))).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm computed in f32 and cast back to ``x``'s dtype."""
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def cast_once(cache: dict, named: dict, dtype) -> dict:
    """``named`` tensors in ``dtype``, as a per-call ``.to(dtype)`` gives them.

    With grad mode off, each cast is made once and kept in ``cache`` until
    the tensor changes in place (its version counter moves), so serving
    casts no weight per step. With grad mode on, the cast is made afresh,
    so gradients flow to the f32 parameters."""
    if torch.is_grad_enabled():
        return {k: v.to(dtype) for k, v in named.items()}
    out = {}
    for k, v in named.items():
        if v.dtype == dtype:
            out[k] = v
            continue
        key = (k, dtype)
        base = v.to_local() if is_dtensor(v) else v  # a DTensor's own data_ptr is 0
        stamp = (base.data_ptr(), base._version)
        hit = cache.get(key)
        if hit is None or hit[0] != stamp:
            hit = (stamp, v.detach().to(dtype))
            cache[key] = hit
        out[k] = hit[1]
    return out


class Params(nn.Module):
    """A dict of parameters under the JAX package's keys (``wq``, ``up``,
    ...). :meth:`params` gives them as the functional layers take them: the
    ``cast`` keys (all keys by default) in the compute dtype, one copy kept
    per dtype under ``no_grad`` (:func:`cast_once`), the rest as stored."""

    def __init__(self, p: dict, cast: Optional[tuple] = None) -> None:
        super().__init__()
        for k, v in p.items():
            self.register_parameter(k, nn.Parameter(v))
        self._cast = tuple(p) if cast is None else cast
        self._casts: dict = {}

    def params(self, dtype) -> dict:
        named = dict(self.named_parameters())
        out = dict(named)
        out.update(cast_once(self._casts, {k: named[k] for k in self._cast}, dtype))
        return out


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim))


def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S) integers. The rotation runs
    in f32 (``x1 * cos`` promotes bf16) and is cast back to ``x``'s dtype."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    ang = positions[..., None].to(F32) * freqs  # (..., S, Dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def mrope_sections(head_dim: int, sections) -> torch.Tensor:
    """The position stream (0 = t, 1 = h, 2 = w) of each of the head_dim/2
    rotary pairs: ``sections[i]`` pairs of stream i, cut to head_dim/2
    entries, or filled up with the last stream's index (as
    ``jnp.repeat(arange(3), sections, total_repeat_length=Dh // 2)``)."""
    sec = [i for i, n in enumerate(sections) for _ in range(n)][: head_dim // 2]
    return torch.tensor(sec + sec[-1:] * (head_dim // 2 - len(sec)))


def mrope_apply(x: torch.Tensor, positions3: torch.Tensor, theta: float, sections) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the rotary pairs are split into (t, h, w)
    sections, each turned by its own position stream. x: (B, S, H, Dh);
    positions3: (B, 3, S). In f32, cast back to ``x``'s dtype."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    sec = mrope_sections(dh, sections).to(x.device)
    ang = positions3.to(F32)[:, sec, :].transpose(1, 2) * freqs  # (B, S, Dh/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg, dtype=F32) -> dict:
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, H * Dh, dtype),
        "wk": dense_init(gen, d, KV * Dh, dtype),
        "wv": dense_init(gen, d, KV * Dh, dtype),
        "wo": dense_init(gen, H * Dh, d, dtype),
    }
    if cfg.qkv_bias:
        for k, n in (("bq", H * Dh), ("bk", KV * Dh), ("bv", KV * Dh)):
            p[k] = torch.zeros((n,), dtype=dtype, device=gen.device)
    return p


def qkv_project(p: dict, x: torch.Tensor, cfg):
    """(q (B,S,H,Dh), k (B,S,KV,Dh), v (B,S,KV,Dh)) in ``x``'s dtype."""
    x = whole_seq(x)
    q, k, v = x @ p["wq"].to(x.dtype), x @ p["wk"].to(x.dtype), x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"].to(x.dtype), k + p["bk"].to(x.dtype), v + p["bv"].to(x.dtype)
    return split_heads(q, cfg, "q"), split_heads(k, cfg, "kv"), split_heads(v, cfg, "kv")


def split_heads(t, cfg, which: str):
    """A projection t (B, S, n·Dh) as (B, S, n, Dh), n the configuration's
    query heads (``which`` "q") or KV heads ("kv"). Under tensor
    parallelism the columns are first laid out on whole heads, as the
    attention cores take them (``sharding.attention_split``): a model axis
    that does not divide the heads would split one (qwen2-1.5b's 12 query
    heads of 128 over 16 ranks: 96 columns a rank)."""
    n = cfg.n_heads if which == "q" else cfg.n_kv_heads
    r = tp_rules(t)
    if r is not None:
        split = attention_split(r, cfg.n_heads, cfg.n_kv_heads)[0 if which == "q" else 1]
        t = t.redistribute(r.mesh, heads_layout(r, t.shape, 2, split))
    return t.reshape(t.shape[0], t.shape[1], n, cfg.head_dim)


def _pick_chunk(S: int, chunk: int) -> int:
    c = min(chunk, S)
    while S % c != 0:  # largest divisor of S not exceeding the request
        c -= 1
    return c


def _heads_first(q, k, v):
    """f32 copies (exact for bf16) laid out for batched products over the
    KV heads: q as (B, KV, G·S, Dh), the G query heads of a KV head stacked
    on the row axis (head h reads KV head h // G, as ``jnp.repeat(k, G,
    axis=2)`` expands them); k and v as (B, KV, S, Dh)."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    qh = q.to(F32).permute(0, 2, 1, 3).reshape(B, KV, (H // KV) * S, Dh)
    return qh, k.to(F32).permute(0, 2, 1, 3), v.to(F32).permute(0, 2, 1, 3)


def _scores(qh, kj, scale, qpos, kpos, bidirectional):
    """Scores of the query rows ``qpos`` (the rows of ``qh`` stacked G times)
    against one KV block at ``kpos``, -inf after each query (causal)."""
    s = (qh @ kj.transpose(-1, -2)) * scale  # (B, KV, G·S', c)
    if not bidirectional:
        ok = qpos[:, None] >= kpos[None, :]
        s = s.masked_fill(~ok.repeat(s.shape[2] // qpos.numel(), 1), -math.inf)
    return s


def _flash_fwd_impl(q, k, v, chunk: int, bidirectional: bool):
    """One loop over KV blocks; every query is scored against each block
    with an online-softmax update, the ``live`` guards keeping rows whose
    running max is still -inf finite. Causal: queries before a block see
    none of it (their update is the identity, exactly), so each block
    scores only the queries from its first key on. Returns (out in q's
    dtype (B,S,H,Dh), lse f32 (B, KV, G·S))."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    c = _pick_chunk(S, chunk)
    scale = 1.0 / math.sqrt(Dh)
    qh, kh, vh = _heads_first(q, k, v)
    pos = torch.arange(S, device=q.device)
    m = torch.full((B, KV, G, S), -math.inf, dtype=F32, device=q.device)
    l = torch.zeros((B, KV, G, S), dtype=F32, device=q.device)
    acc = torch.zeros((B, KV, G, S, Dh), dtype=F32, device=q.device)
    for j in range(S // c):
        q0 = 0 if bidirectional else j * c
        rows = qh.view(B, KV, G, S, Dh)[:, :, :, q0:].reshape(B, KV, G * (S - q0), Dh)
        s = _scores(rows, kh[:, :, j * c:(j + 1) * c], scale, pos[q0:], pos[j * c:(j + 1) * c], bidirectional)
        s = s.view(B, KV, G, S - q0, c)
        mj, lj, aj = m[..., q0:], l[..., q0:], acc[..., q0:, :]
        m_new = torch.maximum(mj, s.amax(-1))
        live = m_new > -math.inf
        base = torch.where(live, m_new, 0.0)
        p = torch.where(live[..., None], torch.exp(s - base[..., None]), 0.0)
        corr = torch.where(mj > -math.inf, torch.exp(mj - base), 0.0)
        pv = p.to(v.dtype).to(F32).view(B, KV, G * (S - q0), c) @ vh[:, :, j * c:(j + 1) * c]
        l[..., q0:] = lj * corr + p.sum(-1)
        acc[..., q0:, :] = aj * corr[..., None] + pv.view(B, KV, G, S - q0, Dh)
        m[..., q0:] = m_new
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    out = acc / torch.clamp(l[..., None], min=1e-30)  # (B, KV, G, S, Dh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh).to(q.dtype), lse.view(B, KV, G * S)


def _flash_bwd(q, k, v, out, lse, dout, chunk: int, bidirectional: bool):
    """The flash backward: each block's scores recomputed from ``lse``,
    ``Dsum`` = rowsum(dout·out), masked with ``isfinite(s)``; dk and dv of
    the G query heads of a KV head summed into it."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    c = _pick_chunk(S, chunk)
    scale = 1.0 / math.sqrt(Dh)
    qh, kh, vh = _heads_first(q, k, v)
    do = dout.to(F32).permute(0, 2, 1, 3).reshape(B, KV, G * S, Dh)
    dsum = (dout.to(F32) * out.to(F32)).sum(-1).permute(0, 2, 1).reshape(B, KV, G * S)
    pos = torch.arange(S, device=q.device)
    dq = torch.zeros_like(qh)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for j in range(S // c):
        q0 = 0 if bidirectional else j * c
        sel = (slice(None), slice(None), slice(None), slice(q0, None))

        def rows(t):  # the query rows from q0 on, of a (B, KV, G·S, ...) tensor
            return t.view(B, KV, G, S, *t.shape[3:])[sel].reshape(B, KV, G * (S - q0), *t.shape[3:])

        kj, vj = kh[:, :, j * c:(j + 1) * c], vh[:, :, j * c:(j + 1) * c]
        qr, dor = rows(qh), rows(do)
        s = _scores(qr, kj, scale, pos[q0:], pos[j * c:(j + 1) * c], bidirectional)
        p = torch.where(torch.isfinite(s), torch.exp(s - rows(lse[..., None])), 0.0)
        dv[:, :, j * c:(j + 1) * c] = p.transpose(-1, -2) @ dor
        ds = p * (dor @ vj.transpose(-1, -2) - rows(dsum[..., None])) * scale
        dq.view(B, KV, G, S, Dh)[sel] += (ds @ kj).view(B, KV, G, S - q0, Dh)
        dk[:, :, j * c:(j + 1) * c] = ds.transpose(-1, -2) @ qr
    dq = dq.view(B, KV, G, S, Dh).permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh)
    return dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype), dv.permute(0, 2, 1, 3).to(v.dtype)


class CausalFlash(torch.autograd.Function):
    """:func:`causal_flash` under autograd: the forward saves (q, k, v, out,
    lse), the backward is :func:`_flash_bwd` (the JAX package's custom
    VJP). Under non-reentrant checkpointing the forward runs again in the
    backward pass."""

    @staticmethod
    def forward(ctx, q, k, v, chunk, bidirectional):
        out, lse = _flash_fwd_impl(q, k, v, chunk, bidirectional)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.chunk, ctx.bidirectional = chunk, bidirectional
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_bwd(q, k, v, out, lse, dout, ctx.chunk, ctx.bidirectional), None, None)


def causal_flash(q, k, v, chunk: int = 1024, bidirectional: bool = False) -> torch.Tensor:
    """Blockwise (flash) attention. q: (B,S,H,Dh); k, v: (B,S,KV,Dh),
    H % KV == 0. Scores and the running sums in f32; the probabilities are
    cast to v's dtype before the PV product, as the JAX package does.
    Returns (B,S,H,Dh) in q's dtype. Under grad mode with an input that
    requires grad it runs as :class:`CausalFlash`, else as one forward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return CausalFlash.apply(q, k, v, chunk, bidirectional)
    return _flash_fwd_impl(q, k, v, chunk, bidirectional)[0]


def _rows(positions3, q):
    """M-RoPE positions for q's rows: a rank's rows of the batch under
    tensor parallelism (every row of ``_mrope_positions`` is the same)."""
    return positions3 if positions3 is None else positions3[: q.shape[0]]


def _kv_of(k, v, head):
    """k and v, or their KV head ``head`` alone (:func:`_per_head`)."""
    return (k, v) if head is None else (k[:, :, head:head + 1], v[:, :, head:head + 1])


def _per_head(core, q, k, v, *caches, n_out: int = 3):
    """``core(q, k, v, *caches, head)`` -> a tuple of (q-shaped output,
    k-like and v-like outputs...), on whole heads.

    On plain tensors, or without rules, it is ``core(q, k, v, *caches,
    None)``.
    Under tensor parallelism (q a DTensor, rules installed) q, k and v
    (B, S, heads, Dh) are redistributed so that each rank holds whole heads
    and whole sequences (the core needs both), and ``core`` runs on each
    rank's shard through ``local_map``. The heads split as
    ``sharding.attention_split`` says: q, k and v all by heads; or q by
    heads with k and v whole, ``head`` then the KV head the rank's queries
    read (their gradients summed over the model axis); or none, every model
    rank computing every head.
    ``caches`` (B, T, KV, Dh), which ``core`` writes into, must already be
    laid out as k is (``heads_layout``): a redistributed copy would take
    the writes. ``core`` returns ``n_out`` tensors: the first is placed as
    q, the others as k."""
    r = tp_rules(q)
    if r is None:
        return core(q, k, v, *caches, None)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    H, KV = q.shape[2], k.shape[2]
    split_q, split_kv = attention_split(r, H, KV)
    qp = heads_layout(r, q.shape, 2, split_q)
    kp = heads_layout(r, k.shape, 2, split_kv)
    kg, head = kp, None
    if split_q and not split_kv:
        mi = r.axis_names.index(r.model_axis)
        kg = tuple(Partial() if i == mi else pl for i, pl in enumerate(kp))
        head = r.mesh.get_local_rank(r.model_axis) * (H // r.mesh.size(mi)) // (H // KV)
    for c in caches:
        if tuple(c.placements) != kp:
            raise ValueError(f"a KV cache laid out as {tuple(c.placements)} under tensor parallelism; "
                             f"the attention writes it on whole heads, {kp}")
    q, k, v = (t.redistribute(r.mesh, pl) for t, pl in ((q, qp), (k, kp), (v, kp)))
    n_in = 3 + len(caches)
    fn = local_map(lambda *a: core(*a, head), out_placements=(qp,) + (kp,) * (n_out - 1),
                   in_placements=(qp,) + (kp,) * (n_in - 1), in_grad_placements=(qp,) + (kg,) * (n_in - 1),
                   device_mesh=r.mesh)
    return fn(q, k, v, *caches)


def _rope_qk(q, k, positions, positions3, cfg):
    """q and k turned as the configuration asks: not at all with learned
    positions (the encoder-decoder adds them to its inputs), by M-RoPE at
    ``positions3`` (B, 3, S), else by RoPE at ``positions``."""
    if cfg.learned_pos:
        return q, k
    if cfg.mrope:
        return (mrope_apply(q, positions3, cfg.rope_theta, cfg.mrope_sections),
                mrope_apply(k, positions3, cfg.rope_theta, cfg.mrope_sections))
    return rope_apply(q, positions, cfg.rope_theta), rope_apply(k, positions, cfg.rope_theta)


def attention_train(p: dict, x, cfg, positions=None, positions3=None, chunk: int = 1024,
                    bidirectional: bool = False, collect_kv: bool = False):
    """Self attention of x (B, S, d) with RoPE at ``positions`` (default
    0..S-1), M-RoPE at ``positions3`` or no rotation (``_rope_qk``).
    Returns out (B, S, d), and with ``collect_kv`` also (k, v) after the
    rotation, as a prefill caches them."""
    B, S, _ = x.shape
    q, k, v = qkv_project(p, x, cfg)

    def core(q, k, v, head):
        pos = positions if positions is not None else torch.arange(S, device=q.device)[None, :]
        q, k = _rope_qk(q, k, pos, _rows(positions3, q), cfg)
        return (causal_flash(q, *_kv_of(k, v, head), chunk, bidirectional), k, v)

    o, k, v = _per_head(core, q, k, v)
    o = shard_act(grad_placed(o.reshape(B, S, -1)), "act_heads")
    out = row_out(o @ p["wo"].to(x.dtype))
    return (out, (k, v)) if collect_kv else out


def cross_kv(p: dict, kv_out, cfg):
    """The cross attention's keys and values of the encoder output kv_out
    (B, T, d): (k, v), each (B, T, KV, Dh) in kv_out's dtype, no bias."""
    kv_out = whole_seq(kv_out)
    return (split_heads(kv_out @ p["wk"].to(kv_out.dtype), cfg, "kv"),
            split_heads(kv_out @ p["wv"].to(kv_out.dtype), cfg, "kv"))


def cross_attention(p: dict, x, kv_out, cfg, kv=None):
    """Encoder-decoder cross attention of x (B, S, d) over kv_out (B, T, d):
    full (no mask), no rotation, no bias. With S == T it is the flash
    attention, bidirectional, in blocks of min(1024, S); otherwise
    :func:`_full_attn`, as in the JAX package. ``kv``: ``cross_kv(p,
    kv_out, cfg)`` where the caller has it already (a prefill caches it)."""
    B, S, _ = x.shape
    q = split_heads(whole_seq(x) @ p["wq"].to(x.dtype), cfg, "q")
    k, v = cross_kv(p, kv_out, cfg) if kv is None else kv

    def core(q, k, v, head):
        k, v = _kv_of(k, v, head)
        return (causal_flash(q, k, v, min(1024, S), True) if S == k.shape[1] else _full_attn(q, k, v),)

    (o,) = _per_head(core, q, k, v, n_out=1)
    return row_out(grad_placed(o.reshape(B, S, -1)) @ p["wo"].to(x.dtype))


def _full_attn(q, k, v):
    """Softmax attention of every query over every key, GQA: q (B, S, H,
    Dh), k and v (B, T, KV, Dh). Scores in f32 from upcast operands, the
    probabilities cast to v's dtype before the PV product; out in q's
    dtype."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    qh, kh, vh = _heads_first(q, k, v)  # (B, KV, G·S, Dh), (B, KV, T, Dh)
    a = torch.softmax((qh @ kh.transpose(-1, -2)) / math.sqrt(Dh), dim=-1)
    o = a.to(v.dtype).to(F32) @ vh  # (B, KV, G·S, Dh)
    return o.view(B, KV, H // KV, S, Dh).permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh).to(q.dtype)


def attention_decode(p: dict, x, cache_k, cache_v, cur_index: int, cfg, positions=None, positions3=None):
    """One token x (B, 1, d) against a KV cache (B, T, KV, Dh) holding
    ``cur_index`` tokens. The new K and V are written at ``cur_index`` into
    ``cache_k`` / ``cache_v`` themselves (the JAX package returns updated
    copies); keys past ``cur_index`` are masked. Returns (out (B, 1, d),
    cache_k, cache_v)."""
    q, k, v = qkv_project(p, x, cfg)

    def core(q, k, v, cache_k, cache_v, head):
        B, T = q.shape[0], cache_k.shape[1]
        pos = positions if positions is not None else torch.full((B, 1), cur_index, device=q.device)
        q, k = _rope_qk(q, k, pos, _rows(positions3, q), cfg)
        cache_k[:, cur_index] = k[:, 0].to(cache_k.dtype)
        cache_v[:, cur_index] = v[:, 0].to(cache_v.dtype)
        ck, cv = _kv_of(cache_k, cache_v, head)
        H, KV, Dh = q.shape[2], ck.shape[2], q.shape[3]
        qg = q.reshape(B, KV, H // KV, Dh).to(F32)
        s = (qg @ ck.to(F32).permute(0, 2, 3, 1)) / math.sqrt(Dh)  # (B, KV, G, T)
        valid = torch.arange(T, device=q.device) <= cur_index
        a = torch.softmax(s.masked_fill(~valid, -math.inf), dim=-1)
        o = a.to(cv.dtype).to(F32) @ cv.to(F32).permute(0, 2, 1, 3)  # (B, KV, G, Dh)
        return (o.reshape(B, 1, H * Dh).to(q.dtype),)

    (o,) = _per_head(core, q, k, v, cache_k, cache_v, n_out=1)
    return o @ p["wo"].to(x.dtype), cache_k, cache_v


def cached_cross(q, xk, xv):
    """One decode step's cross attention: q (B, 1, H, Dh) over every slot of
    the cached encoder keys and values xk, xv (B, T, KV, Dh), with no mask
    (the JAX package's ``_cached_cross``: slots past the encoder's frames,
    zeros in a prefill's cache, take part too). Returns (B, 1, H·Dh) in q's
    dtype; on each rank's whole heads under tensor parallelism."""
    (o,) = _per_head(lambda q, k, v, head: (_cached_cross(q, *_kv_of(k, v, head)),), q, xk, xv, n_out=1)
    return o


def _cached_cross(q, xk, xv):
    B, _, H, Dh = q.shape
    KV = xk.shape[2]
    qg = q.reshape(B, KV, H // KV, Dh).to(F32)
    a = torch.softmax((qg @ xk.to(F32).permute(0, 2, 3, 1)) / math.sqrt(Dh), dim=-1)  # (B, KV, G, T)
    o = a.to(xv.dtype).to(F32) @ xv.to(F32).permute(0, 2, 1, 3)  # (B, KV, G, Dh)
    return o.reshape(B, 1, H * Dh).to(q.dtype)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, ff: int, gated: bool, dtype=F32) -> dict:
    p = {"up": dense_init(gen, d, ff, dtype), "down": dense_init(gen, ff, d, dtype)}
    if gated:
        p["gate"] = dense_init(gen, d, ff, dtype)
    return p


def mlp_apply(p: dict, x, act: str, gated: bool):
    x = whole_seq(x)
    u = x @ p["up"].to(x.dtype)
    h = _act(x @ p["gate"].to(x.dtype), act) * u if gated else _act(u, act)
    h = shard_act(h, "act_ff")
    return row_out(h @ p["down"].to(x.dtype))


def _act(x, name: str):
    if name == "silu":
        return F.silu(x)
    if name == "gelu":  # jax.nn.gelu's default is the tanh form
        return F.gelu(x, approximate="tanh")
    if name == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(name)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _vocab_shard(r, t) -> int:
    """The rows of the vocabulary each model rank holds where ``t``'s last
    dim (a vocabulary) is sharded over the model axis; 0 where it is not."""
    from torch.distributed.tensor import Shard

    if r is None or r.pure_dp:
        return 0
    mi = r.axis_names.index(r.model_axis)
    return t.shape[-1] // r.mesh.size(mi) if t.placements[mi] == Shard(t.ndim - 1) else 0


def _model_placed(r, pl: tuple, model) -> tuple:
    mi = r.axis_names.index(r.model_axis)
    return tuple(model if i == mi else p for i, p in enumerate(pl))


def _lse_ll(lf, labels):
    """(logsumexp, the labels' logits) of f32 logits lf (..., V)."""
    return torch.logsumexp(lf, dim=-1), torch.gather(lf, -1, labels.to(torch.int64)[..., None])[..., 0]


def _xent_terms(lf, labels):
    """:func:`_lse_ll`; under tensor parallelism on each rank's rows
    (DTensor would gather the logits whole for the gather). With the
    vocabulary sharded over the model axis (``act_btv``), Megatron's
    vocab-parallel cross-entropy: each rank takes the max of its slice
    (reduced by max over the model axis), its sum of exp, and its labels'
    logits (zeros for labels out of its slice); the sums are left
    ``Partial`` for the ops that follow."""
    r = tp_rules(lf)
    if r is None:
        return _lse_ll(lf, labels)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(lf.placements)
    vocab = _vocab_shard(r, lf)
    if not vocab:
        return local_map(_lse_ll, out_placements=(pl, pl), in_placements=(pl, pl),
                         device_mesh=r.mesh)(lf, labels.redistribute(r.mesh, pl))
    whole = _model_placed(r, pl, Replicate())
    lo = r.mesh.get_local_rank(r.model_axis) * vocab
    m = local_map(lambda lf: lf.detach().amax(-1), out_placements=(_model_placed(r, pl, Partial("max")),),
                  in_placements=(pl,), device_mesh=r.mesh)(lf).redistribute(r.mesh, whole)

    def local(lf, labels, m):
        idx = labels.to(torch.int64) - lo
        ok = (idx >= 0) & (idx < vocab)
        g = torch.gather(lf, -1, torch.clamp(idx, 0, vocab - 1)[..., None])[..., 0]
        return torch.exp(lf - m[..., None]).sum(-1), torch.where(ok, g, 0.0)

    part = _model_placed(r, pl, Partial())
    se, ll = local_map(local, out_placements=(part, part), in_placements=(pl, whole, whole),
                       device_mesh=r.mesh)(lf, labels.redistribute(r.mesh, whole), m)
    return torch.log(se) + m, ll


def vocab_parallel_embed(w, tokens):
    """``w[tokens]`` for an embedding ``w`` (V, d) whose vocabulary rows are
    sharded over the model axis, or None where tensor parallelism does not
    shard them: each rank looks up the tokens in its rows (zeros for the
    others) and the sum over the model axis is left ``Partial``
    (Megatron's vocab-parallel embedding)."""
    r = tp_rules(w)
    rows = _vocab_shard(r, w.T) if r is not None else 0
    if not rows or not is_dtensor(tokens):
        return None
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    lo = r.mesh.get_local_rank(r.model_axis) * rows
    tp = _model_placed(r, tuple(tokens.placements), Replicate())

    def local(w, tokens):
        idx = tokens.to(torch.int64) - lo
        ok = (idx >= 0) & (idx < rows)
        return w[torch.clamp(idx, 0, rows - 1)] * ok[..., None].to(w.dtype)

    out = _model_placed(r, tp, Partial())
    return local_map(local, out_placements=(out,), in_placements=(tuple(w.placements), tp),
                     in_grad_placements=(batch_partial(tuple(w.placements), tp), tp),
                     device_mesh=r.mesh)(w, tokens.redistribute(r.mesh, tp))


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 z_loss: float = 0.0) -> torch.Tensor:
    """Stable cross-entropy in f32; logits (..., V), labels (...) of any
    integer type (the token pipeline yields int32; the gather takes an int64
    copy). With ``mask``, the masked mean over at least one position."""
    lse, ll = _xent_terms(logits.to(F32), labels)
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse**2
    if mask is not None:
        loss = loss * mask
        return loss.sum() / torch.clamp(mask.sum(), min=1)
    return loss.mean()
