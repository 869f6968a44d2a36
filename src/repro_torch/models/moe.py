"""Fine-grained MoE (DeepSeek-MoE / Moonlight style), the port of the JAX
package's ``models/moe.py``: shared experts plus top-k routed experts with
capacity-bounded, sort-based dispatch.

Routing: ``(x @ router).float()`` -> softmax -> the k largest
probabilities -> renormalised (a ``1e-9`` floor under the sum). The load-
balance aux loss is ``E * sum(mean(probs) * counts / (B*S*k))`` in f32.

Dispatch (``_dispatch_ffn``), one row of the batch at a time as the
reference does it: the (token, choice) pairs are sorted by expert, each
pair's position inside its expert comes from the experts' segment starts,
and a pair at or past ``expert_capacity(S)`` is dropped (its weight mass is
lost, not renormalised). The kept pairs fill an (E, B, cap, d) buffer, the
experts run as three batched products over E, and each token's k outputs
are gathered back and added in a fixed order. A sequence longer than 1024
tokens that 1024 divides runs 1024-token chunks, each with its own capacity.

Where a line-by-line translation would give other results:

* ``jax.lax.top_k`` puts the lower index first among equal values and
  ``torch.topk`` does not: the top k come from a stable descending sort.
* ``jnp.argsort`` is stable: so is the sort by expert here, so the same
  pairs win the capacity slots.
* The reference scatters into the buffer with ``mode="drop"``. Here the
  buffer is gathered slot by slot from the sorted pairs (a slot past its
  expert's count holds zeros), with no boolean mask, no ``nonzero`` and no
  host sync.
* The reference combines with a scatter-add; a float ``index_add_`` on the
  card adds in a different order from run to run. Here each token's k
  outputs are added one after the other in ascending expert id (the order
  of the reference's scatter on the CPU), so two runs give the same bits.

Only the single-device path is ported: the reference's expert-parallel
``shard_map`` path comes with ROADMAP Queue A, slice 7.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.layers import F32, cast_once

SEQ_CHUNK = 1024  # the reference's dispatch chunk along the sequence


def moe_init(gen: torch.Generator, cfg, dtype=F32) -> dict:
    """``router`` (d, E), ``experts.{up,gate}`` (E, d, f), ``experts.down``
    (E, f, d) and, with shared experts, ``shared.{up,gate,down}`` at width
    ``f * n_shared_experts``; drawn from ``gen`` on its device at the
    reference's scales."""
    d, E = cfg.d_model, cfg.n_experts
    f = cfg.expert_d_ff or cfg.d_ff

    def normal(shape, fan_in):
        return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device) / math.sqrt(fan_in)

    experts = {"up": normal((E, d, f), d), "gate": normal((E, d, f), d), "down": normal((E, f, d), f)}
    p = {"router": L.dense_init(gen, d, E, dtype), "experts": experts}
    if cfg.n_shared_experts:
        p["shared"] = L.mlp_init(gen, d, f * cfg.n_shared_experts, gated=True, dtype=dtype)
    return p


def expert_capacity(n_tokens: int, cfg) -> int:
    cap = int(n_tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, (cap + 7) // 8 * 8)


class MoE(nn.Module):
    """The MoE layer's parameters under the reference's keys (``router``,
    ``experts.*``, ``shared.*``). ``params(dtype)`` gives them as
    :func:`moe_apply` takes them, every matrix in the compute dtype (one
    copy kept per dtype under ``no_grad``, see
    :func:`~repro_torch.models.layers.cast_once`)."""

    def __init__(self, p: dict) -> None:
        super().__init__()
        self.router = nn.Parameter(p["router"])
        self.experts = L.Params(p["experts"])
        if "shared" in p:
            self.shared = L.Params(p["shared"])
        self._casts: dict = {}

    def params(self, dtype) -> dict:
        out = {"router": cast_once(self._casts, {"router": self.router}, dtype)["router"],
               "experts": self.experts.params(dtype)}
        if hasattr(self, "shared"):
            out["shared"] = self.shared.params(dtype)
        return out


def route(p: dict, x: torch.Tensor, cfg):
    """(probs (B, S, E) f32, top_w (B, S, k) f32, top_e (B, S, k) int64):
    the router's softmax, its k largest probabilities (the lower expert id
    first among equal ones) renormalised, and their experts."""
    logits = (x @ p["router"].to(x.dtype)).to(F32)
    probs = torch.softmax(logits, dim=-1)
    w, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe_top_k
    top_w, top_e = w[..., :k], e[..., :k]
    return probs, top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9), top_e


def _segments(top_e: torch.Tensor, cfg):
    """Each row's (token, choice) pairs sorted by expert, stably: (order
    (B, n) the pairs' indices in sorted order, se (B, n) their experts,
    seg_start (B, E) and seg_end (B, E) each expert's span of sorted
    positions)."""
    B = top_e.shape[0]
    fe = top_e.reshape(B, -1)
    order = torch.argsort(fe, dim=-1, stable=True)
    se = torch.gather(fe, 1, order)
    ids = torch.arange(cfg.n_experts, dtype=se.dtype, device=se.device).expand(B, -1).contiguous()
    return order, se, torch.searchsorted(se, ids, side="left"), torch.searchsorted(se, ids, side="right")


def dropped_pairs(top_e: torch.Tensor, cfg, seq_chunk: int = SEQ_CHUNK) -> torch.Tensor:
    """The (token, choice) pairs that :func:`_dispatch_ffn` drops for
    ``top_e`` (B, S, k): each expert's pairs past its capacity, counted per
    row and per ``seq_chunk``-token chunk as the dispatch runs them. A 0-d
    int64 tensor on top_e's device (no host sync)."""
    B, S, _k = top_e.shape
    if S > seq_chunk and S % seq_chunk == 0:
        top_e = top_e.reshape(B * (S // seq_chunk), seq_chunk, -1)
        S = seq_chunk
    _o, _se, start, end = _segments(top_e, cfg)
    return torch.clamp(end - start - expert_capacity(S, cfg), min=0).sum()


def _expert_ffn(buf, wg, wu, wd, act: str):
    """The experts' gated FFN over their slots: buf (E, rows, d) -> (E,
    rows, d), three batched products over E."""
    return torch.bmm(L._act(torch.bmm(buf, wg), act) * torch.bmm(buf, wu), wd)


def _dispatch_ffn(x, top_e, top_w, wg, wu, wd, cfg, seq_chunk: int = SEQ_CHUNK):
    """Sort dispatch + expert FFN + combine over all experts. x: (B, S, d)
    in the compute dtype; top_e, top_w: (B, S, k); wg, wu (E, d, f) and wd
    (E, f, d) in x's dtype. Returns the routed experts' y (B, S, d)."""
    B, S, d = x.shape
    if S > seq_chunk and S % seq_chunk == 0:
        parts = [_dispatch_ffn(x[:, i:i + seq_chunk], top_e[:, i:i + seq_chunk], top_w[:, i:i + seq_chunk],
                               wg, wu, wd, cfg, seq_chunk) for i in range(0, S, seq_chunk)]
        return torch.cat(parts, dim=1)
    k, E = cfg.moe_top_k, cfg.n_experts
    n = S * k
    cap = expert_capacity(S, cfg)
    dev = x.device
    order, se, seg_start, seg_end = _segments(top_e, cfg)
    tok = order // k  # (B, n): the token of each sorted pair

    # the buffer, slot (e, b, c) <- sorted pair seg_start[b, e] + c while it
    # is one of expert e's pairs (c < its count); other slots hold zeros
    slot = seg_start[:, :, None] + torch.arange(cap, device=dev)  # (B, E, cap)
    filled = slot < seg_end[:, :, None]
    src = torch.gather(tok, 1, torch.clamp(slot, max=n - 1).view(B, E * cap)).view(B, E, cap)
    rows = src + (torch.arange(B, device=dev) * S)[:, None, None]
    rows, filled = rows.transpose(0, 1).reshape(-1), filled.transpose(0, 1).reshape(-1, 1)
    buf = torch.where(filled, x.reshape(B * S, d).index_select(0, rows), 0).view(E, B * cap, d)

    out = _expert_ffn(buf, wg, wu, wd, cfg.act).view(E * B * cap, d)

    # each token's k pairs in ascending sorted position (= ascending expert)
    inv = torch.empty_like(order).scatter_(1, order, torch.arange(n, device=dev).expand(B, -1))
    sp = torch.sort(inv.view(B, S, k), dim=-1).values.view(B, n)
    e = torch.gather(se, 1, sp)
    pos = sp - torch.gather(seg_start, 1, e)
    keep = pos < cap
    w = torch.gather(top_w.reshape(B, n).to(x.dtype), 1, torch.gather(order, 1, sp))
    at = e * (B * cap) + (torch.arange(B, device=dev) * cap)[:, None] + torch.where(keep, pos, 0)
    val = torch.where(keep.view(-1, 1), out.index_select(0, at.view(-1)), 0).view(B, S, k, d)
    val = val * w.view(B, S, k, 1)
    y = val[:, :, 0]
    for j in range(1, k):
        y = y + val[:, :, j]
    return y


def moe_apply(p: dict, x: torch.Tensor, cfg):
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux 0-d f32), with ``p``
    as :meth:`MoE.params` gives it (or any dict of tensors under the same
    keys, cast to x's dtype where used)."""
    B, S, _d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    probs, top_w, top_e = route(p, x, cfg)

    # load-balance aux loss (Switch / DeepSeek style)
    me = probs.mean(dim=(0, 1))
    counts = torch.zeros(E, dtype=F32, device=x.device).index_add_(
        0, top_e.reshape(-1), torch.ones(top_e.numel(), dtype=F32, device=x.device)) / (B * S * k)
    aux = E * torch.sum(me * counts)

    w = p["experts"]
    y = _dispatch_ffn(x, top_e, top_w, w["gate"].to(x.dtype), w["up"].to(x.dtype), w["down"].to(x.dtype), cfg)
    if cfg.n_shared_experts:
        y = y + L.mlp_apply(p["shared"], x, cfg.act, gated=True)
    return y, aux


__all__ = ["MoE", "moe_init", "expert_capacity", "route", "dropped_pairs", "moe_apply"]
