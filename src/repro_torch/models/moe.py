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

Expert parallelism (the reference's ``shard_map`` path): with sharding
rules installed (``repro_torch.distributed.use_rules``) whose model axis
has tp > 1 ranks and ``E % tp == 0``, each rank holds its rows of the batch
(its coordinates on the rules' batch axes) and runs the dispatch over its
experts ``[off, off + E/tp)`` only; an all-reduce (sum) over the model
axis's process group combines the partial outputs. The cross-rank sum adds
in another order than the one-device combine, so the two agree within
float rounding, not bit for bit. The aux loss is the global batch's: the
means of ``probs`` and of the routing counts are averaged over the batch
axes before their product, as the reference computes them outside its
``shard_map``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.distributed.sharding import axes_size, batch_partial, current_rules, tp_rules, whole_seq
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


def _dispatch_ffn(x, top_e, top_w, wg, wu, wd, cfg, off: int = 0, e_local=None, seq_chunk: int = SEQ_CHUNK):
    """Sort dispatch + expert FFN + combine for the local expert slice
    ``[off, off + e_local)`` (all experts by default). x: (B, S, d) in the
    compute dtype; top_e, top_w: (B, S, k); wg, wu (e_local, d, f) and wd
    (e_local, f, d) in x's dtype. Returns the routed experts' partial y
    (B, S, d): pairs routed to other experts contribute zero."""
    B, S, d = x.shape
    if S > seq_chunk and S % seq_chunk == 0:
        parts = [_dispatch_ffn(x[:, i:i + seq_chunk], top_e[:, i:i + seq_chunk], top_w[:, i:i + seq_chunk],
                               wg, wu, wd, cfg, off, e_local, seq_chunk) for i in range(0, S, seq_chunk)]
        return torch.cat(parts, dim=1)
    k = cfg.moe_top_k
    E = cfg.n_experts if e_local is None else e_local
    n = S * k
    cap = expert_capacity(S, cfg)
    dev = x.device
    order, se, seg_start, seg_end = _segments(top_e, cfg)
    tok = order // k  # (B, n): the token of each sorted pair

    # the buffer, slot (e, b, c) <- sorted pair seg_start[b, off + e] + c
    # while it is one of expert off + e's pairs (c < its count); other slots
    # hold zeros
    slot = seg_start[:, off:off + E, None] + torch.arange(cap, device=dev)  # (B, E, cap)
    filled = slot < seg_end[:, off:off + E, None]
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
    keep = (pos < cap) & (e >= off) & (e < off + E)
    w = torch.gather(top_w.reshape(B, n).to(x.dtype), 1, torch.gather(order, 1, sp))
    at = (torch.clamp(e - off, 0, E - 1) * (B * cap) + (torch.arange(B, device=dev) * cap)[:, None]
          + torch.where(keep, pos, 0))
    val = torch.where(keep.view(-1, 1), out.index_select(0, at.view(-1)), 0).view(B, S, k, d)
    val = val * w.view(B, S, k, 1)
    y = val[:, :, 0]
    for j in range(1, k):
        y = y + val[:, :, j]
    return y


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``, differentiable (its gradient is summed too)."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=group)


def moe_apply(p: dict, x: torch.Tensor, cfg):
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux 0-d f32), with ``p``
    as :meth:`MoE.params` gives it (or any dict of tensors under the same
    keys, cast to x's dtype where used).

    With sharding rules installed, ``x`` is this rank's rows of the global
    batch and the expert-parallel path runs (module docstring); ``p`` holds
    all ``E`` experts and each rank takes its slice."""
    if tp_rules(x) is not None:
        return _moe_tp(p, x, cfg)
    B, S, _d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    probs, top_w, top_e = route(p, x, cfg)
    rules = current_rules()

    # load-balance aux loss (Switch / DeepSeek style), over the global batch
    me = probs.mean(dim=(0, 1))
    counts = torch.zeros(E, dtype=F32, device=x.device).index_add_(
        0, top_e.reshape(-1), torch.ones(top_e.numel(), dtype=F32, device=x.device)) / (B * S * k)
    batch_axes = (rules.batch() or ()) if rules is not None else ()
    for a in batch_axes:
        n = axes_size(rules.mesh, (a,))
        me = _all_reduce(me, rules.mesh.get_group(a)) / n
        counts = _all_reduce(counts, rules.mesh.get_group(a)) / n
    aux = E * torch.sum(me * counts)

    w = p["experts"]
    m = rules.model_axis if rules is not None and not rules.pure_dp else None
    tp = axes_size(rules.mesh, (m,)) if m is not None and m in rules.axis_names else 1
    if tp == 1 or E % tp:
        y = _dispatch_ffn(x, top_e, top_w, w["gate"].to(x.dtype), w["up"].to(x.dtype), w["down"].to(x.dtype), cfg)
    else:
        e_local = E // tp
        off = rules.mesh.get_local_rank(m) * e_local
        w = {name: w_[off:off + e_local].to(x.dtype) for name, w_ in w.items()}
        y = _all_reduce(_dispatch_ffn(x, top_e, top_w, w["gate"], w["up"], w["down"], cfg, off, e_local),
                        rules.mesh.get_group(m))
    if cfg.n_shared_experts:
        y = y + L.mlp_apply(p["shared"], x, cfg.act, gated=True)
    return y, aux


def _moe_tp(p: dict, x, cfg):
    """:func:`moe_apply` under tensor parallelism: ``x`` a DTensor (B, S, d)
    and ``p`` DTensor parameters (the experts sharded over the model axis,
    EP; the shared experts' MLP by columns, TP; the router whole). Each
    rank routes its rows of the batch over the whole sequence (a row's
    capacity counts all of it), runs its experts' dispatch and its columns
    of the shared experts, and the partial outputs are left ``Partial``
    over the model axis; the aux loss's two means are partial sums over the
    batch axes, multiplied once DTensor has reduced them (the global
    batch's, as on one device)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    r = tp_rules(x)
    E, k = cfg.n_experts, cfg.moe_top_k
    x = whole_seq(x)
    B, S, _d = x.shape
    mi = r.axis_names.index(r.model_axis)
    w = p["experts"]
    e_local = w["up"].to_local().shape[0]
    off = 0 if e_local == E else r.mesh.get_local_rank(r.model_axis) * e_local
    shared = [p["shared"][n] for n in ("gate", "up", "down")] if cfg.n_shared_experts else []
    # split: each model rank holds other experts (or shared columns), so y
    # and every gradient of the rank's inputs are partial sums over the
    # model axis; the aux means then count 1/m of each rank's rows, so that
    # their gradients sum over the model axis alike
    split = e_local < E or any(t.placements[mi] != Replicate() for t in shared)
    m = r.mesh.size(mi) if split else 1

    def local(x, router, wg, wu, wd, *sh):
        probs, top_w, top_e = route({"router": router}, x, cfg)
        me = probs.sum(dim=(0, 1)) / (B * S * m)
        counts = torch.zeros(E, dtype=F32, device=x.device).index_add_(
            0, top_e.reshape(-1), torch.ones(top_e.numel(), dtype=F32, device=x.device)) / (B * S * k * m)
        y = _dispatch_ffn(x, top_e, top_w, wg, wu, wd, cfg, off, e_local)
        if sh:
            y = y + L.mlp_apply(dict(zip(("gate", "up", "down"), sh)), x, cfg.act, gated=True)
        return y, me, counts

    def on_model(pl):
        return tuple(Partial() if i == mi and split and isinstance(q, Replicate) else q for i, q in enumerate(pl))

    xp = tuple(x.placements)
    mp = on_model(batch_partial(tuple(Replicate() for _ in xp), xp))
    args = (x, p["router"], w["gate"], w["up"], w["down"], *shared)
    lay = tuple(tuple(t.placements) for t in args)
    grads = (on_model(xp),) + tuple(on_model(batch_partial(pl, xp)) for pl in lay[1:])
    y, me, counts = local_map(local, out_placements=(on_model(xp), mp, mp), in_placements=lay,
                              in_grad_placements=grads, device_mesh=r.mesh)(*args)
    return y, E * torch.sum(me * counts)


__all__ = ["MoE", "moe_init", "expert_capacity", "route", "dropped_pairs", "moe_apply"]
