"""Mamba2 / SSD (state-space duality) blocks in torch.

Chunked SSD: the sequence splits into chunks; the intra-chunk term is a
small quadratic product and the state crosses chunks by a linear
recurrence, so the cost is linear in sequence length. Decode is one
constant-size state update (no KV cache).

:func:`ssd_chunked` is the model's own reference (``kernels.ref.ssd_ref``).
:func:`ssm_forward` runs the SSD through ``kernels.ops.ssd``, which launches
the intra-chunk CUDA kernel (B6) for CUDA tensors and takes its plain
version for CPU tensors. Under tensor parallelism (DTensor parameters,
rules installed) ``x`` and ``z`` are placed as ``act_ff`` (the reference's
points) and ``ops.ssd`` runs on each rank's whole heads and whole sequence
through ``local_map`` (:func:`_ssd`); B and C (``ssm_groups`` of them,
replicated) are repeated over the heads before the split.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core.decode_torch import resolve_device
from repro_torch.distributed.sharding import batch_partial, heads_layout, row_out, shard_act, tp_rules, whole_seq
from repro_torch.kernels import ops
from repro_torch.models.layers import F32, Params, dense_init, rmsnorm

#: the mixer's matrices, ``(d_in, d_out)``, applied as ``x @ W``
MATRICES = ("in_z", "in_x", "in_bc", "dt_w", "out_proj")


def ssm_init(gen: torch.Generator, cfg, dtype=F32) -> dict:
    """The mixer's parameters, drawn from ``gen`` on its device."""
    d = cfg.d_model
    di = cfg.d_inner or 2 * d
    H = cfg.ssm_heads
    G, N = cfg.ssm_groups, cfg.ssm_state
    w = cfg.ssm_conv
    dev = gen.device
    return {
        "in_z": dense_init(gen, d, di, dtype),
        "in_x": dense_init(gen, d, di, dtype),
        "in_bc": dense_init(gen, d, 2 * G * N, dtype),
        "dt_w": dense_init(gen, d, H, dtype),
        "dt_bias": torch.full((H,), math.log(math.expm1(0.01)), dtype=dtype, device=dev),
        "ssm_a": torch.log(torch.linspace(1.0, 16.0, H, dtype=F32, device=dev)).to(dtype),  # A = -exp(a)
        "ssm_d": torch.ones((H,), dtype=dtype, device=dev),
        "conv_x": torch.randn((w, di), generator=gen, dtype=dtype, device=dev) * 0.2,
        "conv_bc": torch.randn((w, 2 * G * N), generator=gen, dtype=dtype, device=dev) * 0.2,
        "norm": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, di, d, dtype),
    }


class Mamba2Mixer(Params):
    """The Mamba2 mixer's parameters, under the JAX package's names.
    ``params(dtype)`` gives them as :func:`ssm_forward` takes them: the
    matrices in the compute ``dtype`` (one copy kept per dtype, see
    :func:`~repro_torch.models.layers.cast_once`), the vectors in f32."""

    def __init__(self, p: dict) -> None:
        super().__init__(p, cast=MATRICES)


def _causal_conv(x, w, state=None):
    """Depthwise causal conv; x: (B, S, C), w: (W, C). With ``state``
    ((B, W-1, C) trailing context) for decode continuation. Under tensor
    parallelism it runs on each rank's rows and channels (:func:`_conv_tp`)."""
    r = tp_rules(x)
    if r is not None:
        return _conv_tp(r, x, w, state)
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, t : t + S, :] * w[t].to(x.dtype) for t in range(W))
    new_state = xp[:, -(W - 1) :, :] if W > 1 else None
    return F.silu(out), new_state


def _conv_tp(r, x, w, state):
    """:func:`_causal_conv` of a DTensor x (B, S, C) through ``local_map``:
    each rank convolves its rows and its channels (x's channels and w's
    columns sharded alike over the model axis, or both whole) over the
    whole sequence, from its slice of ``state``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    xl = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in x.placements)
    wl = tuple(Shard(1) if p == Shard(2) else Replicate() for p in xl)
    args, lay = [x, w], [xl, wl]
    if state is not None:
        args, lay = args + [state], lay + [xl]
    n_out = 2 if w.shape[0] > 1 else 1
    fn = local_map(lambda *a: _causal_conv(*a)[:n_out], out_placements=(xl,) * n_out, in_placements=tuple(lay),
                   in_grad_placements=(xl, batch_partial(wl, xl), *lay[2:]), device_mesh=r.mesh)
    out = fn(*(t.redistribute(r.mesh, pl) for t, pl in zip(args, lay)))
    return out[0], (out[1] if n_out == 2 else None)


def ssd_chunked(x, dt, A, B_, C_, chunk: int, state0=None):
    """Chunked SSD scan, the reference.

    x: (B,S,H,P); dt: (B,S,H) (post-softplus); A: (H,) negative;
    B_, C_: (B,S,H,N) (groups pre-broadcast). Returns (y, final_state)."""
    Bb, S0, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S0)
    pad = (-S0) % Q
    if pad:  # padded steps carry dt=0 => identity state transition
        x, dt, B_, C_ = (F.pad(t, [0, 0] * (t.dim() - 2) + [0, pad]) for t in (x, dt, B_, C_))
    S = S0 + pad
    nc = S // Q
    xc = x.reshape(Bb, nc, Q, H, P)
    dtc = dt.reshape(Bb, nc, Q, H).to(F32)
    Bc = B_.reshape(Bb, nc, Q, H, N).to(F32)
    Cc = C_.reshape(Bb, nc, Q, H, N).to(F32)
    a = dtc * A.to(F32)  # (B,nc,Q,H) log-decay <= 0
    state = torch.zeros((Bb, H, P, N), dtype=F32, device=x.device) if state0 is None else state0.to(F32)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    zero = torch.zeros((), dtype=F32, device=x.device)
    ys = []
    for c in range(nc):
        xq, dq, aq, bq, cq = xc[:, c], dtc[:, c], a[:, c], Bc[:, c], Cc[:, c]
        cum = torch.cumsum(aq, dim=1)  # (B,Q,H)
        total = cum[:, -1]  # (B,H)
        L = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])  # (B,Q,Q,H)
        L = torch.where(tri[None, :, :, None], L, zero)
        M = torch.einsum("bqhn,bphn->bqph", cq, bq) * L
        y_intra = torch.einsum("bqph,bphd->bqhd", M, xq.to(F32) * dq[..., None])
        y_state = torch.einsum("bqhn,bhdn->bqhd", cq, state) * torch.exp(cum)[..., None]
        decay_out = torch.exp(total[:, None, :] - cum)  # (B,Q,H)
        state = state * torch.exp(total)[:, :, None, None] + torch.einsum(
            "bqhn,bqhd->bhdn", bq * (dq * decay_out)[..., None], xq.to(F32)
        )
        ys.append(y_intra + y_state)
    y = torch.stack(ys, dim=1).reshape(Bb, S, H, P)[:, :S0]
    return y.to(x.dtype), state


def _ssd(x, dt, A, B_, C_, chunk: int, state0=None):
    """``ops.ssd``; under tensor parallelism on each rank's whole heads
    (x (B,S,H,P), dt (B,S,H), A (H,), B_ and C_ (B,S,H,N), the state
    (B,H,P,N)) and whole sequence, through ``local_map``."""
    r = tp_rules(x)
    if r is None:
        return ops.ssd(x, dt, A, B_, C_, chunk, state0)
    from torch.distributed.tensor.experimental import local_map

    lay = [heads_layout(r, x.shape, 2), heads_layout(r, dt.shape, 2), heads_layout(r, A.shape, 0, batch=False),
           heads_layout(r, B_.shape, 2), heads_layout(r, C_.shape, 2)]
    st = heads_layout(r, (x.shape[0], x.shape[2], x.shape[3], B_.shape[3]), 1)
    args = [x, dt, A, B_, C_] + ([] if state0 is None else [state0])
    lay += [] if state0 is None else [st]
    args = [t.redistribute(r.mesh, pl) for t, pl in zip(args, lay)]
    grad = list(lay)
    grad[2] = batch_partial(lay[2], lay[0])  # A has no batch dim
    fn = local_map(lambda *a: ops.ssd(*a[:5], chunk, *a[5:]), out_placements=(lay[0], st),
                   in_placements=tuple(lay), in_grad_placements=tuple(grad), device_mesh=r.mesh)
    return fn(*args)


def ssm_forward(p, xin, cfg, state=None):
    """Full Mamba2 block. xin: (B, S, d); ``p`` as :meth:`Mamba2Mixer.params`
    (or a dict of tensors under the same names). ``state`` (decode
    continuation) is a dict {"conv_x", "conv_bc", "ssm"}; returns
    (out, new_state). Spans: ``rt.ssm.in_proj``, ``rt.ssm.conv``,
    ``rt.ssm.ssd_prep`` / ``rt.ssm.b6`` / ``rt.ssm.ssd_state`` (here and in
    ``ops.ssd``), ``rt.ssm.gate_norm``, ``rt.ssm.out_proj``."""
    B, S, d = xin.shape
    di = cfg.d_inner or 2 * d
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    G, N = cfg.ssm_groups, cfg.ssm_state
    xin = whole_seq(xin)
    with obs.span("rt.ssm.in_proj"):
        z = xin @ p["in_z"].to(xin.dtype)
        x = xin @ p["in_x"].to(xin.dtype)
        bc = xin @ p["in_bc"].to(xin.dtype)
        dt = F.softplus((xin @ p["dt_w"].to(xin.dtype)).to(F32) + p["dt_bias"].to(F32))
        x = shard_act(x, "act_ff")
        z = shard_act(z, "act_ff")
    cs_x = None if state is None else state["conv_x"]
    cs_bc = None if state is None else state["conv_bc"]
    with obs.span("rt.ssm.conv"):
        x, ncs_x = _causal_conv(x, p["conv_x"], cs_x)
        bc, ncs_bc = _causal_conv(bc, p["conv_bc"], cs_bc)
    with obs.span("rt.ssm.ssd_prep"):
        Bv, Cv = torch.chunk(bc, 2, dim=-1)
        rep = H // G
        Bv = Bv.reshape(B, S, G, N).repeat_interleave(rep, dim=2)
        Cv = Cv.reshape(B, S, G, N).repeat_interleave(rep, dim=2)
        xh = x.reshape(B, S, H, P)
        A = -torch.exp(p["ssm_a"].to(F32))
    s0 = None if state is None else state["ssm"]
    y, s_new = _ssd(xh, dt, A, Bv, Cv, cfg.ssm_chunk, s0)
    with obs.span("rt.ssm.ssd_state"):  # the D skip
        y = y + xh * p["ssm_d"].to(xin.dtype)[None, None, :, None]
    with obs.span("rt.ssm.gate_norm"):
        y = y.reshape(B, S, di)
        y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    with obs.span("rt.ssm.out_proj"):
        out = row_out(y @ p["out_proj"].to(xin.dtype))
    return out, {"conv_x": ncs_x, "conv_bc": ncs_bc, "ssm": s_new}


def ssm_decode_step(p, xin, cfg, state):
    """Single-token decode: xin (B, 1, d); state dict as above."""
    return ssm_forward(p, xin, cfg, state)


def ssm_init_state(cfg, batch: int, dtype=F32, device="cuda") -> dict:
    """Zero decode state on ``device``: the card unless the caller asks
    for the CPU; raises without a card (``decode_torch.resolve_device``)."""
    device = resolve_device(device)
    di = cfg.d_inner or 2 * cfg.d_model
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    G = cfg.ssm_groups
    w = cfg.ssm_conv
    return {
        "conv_x": torch.zeros((batch, w - 1, di), dtype=dtype, device=device),
        "conv_bc": torch.zeros((batch, w - 1, 2 * G * N), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H, P, N), dtype=F32, device=device),
    }
