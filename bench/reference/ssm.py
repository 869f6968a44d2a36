"""Plain reference of the ssm family (mamba2, arXiv:2405.21060):

  embed -> [x + Mamba2(rmsnorm(x))] x L -> rmsnorm -> head (tied)

The Mamba2 mixer as the configuration runs it: z, x, (B, C) and dt from
separate projections; a depthwise causal convolution (width ``ssm_conv``)
and SiLU on x and on (B, C); dt = softplus(x W_dt + dt_bias); A = -exp(a);
the SSD y_t = sum_{s<=t} (C_t . B_s) exp(sum_{r=s+1..t} dt_r A) dt_s x_s
+ D x_t, in its quadratic (attention-like) form over the whole sequence,
not in chunks; then rmsnorm(y * SiLU(z)) and the output projection.
Plain PyTorch in f32 (or with fp8 products, ``base.matmul``); it imports
nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench import roofline
from bench.reference import base

F32 = torch.float32


def param_spec(cfg: dict) -> list:
    return base.lm_spec(cfg) + [e for i in range(cfg["n_layers"]) for e in base.mamba2_spec(cfg, f"layers.{i}")]


def causal_conv(x, w):
    """Depthwise causal convolution of x (B, S, C) by w (W, C), then SiLU."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    return F.silu(sum(xp[:, t:t + S] * w[t] for t in range(W)))


def ssd(x, dt, A, Bm, Cm):
    """x (B, S, H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, G, N) with the
    heads split evenly over the G groups. Quadratic form, row by row."""
    Bb, S, H, P = x.shape
    rep = H // Bm.shape[2]
    ys = []
    for b in range(Bb):
        cum = torch.cumsum(dt[b] * A, dim=0)  # (S, H)
        seg = cum[:, None, :] - cum[None, :, :]  # (S_q, S_k, H)
        causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~causal[:, :, None], -torch.inf))
        cb = torch.einsum("qgn,kgn->qkg", Cm[b], Bm[b]).repeat_interleave(rep, dim=2)
        ys.append(torch.einsum("qkh,khp->qhp", cb * decay, x[b] * dt[b][..., None]))
    return torch.stack(ys)


def mamba2(params: dict, p: str, x, cfg: dict, mm):
    """``x + mixer(rmsnorm(x))`` of the block under prefix ``p``; x (B, S, d)."""
    q = {k[len(p) + 5:]: v for k, v in params.items() if k.startswith(p + ".ssm.")}
    Bb, S, _ = x.shape
    H, P = cfg["d_inner"] // cfg["ssm_headdim"], cfg["ssm_headdim"]
    G, N = cfg["ssm_groups"], cfg["ssm_state"]
    h = base.rmsnorm(x, params[p + ".norm1"], cfg["norm_eps"])
    z = mm(h, q["in_z"])
    xs = causal_conv(mm(h, q["in_x"]), q["conv_x"])
    bc = causal_conv(mm(h, q["in_bc"]), q["conv_bc"])
    dt = F.softplus(mm(h, q["dt_w"]) + q["dt_bias"])
    Bm, Cm = (t.reshape(Bb, S, G, N) for t in torch.chunk(bc, 2, dim=-1))
    xh = xs.reshape(Bb, S, H, P)
    y = ssd(xh, dt, -torch.exp(q["ssm_a"]), Bm, Cm) + xh * q["ssm_d"][:, None]
    y = base.rmsnorm(y.reshape(Bb, S, -1) * F.silu(z), q["norm"], cfg["norm_eps"])
    return x + mm(y, q["out_proj"])


def forward(params: dict, cfg: dict, tokens, mm):
    """Logits (B, S, V) in f32 of tokens (B, S)."""
    x = params["embed"][tokens.long()]
    for i in range(cfg["n_layers"]):
        x = mamba2(params, f"layers.{i}", x, cfg, mm)
    return base.head(params, cfg, x, mm)


def forward_flops(cfg: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one forward over (batch, seq) tokens: every layer's
    Mamba2 block (``roofline.mamba2_layer_flops``) and the head's product
    at every position."""
    head = 2 * batch * seq * cfg["d_model"] * cfg["vocab"]
    return cfg["n_layers"] * roofline.mamba2_layer_flops(cfg, batch, seq) + head
