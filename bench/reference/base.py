"""Pieces every plain reference shares: the parameter list and how each
parameter is drawn, the precision of the matrix products, RMS norm, the
loss and AdamW. Plain PyTorch in f32; nothing here imports the program.

A configuration is a plain dict (the ``arch`` of a file under
``bench/configs/``). Parameters are named as the system under test names
them (``layers.<i>.ssm.in_x``), so the benchmark hands one set of weights
to both sides; matrices are ``(d_in, d_out)`` and applied as ``x @ W``.
"""

from __future__ import annotations

import contextlib
import math

import torch

F32 = torch.float32
FP8_MAX = 448.0  #: the largest float8 e4m3 value


@contextlib.contextmanager
def exact_f32():
    """f32 matrix products in f32: TF32 off for cuBLAS and cuDNN while the
    reference runs, as it was before afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale a tensor (its largest
    magnitude to 448), back in f32; gradients pass straight through."""
    s = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(F32) * s
    return t + (q - t).detach()


def matmul(precision: str):
    """``x @ w`` in the given precision: ``f32``, or ``fp8`` (both operands
    rounded to float8 e4m3, the product summed in f32): the precision
    below the system's bf16 that a later change might be tempted by."""
    if precision == "f32":
        return lambda x, w: x @ w
    if precision == "fp8":
        return lambda x, w: _fp8(x) @ _fp8(w)
    raise ValueError(f"unknown precision {precision!r}")


def rmsnorm(x, scale, eps: float):
    """RMS norm; the scale is stored as an offset from 1."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + scale)


def xent(logits, labels):
    """Mean softmax cross-entropy over every position."""
    lse = torch.logsumexp(logits, dim=-1)
    return (lse - torch.gather(logits, -1, labels.long()[..., None])[..., 0]).mean()


# ---------------------------------------------------------------- parameters
# a spec entry: (name, shape, how, arg); how is "normal" (arg: the scale),
# "zeros", "ones", "const" (arg: the value) or "log_linspace" (arg: (lo, hi))

def dense(name: str, d_in: int, d_out: int) -> tuple:
    return (name, (d_in, d_out), "normal", 1.0 / math.sqrt(d_in))


def mamba2_spec(cfg: dict, p: str) -> list:
    """A pre-norm Mamba2 block's parameters under the prefix ``p``."""
    d, di, H = cfg["d_model"], cfg["d_inner"], cfg["d_inner"] // cfg["ssm_headdim"]
    gn, w = 2 * cfg["ssm_groups"] * cfg["ssm_state"], cfg["ssm_conv"]
    return [
        (f"{p}.norm1", (d,), "zeros", None),
        dense(f"{p}.ssm.in_z", d, di), dense(f"{p}.ssm.in_x", d, di), dense(f"{p}.ssm.in_bc", d, gn),
        dense(f"{p}.ssm.dt_w", d, H),
        (f"{p}.ssm.dt_bias", (H,), "const", math.log(math.expm1(0.01))),
        (f"{p}.ssm.ssm_a", (H,), "log_linspace", (1.0, 16.0)),  # A = -exp(a): -1 .. -16 over the heads
        (f"{p}.ssm.ssm_d", (H,), "ones", None),
        (f"{p}.ssm.conv_x", (w, di), "normal", 0.2), (f"{p}.ssm.conv_bc", (w, gn), "normal", 0.2),
        (f"{p}.ssm.norm", (di,), "zeros", None),
        dense(f"{p}.ssm.out_proj", di, d),
    ]


def lm_spec(cfg: dict) -> list:
    """Embedding, final norm and (untied) head."""
    out = [("embed", (cfg["vocab"], cfg["d_model"]), "normal", 0.02), ("norm_f", (cfg["d_model"],), "zeros", None)]
    if not cfg["tie_embeddings"]:
        out.append(dense("lm_head", cfg["d_model"], cfg["vocab"]))
    return out


def head(params: dict, cfg: dict, x, mm):
    """Final norm and the logits (f32)."""
    x = rmsnorm(x, params["norm_f"], cfg["norm_eps"])
    w = params["embed"].T if cfg["tie_embeddings"] else params["lm_head"]
    return mm(x, w)


# ---------------------------------------------------------------- AdamW
def lr_at(c: dict, step: int) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_frac`` of ``lr``."""
    warm = min(step / max(c["warmup_steps"], 1), 1.0)
    t = min(max((step - c["warmup_steps"]) / max(c["total_steps"] - c["warmup_steps"], 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * t))
    return c["lr"] * warm * (c["min_lr_frac"] + (1 - c["min_lr_frac"]) * cos)


@torch.no_grad()
def adamw_step(c: dict, params: dict, grads: dict, m: dict, v: dict, step: int) -> None:
    """One AdamW step in place (``step`` counts from 1): gradients clipped
    to a global norm of ``grad_clip``, bias-corrected moments, decoupled
    weight decay on every parameter."""
    gn = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads.values()))
    clip = min(c["grad_clip"] / max(gn, 1e-9), 1.0) if c["grad_clip"] else 1.0
    lr = lr_at(c, step)
    b1c, b2c = 1 - c["b1"] ** step, 1 - c["b2"] ** step
    for k, p in params.items():
        g = grads[k] * clip
        m[k].mul_(c["b1"]).add_(g, alpha=1 - c["b1"])
        v[k].mul_(c["b2"]).addcmul_(g, g, value=1 - c["b2"])
        upd = (m[k] / b1c) / (torch.sqrt(v[k] / b2c) + c["eps"]) + c["weight_decay"] * p
        p.sub_(lr * upd)
