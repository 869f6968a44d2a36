"""Shared model layers (torch), the parts the SSM family needs, and the
loss.

Conventions, as in the JAX package: activations flow in a compute dtype
(bf16 by default), parameters live in f32, matrices are ``(d_in, d_out)``
and applied as ``x @ W``. Initialisers draw from an explicit
``torch.Generator`` on the device that holds the result; their numbers differ from ``jax.random``'s, so tests
carry the JAX package's weights across (``repro_torch.convert``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

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


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 z_loss: float = 0.0) -> torch.Tensor:
    """Stable cross-entropy in f32; logits (..., V), labels (...) of any
    integer type (the token pipeline yields int32; the gather takes an int64
    copy). With ``mask``, the masked mean over at least one position."""
    lf = logits.to(F32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.to(torch.int64)[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse**2
    if mask is not None:
        loss = loss * mask
        return loss.sum() / torch.clamp(mask.sum(), min=1)
    return loss.mean()
