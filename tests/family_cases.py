"""Inputs and the decode duality of the vlm and encdec families, shared by
tests/test_torch_vlm_encdec.py and chip_smoke.py (imports only the port, so
it runs where JAX is not installed)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm

F32 = torch.float32


def family_inputs(cfg, batch: int, n: int, seed: int, device="cpu", dtype=F32) -> dict:
    """The vlm family's ``patch_embeds`` or the encdec family's ``frames``,
    (batch, n, d_model) standard normal draws of a seeded numpy generator
    in ``dtype`` on ``device``, as ``lm.forward``'s keyword; ``{}`` for the
    other families."""
    key = {"vlm": "patch_embeds", "encdec": "frames"}.get(cfg.family)
    if key is None:
        return {}
    x = np.random.default_rng(seed).standard_normal((batch, n, cfg.d_model)).astype(np.float32)
    return {key: torch.from_numpy(x).to(device=device, dtype=dtype)}


@torch.no_grad()
def prefix_duality(model, cfg, tokens, extra: dict, chunk: int, max_len=None):
    """The duality of a vlm or encdec model, f32: a prefill of the first
    token (after the vlm's patches; the encdec's frames in its encoder),
    then one decode step a token at ``n_img + t``, against the training
    forward's logits; and the cache those steps built against a prefill of
    every token. ``max_len`` defaults to n_img + T (vlm) or the frames'
    count (encdec: the cross attention reads every slot of the cache).
    Returns (stepped logits (B, T, V), forward logits, stepped cache,
    prefilled cache)."""
    T = tokens.shape[1]
    n_img = extra["patch_embeds"].shape[1] if "patch_embeds" in extra else 0
    if max_len is None:
        max_len = n_img + T if "patch_embeds" in extra else extra["frames"].shape[1]
    full, _ = lm.forward(model, cfg, tokens, chunk=chunk, dtype=F32, **extra)
    lg, cache = lm.prefill(model, cfg, tokens[:, :1], max_len, chunk=chunk, dtype=F32, **extra)
    outs = [lg[:, 0]]
    for t in range(1, T):
        lg, cache = lm.decode_step(model, cfg, tokens[:, t:t + 1], cache, n_img + t, dtype=F32)
        outs.append(lg[:, 0])
    _, pre = lm.prefill(model, cfg, tokens, max_len, chunk=chunk, dtype=F32, **extra)
    return torch.stack(outs, dim=1), full, cache, pre
