"""Serving entry point: SAGe's k-mer prompts into the LM engine.

:func:`prompts_from_store` turns decoded reads of a stored dataset into
k-mer token prompts. :class:`ServingEngine` runs padded-slot prefill and a
decode loop over one model (greedy or temperature sampling) on the device
of the model's parameters. The multi-tenant front door, ``SageServer``, is
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.api import pick_k
from repro_torch.models import lm


def prompts_from_store(
    session,
    name: str,
    *,
    vocab: int,
    n_prompts: int = 8,
    max_prompt: int = 64,
    kmer_k: Optional[int] = None,
    block_range=None,
) -> list[np.ndarray]:
    """SAGe_Read -> serving prompt feed: decoded reads of a stored dataset as
    k-mer token prompts (the paper's "send each read to the analysis system
    as soon as it is decoded" contract, §5.1).

    Walks the requested block range in order and emits one prompt per read
    (its k-mer token prefix, folded into ``vocab``) until ``n_prompts``.
    Fewer than ``n_prompts`` reads yields fewer prompts; reads shorter than
    one k-mer are skipped (a range of only those yields ``[]``); prompts
    truncate to their first ``max_prompt`` k-mers — the same prefix
    :meth:`ServingEngine.generate` keeps when a prompt overflows its slot."""
    k = kmer_k if kmer_k is not None else pick_k(vocab)
    out = session.read(name, block_range, fmt="kmer", kmer_k=k)
    km = out["kmer"]  # stays on the device
    starts, lens = out["read_start"].cpu().numpy(), out["read_len"].cpu().numpy()
    n_reads = out["n_reads"].cpu().numpy()
    # one indexed gather over (read_start, read_len): enumerate real reads in
    # (block, read) order, apply the n_prompts cutoff, and pull every
    # prompt's k-mer span out of the device tensor at once; the only large
    # host copy is the gathered prompt tokens themselves
    n_r = np.minimum(n_reads, starts.shape[1])
    keep = np.arange(starts.shape[1])[None, :] < n_r[:, None]
    keep &= lens // k > 0  # zero-k-mer reads are skipped, not emitted
    bi, ri = np.nonzero(keep)  # row-major == (block, read) order
    bi, ri = bi[:n_prompts], ri[:n_prompts]
    if bi.size == 0:
        return []
    starts_k = starts[bi, ri] // k
    spans = np.minimum(lens[bi, ri] // k, max_prompt)
    ends = np.cumsum(spans)
    offs = ends - spans
    row = np.repeat(bi, spans)
    col = starts_k.repeat(spans) + np.arange(ends[-1]) - offs.repeat(spans)
    idx = [torch.as_tensor(a, dtype=torch.int64, device=km.device) for a in (row, col)]
    flat = (km[idx[0], idx[1]] % vocab).to(torch.int32).cpu().numpy()
    return [flat[o:e] for o, e in zip(offs, ends)]


@dataclasses.dataclass
class ServeConfig:
    max_prompt: int = 512
    max_new: int = 64
    temperature: float = 0.0  # 0 => greedy
    seed: int = 0


class ServingEngine:
    """Padded-slot prefill + decode loop over one model, on the device of
    its parameters (``lm.init_params`` builds on ``cuda`` unless asked for
    the CPU).

    Each engine owns its own :class:`ServeConfig` (``sc=None`` constructs a
    per-instance default — a shared default instance would alias sampling
    state across every engine in the process). Sampling draws from a
    ``torch.Generator`` seeded with ``sc.seed``; its bits differ from
    ``jax.random``'s, greedy decoding does not depend on them."""

    def __init__(self, cfg, model: lm.Mamba2LM, sc: Optional[ServeConfig] = None) -> None:
        self.cfg = cfg
        self.model = model
        self.sc = sc if sc is not None else ServeConfig()
        self.device = model.embed.device

    def _sample(self, lg: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        """Next-token selection — the ONE temperature guard both prefill
        sampling and the decode loop share (greedy at 0; the 1e-6 floor
        keeps a denormal temperature from blowing up the logit scale)."""
        if self.sc.temperature > 0:
            probs = torch.softmax(lg / max(self.sc.temperature, 1e-6), dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            nxt = torch.argmax(lg, dim=-1)
        return nxt.to(torch.int32)

    @torch.no_grad()
    def generate(self, prompts: list[np.ndarray]) -> list[np.ndarray]:
        """prompts: list of int32 token arrays (longer than ``max_prompt``
        keeps the first ``max_prompt`` tokens — prefix truncation, matching
        ``prompts_from_store``). Returns ``max_new`` tokens per prompt,
        copied to the host once at the end."""
        B = len(prompts)
        if B == 0:
            return []
        P = self.sc.max_prompt
        toks = np.zeros((B, P), np.int32)
        for i, p in enumerate(prompts):
            p = p[:P]
            toks[i, -len(p):] = p  # left-pad (keeps last token at P-1)
        max_len = P + self.sc.max_new + 1
        tok = torch.as_tensor(toks, dtype=torch.int64, device=self.device)
        logits, cache = lm.prefill(self.model, self.cfg, tok, max_len)
        gen = torch.Generator(device=self.device).manual_seed(self.sc.seed)
        cur = self._sample(logits[:, -1].float(), gen)[:, None]
        outs = [cur]
        for t in range(self.sc.max_new - 1):
            logits, cache = lm.decode_step(self.model, self.cfg, cur.long(), cache, P + t)
            cur = self._sample(logits[:, -1].float(), gen)[:, None]
            outs.append(cur)
        gen_toks = torch.cat(outs, dim=1).cpu().numpy()
        return [gen_toks[i] for i in range(B)]


class SageServer:
    """The multi-tenant serving frontend (scheduler, continuous batching,
    session pool) is not ported yet."""

    def __init__(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "SageServer is not ported yet (ROADMAP Queue A, slice 5: serving frontend, "
            "with SessionPool, the scheduler and the batcher)"
        )


__all__ = ["prompts_from_store", "ServeConfig", "ServingEngine", "SageServer"]
