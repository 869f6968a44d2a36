"""GenStore-style in-storage filter on decoded SAGe planes, in PyTorch (the
paper's ISF partner; the counterpart of the JAX package's ``filter_jax``).

GenStore-EM prunes exactly-matching reads before the expensive mapper. The
filter runs on SAGe decode outputs on their device: a read whose decode
carries a match position is compared against the consensus window, every
read of every block in one pass of torch ops (a gather of each read's
tokens and window bases, a mismatch count per read); reads that are not
exact can be bounded with the Myers bit-vector edit distance, one step per
text character over a batch of reads in 32-bit lanes (carried in int64
masked to 32 bits: torch has no general uint32 arithmetic).

This is the "SAGe_ISP" path: decode -> filter -> (pruned) analysis.
"""

from __future__ import annotations

import numpy as np
import torch

_U32 = 0xFFFFFFFF
_INF = 1 << 20


def exact_match_mask(tokens, read_start, read_len, read_pos, read_rev, cons_window):
    """Exact-match check of up to R reads a decoded block.

    tokens: (C,) int8 decoded bases; read_*: (R,); cons_window: (W,) int8
    consensus slice (block-local coordinates). Leading block dims are
    allowed on every argument ((nb, C), (nb, R), (nb, W)). Returns (.., R)
    bool, True = prune: every base of the read's token span equals the
    window base at ``read_pos`` (indices clipped to the window, as the JAX
    version's gather clips), ``read_pos >= 0`` and the read is forward (a
    reverse read needs the window's reverse complement and falls through to
    the mapper)."""
    one = tokens.dim() == 1
    if one:
        tokens, read_start, read_len, read_pos, read_rev, cons_window = (
            t[None] for t in (tokens, read_start, read_len, read_pos, read_rev, cons_window))
    nb, C = tokens.shape
    R, W = read_start.shape[1], cons_window.shape[1]
    dev = tokens.device
    s, p = read_start.long(), read_pos.long()
    lo = s.clamp(0, C)
    hi = (s + read_len.long()).clamp(0, C)
    n = (hi - lo).clamp(min=0).reshape(-1)  # tokens of each read inside the row
    rid = torch.repeat_interleave(torch.arange(nb * R, device=dev), n)
    off = torch.arange(rid.numel(), device=dev) - (torch.cumsum(n, 0) - n)[rid]
    idx = lo.reshape(-1)[rid] + off
    j = (idx - s.reshape(-1)[rid] + p.reshape(-1)[rid]).clamp(0, W - 1)
    blk = rid // R
    mism = tokens.reshape(-1)[blk * C + idx] != cons_window.reshape(-1)[blk * W + j]
    bad = torch.zeros(nb * R, dtype=torch.int64, device=dev).index_add_(0, rid, mism.long())
    mask = (bad.view(nb, R) == 0) & (p >= 0) & (read_rev == 0)
    return mask[0] if one else mask


def myers_distance(read, pattern_len, text, text_len):
    """Bit-parallel Myers edit distance of ``read[:pattern_len]`` (<= 32)
    against ``text[:text_len]``; the least edit distance over text end
    positions (free text start). Batched over reads: read (B, P),
    pattern_len (B,), text (B, T), text_len (B,) give (B,) int32; 1-D
    read and text with 0-d lengths give a 0-d result.

    Classic Pv/Mv recurrence, one step a text character. The 32-bit lanes
    are int64 masked to 32 bits; a shift by 32 or more gives 0, as XLA's
    does (``pattern_len`` 0 makes the score bit 1 << 0xFFFFFFFF = 0)."""
    one = read.dim() == 1
    if one:
        read, text = read[None], text[None]
        pattern_len, text_len = pattern_len.reshape(1), text_len.reshape(1)
    dev = read.device
    B, P = read.shape
    plen = pattern_len.long()
    tlen = text_len.long()
    peq = torch.zeros((B, 4), dtype=torch.int64, device=dev)
    for i in range(32):
        c = read[:, min(i, P - 1)].long().clamp(0, 3)  # index clamped as JAX's
        bit = torch.where(i < plen, 1 << i, 0)
        peq.scatter_add_(1, c[:, None], bit[:, None])
    peq &= _U32
    sh = (plen - 1) & _U32
    hibit = torch.where(sh < 32, 1 << sh.clamp(max=31), 0)
    pv = torch.full((B,), _U32, dtype=torch.int64, device=dev)
    mv = torch.zeros((B,), dtype=torch.int64, device=dev)
    score = pattern_len.to(torch.int32)
    best = torch.full((B,), _INF, dtype=torch.int32, device=dev)
    for pos in range(text.shape[1]):
        live = pos < tlen
        eq = torch.where(live, torch.gather(peq, 1, text[:, pos].long().clamp(0, 3)[:, None])[:, 0], 0)
        xv = eq | mv
        xh = ((((eq & pv) + pv) & _U32) ^ pv) | eq
        ph = mv | (~(xh | pv) & _U32)
        mh = pv & xh
        score = score + ((ph & hibit) != 0).to(torch.int32) - ((mh & hibit) != 0).to(torch.int32)
        ph2 = (ph << 1) & _U32  # search variant: free text start (no |1)
        mh2 = (mh << 1) & _U32
        pv = mh2 | (~(xv | ph2) & _U32)
        mv = ph2 & xv
        best = torch.where(live & (score < best), score, best)
    out = torch.minimum(best, score)
    return out[0] if one else out


def filter_block(decoded: dict, cons_window, max_k: int = 2):
    """SAGe_ISP filter of decoded blocks: returns (prune_mask, n_pruned).

    prune = exact match (GenStore-EM) among a block's real reads — callers
    map only the survivors. One block ((C,) tokens, (R,) planes, 0-d
    ``n_reads``) gives an (R,) mask and a 0-d count; (nb, ..) planes give
    (nb, R) and (nb,)."""
    mask = exact_match_mask(
        decoded["tokens"], decoded["read_start"], decoded["read_len"],
        decoded["read_pos"], decoded["read_rev"], cons_window,
    )
    R = mask.shape[-1]
    valid = torch.arange(R, device=mask.device) < decoded["n_reads"][..., None]
    mask = mask & valid
    return mask, mask.sum(-1)


def filter_store_blocks(session, name: str, block_range=None):
    """Store-backed SAGe_ISP filter: decode a block range through a
    :class:`repro_torch.core.store.SageReadSession` and exact-prune every
    block of it at once, on the store's device.

    Returns ``(masks, pruned, total)``: per-block prune masks (block-major
    numpy bool array aligned with the range's blocks) plus aggregate
    counts."""
    out = session.read(name, block_range)
    ids = out["block_ids"]
    wins, starts = session.store.consensus_windows(name, ids)
    dev = out["tokens"].device
    dec = {k: v for k, v in out.items() if k != "block_ids"}
    starts_t = torch.as_tensor(starts, device=dev)[:, None]
    # decode reports GLOBAL positions; the filter works block-locally
    dec["read_pos"] = torch.where(dec["read_pos"] >= 0, dec["read_pos"] - starts_t, -1)
    mask, n = filter_block(dec, torch.as_tensor(np.ascontiguousarray(wins), device=dev))
    return mask.cpu().numpy(), int(n.sum()), int(out["n_reads"].sum())
