"""The port's kernels as ops: each routes by the device of its inputs —
the hand-written CUDA kernel for CUDA tensors, the plain torch version
(kernels/ref.py) for CPU tensors. There is no switch: the device decides.
``ssd`` runs the SSD intra-chunk kernel (B6) and the chunk-state chain,
the recurrence across chunks;
``banded_align`` is the SAGe_Write mapper's batched DP.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core.decode_torch import DeviceBlocks
from repro_torch.kernels import reformat
from repro_torch.kernels.banded_align import align_scan
from repro_torch.kernels.sage_decode import sage_decode_arrays, sage_fused_decode, sage_unpack
from repro_torch.kernels.ssd_chain import ssd_chain
from repro_torch.kernels.ssd_chunk import ssd_intra

F32 = torch.float32


def unpack(packed: torch.Tensor, dicts: torch.Tensor, widths) -> dict[str, torch.Tensor]:
    """Codec extent payloads -> per-stream block rows."""
    return sage_unpack(packed, dicts, widths)


def sage_decode(db: DeviceBlocks) -> dict[str, torch.Tensor]:
    """Decode all blocks -> dict(tokens, read_pos, read_rev, ...)."""
    return sage_decode_arrays(db.arrays, caps=db.caps, classes=db.classes, fixed_len=db.fixed_len)


def sage_fused(db: DeviceBlocks, ids, valid, fmt: str, kmer_k=None) -> dict[str, torch.Tensor]:
    """Gather rows ``ids`` of the resident blocks, decode them masked by
    ``valid`` and format them (``2bit`` / ``kmer`` / ``onehot``) in one
    launch."""
    return sage_fused_decode(db.arrays, ids, valid, caps=db.caps, classes=db.classes,
                             fixed_len=db.fixed_len, fmt=fmt, kmer_k=kmer_k, upload=db.upload)


def kmer_tokens(tokens: torch.Tensor, k: int, n_tokens=None) -> torch.Tensor:
    return reformat.kmer_pack(tokens, k, n_tokens)


def one_hot(tokens: torch.Tensor) -> torch.Tensor:
    return reformat.one_hot(tokens)


def banded_align(reads, wins, off0, wlen, *, band: int):
    """Banded edit-distance DP of a batch of same-length reads -> (moves
    (B, L, 2*band+1) uint8, last row (B, 2*band+1) int32)."""
    return align_scan(reads, wins, off0, wlen, band=band)


def ssd(x, dt, A, B_, C_, chunk: int, state0=None):
    """Full SSD: the intra-chunk kernel (B6) and the chunk-state chain, the
    recurrence across chunks (``kernels.ssd_chain``).

    x: (B,S,H,P); dt: (B,S,H) (post-softplus); A: (H,) negative; B_, C_:
    (B,S,H,N). Returns (y (B,S,H,P) in x's dtype, final state (B,H,P,N)
    f32). Same padding as ``models.ssm.ssd_chunked``: chunks of
    Q = min(chunk, S), padded steps carry dt = 0. The kernel writes the
    intra-chunk term in x's dtype, so in bf16 it is rounded before the state
    term is added (``ssd_chunked`` rounds once); the chain adds the state
    term in f32 and rounds y once more. Under autograd the two run as
    ``SsdIntra`` and ``SsdChain``, each with its gradient kernel; the padding
    is sliced off, so no gradient reaches it."""
    Bb, S0, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S0)
    pad = (-S0) % Q
    S = S0 + pad
    nc = S // Q
    with obs.span("rt.ssm.ssd_prep"):
        if pad:
            x, dt, B_, C_ = (F.pad(t, [0, 0] * (t.dim() - 2) + [0, pad]) for t in (x, dt, B_, C_))
        a = dt.to(F32) * A.to(F32)[None, None, :]
        xc = x.reshape(Bb, nc, Q, H, P).contiguous()
        dtc = dt.reshape(Bb, nc, Q, H).to(F32).contiguous()
        ac = a.reshape(Bb, nc, Q, H).contiguous()
        Bc = B_.reshape(Bb, nc, Q, H, N).to(F32).contiguous()
        Cc = C_.reshape(Bb, nc, Q, H, N).to(F32).contiguous()

    with obs.span("rt.ssm.b6"):
        y_intra, st_c, total = ssd_intra(xc, dtc, ac, Bc, Cc)

    with obs.span("rt.ssm.ssd_state"):
        y, state = ssd_chain(y_intra, st_c, total, ac, Cc, state0)
        return y.reshape(Bb, S, H, P)[:, :S0], state
