"""The port's kernels as ops: each routes by the device of its inputs —
the hand-written CUDA kernel for CUDA tensors, the plain torch version
(kernels/ref.py) for CPU tensors. There is no switch: the device decides.
"""

from __future__ import annotations

import torch

from repro_torch.core.decode_torch import DeviceBlocks
from repro_torch.kernels import reformat
from repro_torch.kernels.sage_decode import sage_decode_arrays, sage_fused_decode, sage_unpack


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
