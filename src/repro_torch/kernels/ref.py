"""Plain torch versions of every CUDA kernel of the port (the exact
targets the kernels are held to):

sage_unpack -> sage_decode.unpack_rows_plain
sage_decode -> core.decode_torch.decode_block_arrays (batched over blocks)
kmer_pack   -> reformat.kmer_pack_plain
one_hot     -> reformat.one_hot_plain
sage_fused  -> sage_decode.fused_decode_plain (gather, decode, format)
ssd_chunk   -> models.ssm.ssd_chunked (the model's own reference path);
               the intra-chunk block alone: ssd_chunk.ssd_intra_plain
ssd_chunk_bwd -> ssd_chunk.ssd_intra_bwd_plain (B6's gradient)
banded_align -> banded_align.align_scan_plain
"""

from __future__ import annotations

import torch

from repro_torch.core.decode_torch import DeviceBlocks, decode_block_arrays
from repro_torch.kernels.banded_align import align_scan_plain
from repro_torch.kernels.reformat import kmer_pack_plain, one_hot_plain
from repro_torch.kernels.sage_decode import fused_decode_plain, unpack_rows_plain
from repro_torch.models.ssm import ssd_chunked


def sage_unpack_ref(packed: torch.Tensor, dicts: torch.Tensor, widths) -> dict[str, torch.Tensor]:
    return unpack_rows_plain(packed, dicts, tuple((s, int(w)) for s, w in widths))


def sage_decode_ref(db: DeviceBlocks) -> dict[str, torch.Tensor]:
    return decode_block_arrays(db.arrays, caps=db.caps, classes=db.classes, fixed_len=db.fixed_len)


def sage_fused_ref(db: DeviceBlocks, ids, valid, fmt: str, kmer_k=None) -> dict[str, torch.Tensor]:
    return fused_decode_plain(db.arrays, ids, valid, caps=db.caps, classes=db.classes,
                              fixed_len=db.fixed_len, fmt=fmt, kmer_k=kmer_k)


def kmer_pack_ref(tokens: torch.Tensor, k: int, n_tokens=None) -> torch.Tensor:
    return kmer_pack_plain(tokens, k, n_tokens)


def one_hot_ref(tokens: torch.Tensor) -> torch.Tensor:
    return one_hot_plain(tokens)


def ssd_ref(x, dt, A, B_, C_, chunk: int, state0=None):
    """x: (B,S,H,P) etc. The model-layer SSD reference."""
    return ssd_chunked(x, dt, A, B_, C_, chunk, state0)


def banded_align_ref(reads, wins, off0, wlen, *, band: int):
    return align_scan_plain(reads, wins, off0, wlen, band=band)
