"""SAGe_Read output formatting (§5.3: "2-bit or 1-hot"): CUDA kernels,
their wrappers and their plain torch versions.

  * k-mer LM token ids (k bases packed into one id), replacing the TPU
    kernel ``kmer_pack_pallas`` (row math ``kmer_ids_row``);
  * one-hot bf16 planes, replacing ``one_hot_pallas`` (``one_hot_row``).

A wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.api import kmer_special_ids
from repro_torch.core.blocks import PAD_BASE
from repro_torch.kernels import cuda_lib

I32 = torch.int32
#: largest k whose ids (4**k + 2 at most) fit int32, as the JAX package's
MAX_KMER_K = 15


def kmer_pack_plain(tokens: torch.Tensor, k: int, n_tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pack base tokens (.., C) into k-mer ids (.., C//k), int32.

    Code 4 is both PAD (past each row's real length) and N (dropouts in
    escape reads). With ``n_tokens`` (per-row real-token count) a
    4-containing group entirely inside the read maps to the N-block id and
    groups at or past the boundary map to the pad id; without it every
    4-containing group maps to the pad id."""
    C = tokens.shape[-1]
    g = tokens[..., : (C // k) * k].reshape(*tokens.shape[:-1], C // k, k).to(I32)
    weights = 4 ** torch.arange(k - 1, -1, -1, dtype=I32, device=tokens.device)
    ids = (torch.where(g > 3, 0, g) * weights).sum(dim=-1, dtype=I32)
    sp = kmer_special_ids(k)
    has4 = (g == PAD_BASE).any(dim=-1)
    if n_tokens is None:
        return torch.where(has4, sp["pad"], ids).to(I32)
    gi = torch.arange(C // k, dtype=I32, device=tokens.device)
    in_read = (gi + 1) * k <= n_tokens.to(I32)[..., None]
    return torch.where(has4, torch.where(in_read, sp["nblk"], sp["pad"]), ids).to(I32)


def one_hot_plain(tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """(.., C) -> (.., C, 4); PAD and N rows are all zero."""
    t = tokens.to(I32)
    return (t[..., None] == torch.arange(4, dtype=I32, device=tokens.device)).to(dtype)


@functools.cache
def _lib():
    lib = cuda_lib.lib("reformat")
    lib.kmer_pack_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.kmer_pack_launch.restype = ctypes.c_int
    lib.kmer_pack_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.kmer_pack_plan.restype = None
    lib.one_hot_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.one_hot_launch.restype = ctypes.c_int
    lib.reformat_error_string.restype = ctypes.c_char_p
    return lib


def kmer_plan(nb: int, C: int, k: int) -> dict[str, object]:
    """How the k-mer kernel runs ``nb`` rows of ``C`` tokens at ``k``: its
    grid (row tiles, rows), threads a CTA, dynamic shared memory and ids a
    CTA (a row tile)."""
    out = (ctypes.c_int * 5)()
    _lib().kmer_pack_plan(nb, C, k, out)
    return {"grid": [out[0], out[1]], "threads": out[2], "smem_bytes": out[3], "tile_ids": out[4]}


def kmer_pack(tokens: torch.Tensor, k: int, n_tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (nb, C) int8 (+ per-block real-token counts (nb,)) ->
    (nb, C//k) int32 k-mer ids. CUDA: a CTA per 2048-id tile of a row."""
    if not 1 <= k <= MAX_KMER_K:
        raise ValueError(f"kmer_pack: k must be in 1..{MAX_KMER_K}, got {k}")
    if tokens.dim() != 2 or tokens.dtype != torch.int8:
        raise ValueError(f"kmer_pack: tokens must be (nb, C) int8, got {tokens.dtype} {tuple(tokens.shape)}")
    if cuda_lib.on_cpu(tokens, *([] if n_tokens is None else [n_tokens])):
        cuda_lib.COUNTS["plain:kmer_pack"] += 1
        return kmer_pack_plain(tokens, k, n_tokens)
    nb, C = tokens.shape
    if n_tokens is not None:
        n_tokens = n_tokens.to(I32).contiguous()
        if tuple(n_tokens.shape) != (nb,):
            raise ValueError(f"kmer_pack: n_tokens must be ({nb},)")
    cuda_lib.require_cuda(tokens, *([] if n_tokens is None else [n_tokens]), name="kmer_pack")
    out = torch.empty((nb, C // k), dtype=I32, device=tokens.device)
    lib = _lib()
    with torch.cuda.device(tokens.device):
        rc = lib.kmer_pack_launch(
            tokens.data_ptr(), None if n_tokens is None else n_tokens.data_ptr(),
            out.data_ptr(), nb, C, k, torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(rc, "kmer_pack", lib.reformat_error_string)
    cuda_lib.COUNTS["launch:kmer_pack"] += 1
    return out


def one_hot(tokens: torch.Tensor) -> torch.Tensor:
    """tokens (nb, C) int8 -> (nb, C, 4) bf16 (PAD/N rows all zero).
    CUDA: one thread per token, one 8-byte store of bf16 bit patterns."""
    if tokens.dim() != 2 or tokens.dtype != torch.int8:
        raise ValueError(f"one_hot: tokens must be (nb, C) int8, got {tokens.dtype} {tuple(tokens.shape)}")
    if cuda_lib.on_cpu(tokens):
        cuda_lib.COUNTS["plain:one_hot"] += 1
        return one_hot_plain(tokens)
    cuda_lib.require_cuda(tokens, name="one_hot")
    nb, C = tokens.shape
    out = torch.empty((nb, C, 4), dtype=torch.bfloat16, device=tokens.device)
    lib = _lib()
    with torch.cuda.device(tokens.device):
        rc = lib.one_hot_launch(tokens.data_ptr(), out.data_ptr(), nb * C,
                                torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "one_hot", lib.reformat_error_string)
    cuda_lib.COUNTS["launch:one_hot"] += 1
    return out
