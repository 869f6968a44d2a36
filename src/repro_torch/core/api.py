"""SAGe interface commands (§5.3 analogue) + the output-format registry.

The paper's three NVMe commands map onto the session-based store
(:mod:`repro_torch.core.store`):

  SAGe_Write -> ``SageStore.write`` / ``SageReadSession.write``
  SAGe_Read  -> ``SageReadSession.read(name, block_range, fmt)``
  SAGe_ISP   -> ``SageReadSession.read_stream(name, consumer)``

This module holds the format math, the pluggable :class:`FormatSpec`
registry, and the one-shot ``sage_write``/``sage_read`` wrappers. The k-mer
and one-hot formats run the CUDA reformat kernels on CUDA tensors and their
plain torch versions on CPU tensors (:mod:`repro_torch.kernels.reformat`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.decode_torch import (
    DeviceBlocks,
    decode_blocks_bucketed,
    prepare_device_blocks,
    register_format_fuser,
)
from repro_torch.core.encoder import SageEncoder
from repro_torch.core.format import SageFile
from repro_torch.genomics.synth import ReadSet


class OutputFormat(enum.Enum):
    """Legacy closed enum — an alias set over the open :class:`FormatSpec`
    registry (``get_format`` accepts either)."""

    TOKENS_2BIT = "2bit"  # int8 base codes 0..3 (PAD_BASE padding)
    ONE_HOT = "onehot"  # (.., 4) bfloat16 one-hot
    KMER = "kmer"  # packed k-mer LM token ids


# -- k-mer token space ------------------------------------------------------
def kmer_vocab_size(k: int) -> int:
    return 4**k + 3  # + PAD, BOS, NBLK


def kmer_special_ids(k: int) -> dict[str, int]:
    return {"pad": 4**k, "bos": 4**k + 1, "nblk": 4**k + 2}


def pick_k(vocab_size: int, max_k: int = 8) -> int:
    """Largest k with 4^k + specials <= vocab (how arch vocabs map to DNA)."""
    k = 1
    while k < max_k and kmer_vocab_size(k + 1) <= vocab_size:
        k += 1
    return k


def kmer_pack(tokens: torch.Tensor, k: int, n_tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pack (nb, C) int8 base tokens into (nb, C//k) int32 k-mer ids.

    Code 4 is both PAD and N; ``n_tokens`` (per-row real-token count)
    disambiguates: a 4-containing group entirely inside ``n_tokens`` maps
    to the N-block id, groups at or past it map to the pad id. Without
    ``n_tokens`` every 4-containing group maps to the pad id."""
    from repro_torch.kernels.reformat import kmer_pack as _kmer

    return _kmer(tokens, k, n_tokens)


def one_hot_bases(tokens: torch.Tensor) -> torch.Tensor:
    """(nb, C) int8 -> (nb, C, 4) bf16; PAD and N rows are all zero."""
    from repro_torch.kernels.reformat import one_hot

    return one_hot(tokens)


# -- output-format registry -------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FormatSpec:
    """One SAGe_Read output format.

    ``apply(tokens, *, kmer_k, n_tokens)`` converts decoded base tokens into
    the format's array (``n_tokens`` is the decode dict's per-row real-token
    count); ``None`` means the raw 2-bit tokens are already the answer."""

    name: str  # registry key (the ``fmt=`` string)
    out_key: str  # key the formatted array appears under in the read result
    apply: Optional[Callable[..., torch.Tensor]] = None
    requires_k: bool = False
    doc: str = ""


def _apply_one_hot(tokens, *, kmer_k=None, n_tokens=None):
    return one_hot_bases(tokens)


def _apply_kmer(tokens, *, kmer_k, n_tokens=None):
    return kmer_pack(tokens, kmer_k, n_tokens)


_FORMATS: dict[str, FormatSpec] = {}


def register_format(spec: FormatSpec, *, replace: bool = False) -> FormatSpec:
    """Register an output format; a name collision raises ``ValueError``
    unless ``replace=True``."""
    if spec.name in _FORMATS and not replace:
        raise ValueError(
            f"output format {spec.name!r} is already registered; pass "
            f"replace=True to override it (registered: {available_formats()})"
        )
    _FORMATS[spec.name] = spec
    return spec


def available_formats() -> tuple[str, ...]:
    return tuple(sorted(_FORMATS))


def get_format(fmt) -> FormatSpec:
    """Resolve ``fmt`` — a registry name, :class:`FormatSpec`, or legacy
    :class:`OutputFormat` member — to its spec."""
    if isinstance(fmt, FormatSpec):
        return fmt
    key = fmt.value if isinstance(fmt, OutputFormat) else str(fmt)
    if key not in _FORMATS:
        raise ValueError(f"unknown output format {key!r}; registered: {available_formats()}")
    return _FORMATS[key]


def apply_format(
    out: dict[str, torch.Tensor],
    fmt,
    *,
    kmer_k: Optional[int] = None,
    context: str = "sage_read",
) -> dict[str, torch.Tensor]:
    """Attach ``fmt``'s array to a decode result dict (in place) and return it."""
    spec = get_format(fmt)
    if spec.requires_k and kmer_k is None:
        raise ValueError(
            f"{context}: format {spec.name!r} requires kmer_k "
            f"(registered formats: {available_formats()})"
        )
    if spec.apply is not None:
        out[spec.out_key] = spec.apply(out["tokens"], kmer_k=kmer_k, n_tokens=out.get("n_tokens"))
    return out


register_format(FormatSpec("2bit", "tokens", None, doc="int8 base codes 0..3, PAD=4"))
register_format(FormatSpec("onehot", "onehot", _apply_one_hot, doc="(.., C, 4) bf16 one-hot"))
register_format(FormatSpec("kmer", "kmer", _apply_kmer, requires_k=True, doc="packed k-mer LM ids"))

# fusers for the single-launch decode+format path (fused sessions): the same
# expressions as the two-step appliers above. The fused kernel B5 computes
# these three itself as its epilogues, bit for bit; formats registered later
# with a fuser run it on B5's 2bit output, and formats without one take the
# two-step path.
register_format_fuser("2bit", "tokens", None)
register_format_fuser("onehot", "onehot", lambda dec, kmer_k: one_hot_bases(dec["tokens"]))
register_format_fuser("kmer", "kmer", lambda dec, kmer_k: kmer_pack(dec["tokens"], kmer_k, dec["n_tokens"]))


# -- one-shot commands (compat wrappers; consumers use SageStore) -----------
def sage_write(rs: ReadSet, consensus: np.ndarray, token_target: int = 65536, **enc_kwargs) -> SageFile:
    """Compress a read set against a consensus (SAGe_Write); ``enc_kwargs``
    go to :class:`SageEncoder` (``device=`` is where the batched encoder's
    DP and verify run, ``"cuda"`` by default)."""
    return SageEncoder(consensus, token_target=token_target, **enc_kwargs).encode(rs)


def sage_read(
    sf_or_db: SageFile | DeviceBlocks,
    fmt="2bit",
    kmer_k: Optional[int] = None,
    *,
    device="cuda",
) -> dict[str, torch.Tensor]:
    """Decode all blocks to the requested format on ``device`` (SAGe_Read,
    one-shot form), through the same buckets as the store sessions."""
    db = sf_or_db if isinstance(sf_or_db, DeviceBlocks) else prepare_device_blocks(sf_or_db)
    db = db.to(device)
    out = decode_blocks_bucketed(db, np.arange(db.n_blocks, dtype=np.int64))
    return apply_format(dict(out), fmt, kmer_k=kmer_k)
