"""Codec unpack, block decode and fused gather+decode+format: CUDA kernels,
their wrappers and the plain torch versions of the unpack and the fused
decode.

``sage_unpack`` replaces the TPU kernel ``sage_unpack_pallas``,
``sage_decode_arrays`` replaces ``sage_decode_arrays`` / ``_kernel`` and
``sage_fused_decode`` replaces ``_build_pallas_fused`` / ``_fused_kernel``
(src/repro/kernels/sage_decode.py). A wrapper launches its kernel for CUDA
tensors (sources in ``csrc/``, built at first use) and takes the plain
version only for CPU tensors; on any other device it raises. The plain
block decode is :func:`repro_torch.core.decode_torch.decode_block_arrays`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.codec import DESC_WORDS, ESCAPE, MODE_NIBBLE, USED_MASK
import numpy as np

from repro_torch.core.decode_torch import Uploader, decode_block_arrays, empty_decode, to_i32_bits
from repro_torch.core.format import D, STREAMS
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.reformat import MAX_KMER_K, kmer_pack_plain, one_hot_plain

OUT_KEYS = ("tokens", "read_pos", "read_rev", "read_start", "read_len", "read_corner")
I32 = torch.int32
_MAXCLS = 8
#: formats B5 writes itself, and the epilogue code its launcher takes
FUSED_EPILOGUES = {"2bit": 0, "kmer": 1, "onehot": 2}


# --------------------------------------------------------------------------
# codec unpack (B1)
# --------------------------------------------------------------------------

def unpack_rows_plain(packed: torch.Tensor, dicts: torch.Tensor, widths) -> dict[str, torch.Tensor]:
    """Plain torch codec unpack, batched over rows (mirrors the JAX
    package's ``_unpack_rows_jit``). ``packed`` (n, cap) int32 bits,
    ``dicts`` (N_STREAMS, 16) uint8, ``widths`` ((stream, W), ...)."""
    n, cap = packed.shape
    dev = packed.device
    P = packed.to(torch.int64) & 0xFFFFFFFF
    ns = len(widths)
    desc = packed[:, :ns].to(I32)
    used = desc & USED_MASK
    modes = (desc >> 20) & 3
    nesc = packed[:, ns:DESC_WORDS].to(I32)
    sec = torch.where(modes == MODE_NIBBLE, (used + 1) // 2 + (nesc + 3) // 4, used)
    sec_off = DESC_WORDS + torch.cat(
        [torch.zeros((n, 1), dtype=I32, device=dev), torch.cumsum(sec, dim=1, dtype=I32)[:, :-1]],
        dim=1,
    )
    lut = dicts.to(torch.int64)
    out: dict[str, torch.Tensor] = {}
    for si, (s, w) in enumerate(widths):
        u = used[:, si : si + 1]
        off = sec_off[:, si : si + 1]
        kw = torch.arange(w, dtype=I32, device=dev)[None, :]
        raw = torch.where(
            kw < u, torch.gather(P, 1, (off + kw).clamp(0, cap - 1).to(torch.int64).expand(n, w)), 0
        )
        kb = torch.arange(4 * w, dtype=I32, device=dev)[None, :]
        nib = (
            torch.gather(P, 1, (off + kb // 8).clamp(0, cap - 1).to(torch.int64).expand(n, 4 * w))
            >> (4 * (kb % 8)).to(torch.int64)
        ) & 15
        in_use = kb < 4 * u
        is_esc = (nib == ESCAPE) & in_use
        ie = is_esc.to(I32)
        rank = torch.cumsum(ie, dim=1, dtype=I32) - ie
        eoff = off + (u + 1) // 2
        escb = (
            torch.gather(P, 1, (eoff + rank // 4).clamp(0, cap - 1).to(torch.int64))
            >> (8 * (rank % 4)).to(torch.int64)
        ) & 255
        byte = torch.where(is_esc, escb, lut[si][nib])
        byte = torch.where(in_use, byte, 0)
        shifts = 8 * torch.arange(4, dtype=torch.int64, device=dev)
        nib_rows = (byte.reshape(n, w, 4) << shifts).sum(dim=2)
        out[s] = to_i32_bits(torch.where(modes[:, si : si + 1] == MODE_NIBBLE, nib_rows, raw))
    return out


class _UnpackParams(ctypes.Structure):
    _fields_ = [
        ("packed", ctypes.c_void_p),
        ("dicts", ctypes.c_void_p),
        ("out", ctypes.c_void_p * 14),
        ("widths", ctypes.c_int * 14),
        ("n", ctypes.c_int),
        ("cap", ctypes.c_int),
        ("ns", ctypes.c_int),
    ]


@functools.cache
def _unpack_lib():
    return bind_unpack(cuda_lib.lib("sage_unpack"))


def bind_unpack(lib):
    """Declare the unpack library's C signatures on ``lib`` (once a load)."""
    lib.sage_unpack_launch.argtypes = [ctypes.POINTER(_UnpackParams), ctypes.c_void_p]
    lib.sage_unpack_launch.restype = ctypes.c_int
    lib.sage_unpack_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.sage_unpack_plan.restype = None
    lib.sage_unpack_error_string.restype = ctypes.c_char_p
    return lib


def launch_unpack(lib, packed, dicts, outs, stream) -> int:
    """Fill the kernel's parameter block and launch (returns the CUDA
    error code). ``outs`` are preallocated (n, W_s) int32 rows; ``lib`` is
    bound by :func:`bind_unpack`."""
    p = _UnpackParams()
    p.packed = packed.data_ptr()
    p.dicts = dicts.data_ptr()
    for i, o in enumerate(outs):
        p.out[i] = o.data_ptr()
        p.widths[i] = o.shape[1]
    p.n, p.cap = packed.shape
    p.ns = len(outs)
    return lib.sage_unpack_launch(ctypes.byref(p), stream)


def unpack_plan(n: int, ns: int = len(STREAMS)) -> dict[str, int]:
    """How the unpack kernel runs ``n`` extents of ``ns`` streams: one warp
    per (extent, stream); its grid, threads a CTA and shared memory."""
    out = (ctypes.c_int * 3)()
    _unpack_lib().sage_unpack_plan(n, ns, out)
    return {"grid": out[0], "threads": out[1], "smem_bytes": out[2]}


def sage_unpack(packed: torch.Tensor, dicts: torch.Tensor, widths) -> dict[str, torch.Tensor]:
    """Unpack codec extent payloads: (n, cap_words) int32-bit rows ->
    stream -> (n, W_s) int32-bit rows. CUDA: one warp per (extent, stream)."""
    widths = tuple((s, int(w)) for s, w in widths)
    if packed.dtype != I32 or packed.dim() != 2:
        raise ValueError(f"sage_unpack: packed must be (n, cap) int32, got {packed.dtype} {tuple(packed.shape)}")
    if dicts.dtype != torch.uint8 or dicts.dim() != 2 or dicts.shape[1] != 16 or dicts.shape[0] < len(widths):
        raise ValueError(f"sage_unpack: dicts must be (>= {len(widths)}, 16) uint8, got {dicts.dtype} {tuple(dicts.shape)}")
    if packed.shape[1] < DESC_WORDS:
        raise ValueError(f"sage_unpack: rows need >= {DESC_WORDS} descriptor words")
    if cuda_lib.on_cpu(packed, dicts):
        cuda_lib.COUNTS["plain:sage_unpack"] += 1
        return unpack_rows_plain(packed, dicts, widths)
    dicts = dicts[: len(widths)].contiguous()
    cuda_lib.require_cuda(packed, dicts, name="sage_unpack")
    n = packed.shape[0]
    # one allocation, stream-major, so each (n, W_s) view is contiguous
    buf = torch.empty(n * sum(w for _s, w in widths), dtype=I32, device=packed.device)
    parts = buf.split([n * w for _s, w in widths])
    outs = [o.view(n, w) for o, (_s, w) in zip(parts, widths)]
    lib = _unpack_lib()
    with torch.cuda.device(packed.device):
        rc = launch_unpack(lib, packed, dicts, outs, torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "sage_unpack", lib.sage_unpack_error_string)
    cuda_lib.COUNTS["launch:sage_unpack"] += 1
    return {s: o for (s, _w), o in zip(widths, outs)}


# --------------------------------------------------------------------------
# block decode (B2)
# --------------------------------------------------------------------------

class _DecodeParams(ctypes.Structure):
    _fields_ = [
        ("streams", ctypes.c_void_p * 14),
        ("widths", ctypes.c_int * 14),
        ("cons", ctypes.c_void_p),
        ("dir", ctypes.c_void_p),
        ("valid", ctypes.c_void_p),
        ("cons_w", ctypes.c_int),
        ("ndir", ctypes.c_int),
        ("nb", ctypes.c_int),
        ("R", ctypes.c_int), ("M", ctypes.c_int), ("I", ctypes.c_int),
        ("U", ctypes.c_int), ("C", ctypes.c_int),
        ("window", ctypes.c_int), ("insb", ctypes.c_int), ("escb", ctypes.c_int),
        ("fixed_len", ctypes.c_int),
        ("ncls", ctypes.c_int * 4),
        ("cls_w", (ctypes.c_int * _MAXCLS) * 4),
        ("d_n_segs", ctypes.c_int), ("d_n_reads", ctypes.c_int),
        ("d_n_mism", ctypes.c_int), ("d_n_tokens", ctypes.c_int),
        ("d_cons_start", ctypes.c_int), ("d_base_pos", ctypes.c_int),
        ("tokens", ctypes.c_void_p),
        ("read_pos", ctypes.c_void_p), ("read_rev", ctypes.c_void_p),
        ("read_start", ctypes.c_void_p), ("read_len", ctypes.c_void_p),
        ("read_corner", ctypes.c_void_p),
        ("scratch", ctypes.c_void_p),
        ("slot_bytes", ctypes.c_longlong),
        ("ids", ctypes.c_void_p),
        ("n_reads", ctypes.c_void_p), ("n_tokens", ctypes.c_void_p),
        ("kmer", ctypes.c_void_p), ("onehot", ctypes.c_void_p),
        ("kmer_k", ctypes.c_int),
    ]


def decode_dims(caps) -> tuple[int, int, int, int, int]:
    """(R, M, I, U, C) of the decode: caps with the >= 1 floors."""
    return caps.segs, max(caps.mism, 1), max(caps.indel, 1), max(caps.multi, 1), caps.tokens


def decode_params(arrays, outs, scratch, *, caps, classes, fixed_len) -> _DecodeParams:
    """The parameter block both decode kernels take. ``arrays`` hold the
    stream, ``cons`` and ``dir`` rows (and B2's optional ``valid`` column);
    ``outs`` the token plane and the five read planes of the lanes; ``scratch``
    one slot per CTA (None when a block's arrays fit in shared memory). The
    lane count is the token plane's row count."""
    p = _DecodeParams()
    for i, s in enumerate(STREAMS):
        p.streams[i] = arrays[s].data_ptr()
        p.widths[i] = arrays[s].shape[1]
    p.cons = arrays["cons"].data_ptr()
    p.cons_w = arrays["cons"].shape[1]
    p.dir = arrays["dir"].data_ptr()
    p.ndir = arrays["dir"].shape[1]
    p.valid = arrays["valid"].data_ptr() if "valid" in arrays else None
    p.nb = outs["tokens"].shape[0]
    p.R, p.M, p.I, p.U, p.C = decode_dims(caps)
    p.window, p.insb, p.escb = caps.window, caps.insb, caps.escb
    p.fixed_len = int(fixed_len)
    for ki, kind in enumerate(("map", "len", "cnt", "mp")):
        cw = tuple(classes[kind])
        p.ncls[ki] = len(cw)
        for j, w in enumerate(cw):
            p.cls_w[ki][j] = int(w)
    p.d_n_segs, p.d_n_reads, p.d_n_mism = D["n_segs"], D["n_reads"], D["n_mism"]
    p.d_n_tokens, p.d_cons_start, p.d_base_pos = D["n_tokens"], D["cons_start"], D["base_pos"]
    p.tokens = outs["tokens"].data_ptr()
    for k in OUT_KEYS[1:]:
        setattr(p, k, outs[k].data_ptr())
    p.scratch = None if scratch is None else scratch.data_ptr()
    p.slot_bytes = 0 if scratch is None else scratch.shape[1]
    return p


def launch_decode(lib, arrays, outs, scratch, grid, *, caps, classes, fixed_len, stream) -> int:
    """Launch the block-decode kernel on ``grid`` CTAs (``scratch``: one slot
    per CTA, or None). Returns the CUDA error code."""
    p = decode_params(arrays, outs, scratch, caps=caps, classes=classes, fixed_len=fixed_len)
    fn = lib.sage_decode_launch
    fn.argtypes = [ctypes.POINTER(_DecodeParams), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn(ctypes.byref(p), grid, stream)


def _check_decode_inputs(arrays, caps, classes, name="sage_decode_arrays") -> None:
    nb = arrays["dir"].shape[0]
    for k in list(STREAMS) + ["cons", "dir"]:
        a = arrays[k]
        if a.dtype != I32 or a.dim() != 2 or a.shape[0] != nb:
            raise ValueError(f"{name}: {k} must be ({nb}, W) int32, got {a.dtype} {tuple(a.shape)}")
        if k != "dir" and a.shape[1] < 2:
            raise ValueError(f"{name}: {k} rows need >= 2 words")
    if arrays["cons"].shape[1] * 16 < caps.window:
        raise ValueError(f"{name}: cons rows narrower than caps.window")
    if "valid" in arrays and tuple(arrays["valid"].shape) != (nb, 1):
        raise ValueError(f"{name}: valid must be (nb, 1)")
    for kind in ("map", "len", "cnt", "mp"):
        if not 1 <= len(classes[kind]) <= _MAXCLS:
            raise ValueError(f"{name}: {kind} needs 1..{_MAXCLS} width classes")
    if caps.segs < 1 or caps.tokens < 1:
        raise ValueError(f"{name}: caps.segs and caps.tokens must be >= 1")


#: the kernel each launch runs (``sage_decode_plan``'s format code): B2 runs
#: B5's 2bit kernel on rows it was given
PLAN_KERNELS = {"decode": FUSED_EPILOGUES["2bit"], **{f"fused_{f}": c for f, c in FUSED_EPILOGUES.items()}}


@functools.lru_cache(maxsize=None)
def _plan(R, M, C, cons_w, nb, fmt, dev_index) -> tuple[int, ...]:
    lib = cuda_lib.lib("sage_decode")
    fn = lib.sage_decode_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 4)()
    with torch.cuda.device(dev_index):
        rc = fn(R, M, C, cons_w, nb, fmt, out)
    lib.sage_decode_error_string.restype = ctypes.c_char_p
    cuda_lib.check(rc, "sage_decode_plan", lib.sage_decode_error_string)
    return tuple(int(v) for v in out)


def launch_plan(caps, cons_w: int, nb: int, kernel: str, device) -> dict[str, int]:
    """How ``kernel`` (a key of :data:`PLAN_KERNELS`) runs ``nb`` lanes of a
    block shape on a CUDA ``device``: its persistent grid (as many CTAs as
    the card holds at once, at most ``nb``), its dynamic shared memory, and
    its global scratch (one slot per CTA; 0 when a block's arrays fit in
    shared memory)."""
    R, M, _I, _U, C = decode_dims(caps)
    dev = torch.device(device)
    grid, smem, slot, per_sm = _plan(R, M, C, int(cons_w), int(nb), PLAN_KERNELS[kernel],
                                     dev.index if dev.index is not None else torch.cuda.current_device())
    return {"grid": grid, "smem_bytes": smem, "slot_bytes": slot, "ctas_per_sm": per_sm,
            "scratch_bytes": grid * slot}


def _decode_grid(caps, cons_w, dev, nb: int, kernel: str) -> tuple[int, torch.Tensor | None]:
    """The launch's grid and its scratch (None when it needs none)."""
    pl = launch_plan(caps, cons_w, nb, kernel, dev)
    slot = pl["slot_bytes"]
    return pl["grid"], (torch.empty((pl["grid"], slot), dtype=torch.uint8, device=dev) if slot else None)


def sage_decode_arrays(
    arrays: dict[str, torch.Tensor], *, caps, classes: dict[str, tuple[int, ...]], fixed_len: int
) -> dict[str, torch.Tensor]:
    """Decode block-major stream arrays (as the bucketed hot path gathers
    them): the 6 token/read planes of :data:`OUT_KEYS`. An optional
    ``arrays["valid"]`` (nb, 1) column masks bucket-padding lanes."""
    names = list(STREAMS) + ["cons", "dir"] + (["valid"] if "valid" in arrays else [])
    ins = [arrays[k] for k in names]
    if cuda_lib.on_cpu(*ins):
        cuda_lib.COUNTS["plain:sage_decode"] += 1
        out = decode_block_arrays(arrays, caps=caps, classes=classes, fixed_len=fixed_len)
        return {k: out[k] for k in OUT_KEYS}
    arrays = {k: arrays[k] for k in names}
    if "valid" in arrays:
        arrays["valid"] = arrays["valid"].to(I32).contiguous()
    _check_decode_inputs(arrays, caps, classes)
    cuda_lib.require_cuda(*arrays.values(), name="sage_decode_arrays")
    dev = arrays["dir"].device
    nb = arrays["dir"].shape[0]
    R, _M, _I, _U, C = decode_dims(caps)
    outs = {"tokens": torch.empty((nb, C), dtype=torch.int8, device=dev)}
    for k in OUT_KEYS[1:]:
        outs[k] = torch.empty((nb, R), dtype=I32, device=dev)
    if nb == 0:
        return outs
    lib = cuda_lib.lib("sage_decode")
    grid, scratch = _decode_grid(caps, arrays["cons"].shape[1], dev, nb, "decode")
    with torch.cuda.device(dev):
        rc = launch_decode(lib, arrays, outs, scratch, grid, caps=caps, classes=classes,
                           fixed_len=fixed_len, stream=torch.cuda.current_stream().cuda_stream)
    lib.sage_decode_error_string.restype = ctypes.c_char_p
    cuda_lib.check(rc, "sage_decode_arrays", lib.sage_decode_error_string)
    cuda_lib.COUNTS["launch:sage_decode"] += 1
    return outs


# --------------------------------------------------------------------------
# fused gather + decode + format (B5)
# --------------------------------------------------------------------------

FUSED_COUNT_KEYS = ("n_reads", "n_tokens")


def _check_fused_args(arrays, ids, valid, fmt, kmer_k) -> tuple[np.ndarray, np.ndarray]:
    """Host-side checks of B5's lane arguments: ``ids`` index the resident
    rows, one 0/1 ``valid`` flag per lane, a known format and k."""
    ids = np.asarray(ids)
    valid = np.asarray(valid)
    if fmt not in FUSED_EPILOGUES:
        raise ValueError(f"sage_fused_decode: fmt must be one of {tuple(FUSED_EPILOGUES)}, got {fmt!r}")
    if fmt == "kmer" and not (isinstance(kmer_k, (int, np.integer)) and 1 <= kmer_k <= MAX_KMER_K):
        raise ValueError(f"sage_fused_decode: kmer needs kmer_k in 1..{MAX_KMER_K}, got {kmer_k!r}")
    if ids.ndim != 1 or valid.shape != ids.shape:
        raise ValueError(f"sage_fused_decode: ids and valid must be (nb,), got {ids.shape} {valid.shape}")
    if not (np.issubdtype(ids.dtype, np.integer) or ids.size == 0):
        raise ValueError(f"sage_fused_decode: ids must be integers, got {ids.dtype}")
    if ((valid != 0) & (valid != 1)).any():
        raise ValueError("sage_fused_decode: valid must hold 0/1 flags")
    n_rows = arrays["dir"].shape[0]
    if ids.size and (ids.min() < 0 or ids.max() >= n_rows):
        raise IndexError(f"sage_fused_decode: ids must lie in [0, {n_rows}), got [{ids.min()}, {ids.max()}]")
    return ids.astype(np.int64), valid.astype(np.int32)


def _fused_empty(caps, device, fmt, kmer_k) -> dict[str, torch.Tensor]:
    out = empty_decode(caps, device)
    if fmt == "kmer":
        out["kmer"] = torch.zeros((0, caps.tokens // kmer_k), dtype=I32, device=device)
    elif fmt == "onehot":
        out["onehot"] = torch.zeros((0, caps.tokens, 4), dtype=torch.bfloat16, device=device)
    return out


def fused_decode_plain(
    arrays: dict[str, torch.Tensor], ids, valid, *, caps, classes, fixed_len, fmt: str,
    kmer_k=None,
) -> dict[str, torch.Tensor]:
    """Plain torch version of B5: gather the ``ids`` rows out of the resident
    arrays, decode them masked by ``valid`` and format the tokens, on the
    arrays' device. Same keys as :func:`sage_fused_decode`."""
    ids, valid = _check_fused_args(arrays, ids, valid, fmt, kmer_k)
    dev = arrays["dir"].device
    if ids.size == 0:
        return _fused_empty(caps, dev, fmt, kmer_k)
    idx = torch.as_tensor(ids, device=dev)
    sub = {k: arrays[k].index_select(0, idx) for k in list(STREAMS) + ["cons", "dir"]}
    sub["valid"] = torch.as_tensor(valid, device=dev)[:, None]
    dec = decode_block_arrays(sub, caps=caps, classes=classes, fixed_len=fixed_len)
    out = {k: dec[k] for k in OUT_KEYS + FUSED_COUNT_KEYS}
    if fmt == "kmer":
        out["kmer"] = kmer_pack_plain(dec["tokens"], kmer_k, dec["n_tokens"])
    elif fmt == "onehot":
        out["onehot"] = one_hot_plain(dec["tokens"])
    return out


def launch_fused(lib, arrays, idv, outs, scratch, grid, *, caps, classes, fixed_len, fmt, kmer_k,
                 stream) -> int:
    """Launch B5 on ``grid`` CTAs. ``idv`` (2, nb) int32 holds the lanes'
    row ids over their valid flags. Returns the CUDA error code."""
    p = decode_params(arrays, outs, scratch, caps=caps, classes=classes, fixed_len=fixed_len)
    p.ids = idv[0].data_ptr()
    p.valid = idv[1].data_ptr()
    p.n_reads = outs["n_reads"].data_ptr()
    p.n_tokens = outs["n_tokens"].data_ptr()
    p.kmer = outs["kmer"].data_ptr() if fmt == "kmer" else None
    p.onehot = outs["onehot"].data_ptr() if fmt == "onehot" else None
    p.kmer_k = int(kmer_k) if fmt == "kmer" else 0
    fn = lib.sage_fused_launch
    fn.argtypes = [ctypes.POINTER(_DecodeParams), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn(ctypes.byref(p), grid, FUSED_EPILOGUES[fmt], stream)


def sage_fused_decode(
    arrays: dict[str, torch.Tensor], ids, valid, *, caps, classes: dict[str, tuple[int, ...]],
    fixed_len: int, fmt: str, kmer_k=None, upload=None,
) -> dict[str, torch.Tensor]:
    """Gather, decode and format in one launch: lane b decodes resident row
    ``ids[b]`` (host numpy) masked by ``valid[b]``, and the result holds the
    six planes of :data:`OUT_KEYS`, ``n_reads`` / ``n_tokens`` and, for
    ``fmt`` ``"kmer"`` or ``"onehot"``, the format's plane; bit for bit B2
    followed by B3 or B4. ``upload`` (a :class:`Uploader` of the arrays'
    device) carries the lane ids to the card."""
    ids, valid = _check_fused_args(arrays, ids, valid, fmt, kmer_k)
    names = list(STREAMS) + ["cons", "dir"]
    ins = {k: arrays[k] for k in names}
    dev = ins["dir"].device
    if ids.size == 0:
        return _fused_empty(caps, dev, fmt, kmer_k)
    if cuda_lib.on_cpu(*ins.values()):
        cuda_lib.COUNTS["plain:sage_fused"] += 1
        return fused_decode_plain(ins, ids, valid, caps=caps, classes=classes,
                                  fixed_len=fixed_len, fmt=fmt, kmer_k=kmer_k)
    _check_decode_inputs(ins, caps, classes, name="sage_fused_decode")
    cuda_lib.require_cuda(*ins.values(), name="sage_fused_decode")
    nb = ids.size
    R, _M, _I, _U, C = decode_dims(caps)
    outs = {"tokens": torch.empty((nb, C), dtype=torch.int8, device=dev)}
    for k in OUT_KEYS[1:]:
        outs[k] = torch.empty((nb, R), dtype=I32, device=dev)
    for k in FUSED_COUNT_KEYS:
        outs[k] = torch.empty((nb,), dtype=I32, device=dev)
    if fmt == "kmer":
        outs["kmer"] = torch.empty((nb, C // kmer_k), dtype=I32, device=dev)
    elif fmt == "onehot":
        outs["onehot"] = torch.empty((nb, C, 4), dtype=torch.bfloat16, device=dev)
    (idv,) = (upload or Uploader(dev))(np.stack([ids.astype(np.int32), valid]))
    lib = cuda_lib.lib("sage_decode")
    grid, scratch = _decode_grid(caps, ins["cons"].shape[1], dev, nb, f"fused_{fmt}")
    with torch.cuda.device(dev):
        rc = launch_fused(lib, ins, idv, outs, scratch, grid, caps=caps, classes=classes,
                          fixed_len=fixed_len, fmt=fmt, kmer_k=kmer_k,
                          stream=torch.cuda.current_stream().cuda_stream)
    lib.sage_decode_error_string.restype = ctypes.c_char_p
    cuda_lib.check(rc, "sage_fused_decode", lib.sage_decode_error_string)
    cuda_lib.COUNTS["launch:sage_fused"] += 1
    return outs
