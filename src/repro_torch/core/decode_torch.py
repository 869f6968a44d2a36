"""Data-parallel SAGe decoder in PyTorch: the plain version of the block
decode, the device-resident block layout, and the bucketed ranged decode.

Every sequential recurrence of the paper's Scan Unit / Read Construction
Unit (§5.2) is a scan here, exactly as in the JAX package's decoder: unary
guide codes rank their zero bits, variable-width fields prefix-sum their
widths, delta positions take segmented cumsums, and reads are rebuilt by
scattering substitutions / insertions / deletions onto the token axis and
gathering the rest from the 2-bit consensus window.

:func:`decode_block_arrays` is written batched over blocks (leading dim) and
computes in int32 with the JAX version's clipping, so both give the same
bits. It is the plain version of the CUDA block-decode kernel
(:func:`repro_torch.kernels.sage_decode.sage_decode_arrays`), which the hot
path uses on CUDA tensors.

Packed uint32 words are carried in int32 tensors (bit-reinterpreted):
``torch.uint32`` lacks shifts and arithmetic on the CPU. The plain version
widens them to int64 and masks with ``0xFFFFFFFF``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.blocks import (
    PAD_BASE,
    bucket_size,
    pad_block_ids,
    prepare_block_arrays,
)
from repro_torch.core.format import D, STREAMS, SageFile
from repro_torch.distributed.sharding import BlockMesh, block_sharding, indexed_device
from repro_torch.kernels import cuda_lib

__all__ = [
    "PAD_BASE", "DeviceBlocks", "Uploader", "bucket_size", "decode_block_arrays",
    "decode_blocks_bucketed", "decode_blocks_sharded", "extract_fields",
    "fused_decode_blocks_bucketed", "fused_format_supported", "gather_lanes",
    "pad_block_ids", "prepare_device_blocks", "register_format_fuser",
    "reset_trace_counts", "resolve_device", "stream_bits", "trace_counts",
    "unpack_block_rows", "uploader_for",
]

I32 = torch.int32
_U32 = 0xFFFFFFFF


def trace_counts() -> dict[str, int]:
    """Kernel launches (``launch:<kernel>``), plain-version calls on CPU
    tensors (``plain:<kernel>``) and kernel-library builds (``build``)."""
    return cuda_lib.counts()


def reset_trace_counts() -> None:
    cuda_lib.reset_counts()


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (the port
    never quietly runs on the CPU in place of the card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain torch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding values in [0, 2**32) -> int32 with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(I32)


def _u32(words: torch.Tensor) -> torch.Tensor:
    return words.to(torch.int64) & _U32


# --------------------------------------------------------------------------
# bit-level helpers (batched over the leading dims)
# --------------------------------------------------------------------------

def extract_fields(words: torch.Tensor, starts: torch.Tensor, widths) -> torch.Tensor:
    """Variable-width little-endian fields (width <= 32) of packed rows.

    ``words`` (..., W) uint32 bits; ``starts``/``widths`` (..., K). The
    64-bit window is two adjacent words (the paper's double register);
    the word index clips to W-2 and the result is int32 (wrapping)."""
    w = _u32(words)
    starts = starts.to(I32)
    widths = torch.as_tensor(widths, dtype=I32, device=starts.device).expand_as(starts)
    W = w.shape[-1]
    idx = (starts >> 5).clamp(0, W - 2).to(torch.int64)
    sh = (starts & 31).to(torch.int64)
    lo = torch.gather(w, -1, idx) >> sh
    hi = torch.where(
        sh == 0, 0, (torch.gather(w, -1, idx + 1) << (32 - sh.clamp(min=1))) & _U32
    )
    mask = torch.where(
        widths <= 0, 0, _U32 >> (32 - widths).clamp(0, 31).to(torch.int64)
    )
    return to_i32_bits((lo | hi) & mask)


def stream_bits(words: torch.Tensor, nbits_cap: int) -> torch.Tensor:
    """First ``nbits_cap`` bits of packed rows as 0/1 int32, (..., nbits)."""
    i = torch.arange(nbits_cap, dtype=torch.int64, device=words.device)
    idx = (i >> 5).clamp(0, words.shape[-1] - 1)
    w = _u32(words)[..., idx]
    return ((w >> (i & 31)) & 1).to(I32)


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=-1, dtype=I32)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-wise gather ``x[b, idx[b, j]]`` (idx already in range)."""
    return torch.gather(x, -1, idx.to(torch.int64))


def _scatter(size: int, fill: int, idx: torch.Tensor, vals: torch.Tensor, reduce: str):
    """JAX ``.at[idx].<reduce>(vals, mode="drop")`` into a fresh (.., size)
    buffer: scatter into one extra slot, which index ``size`` hits, then
    drop it."""
    buf = torch.full(idx.shape[:-1] + (size + 1,), fill, dtype=I32, device=idx.device)
    idx = idx.to(torch.int64)
    vals = vals.to(I32)
    if reduce == "set":
        buf.scatter_(-1, idx, vals)
    elif reduce == "add":
        buf.scatter_add_(-1, idx, vals)
    else:
        buf.scatter_reduce_(-1, idx, vals, reduce="amax", include_self=True)
    return buf[..., :size]


def decode_adaptive(gwords, awords, n, class_widths: tuple[int, ...], cap: int) -> torch.Tensor:
    """Decode ``n`` (<= cap) adaptive-width values per row: unary guide
    codes in ``gwords`` select a width class, fields packed in ``awords``."""
    ncls = len(class_widths)
    gb = cap * ncls + 1
    dev = gwords.device
    bits = stream_bits(gwords, gb)
    is_zero = 1 - bits
    rank = _cumsum(is_zero)  # 1-based at zero positions
    tgt = torch.where(is_zero == 1, torch.clamp(rank - 1, max=cap), cap)
    pos = torch.arange(gb, dtype=I32, device=dev).expand_as(tgt)
    zpos = _scatter(cap + 1, 0, tgt, pos, "amax")
    zprev = torch.cat([torch.full_like(zpos[..., :1], -1), zpos[..., : cap - 1]], dim=-1)
    cls = (zpos[..., :cap] - zprev - 1).clamp(0, ncls - 1)
    widths = torch.zeros_like(cls)
    for i, w in enumerate(class_widths):
        widths = torch.where(cls == i, w, widths)
    k = torch.arange(cap, dtype=I32, device=dev)
    in_n = k < n.to(I32)[..., None]
    widths = torch.where(in_n, widths, 0)
    offs = _cumsum(widths) - widths
    vals = extract_fields(awords, offs, widths)
    return torch.where(in_n, vals, 0)


def _seg_cumsum(vals: torch.Tensor, first_idx: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of ``vals`` restarted at each segment; ``first_idx``
    maps element -> index of its segment's first element."""
    gc = _cumsum(vals)
    gc_excl = gc - vals
    return gc - _take(gc_excl, first_idx.clamp(0, vals.shape[-1] - 1))


# --------------------------------------------------------------------------
# the block decoder (plain version of the CUDA decode kernel)
# --------------------------------------------------------------------------

def decode_block_arrays(
    blk: dict[str, torch.Tensor],
    *,
    caps,
    classes: dict[str, tuple[int, ...]],
    fixed_len: int,
) -> dict[str, torch.Tensor]:
    """Decode a batch of blocks. ``blk`` holds (nb, W_s) stream rows, the
    (nb, window/16) consensus rows and the (nb, NDIR) block-local directory
    rows. Returns (nb, C) int8 tokens plus per-read metadata.

    Mask contract: an optional ``blk["valid"]`` (nb, 1) column of 0/1 gates
    each lane. Invalid lanes decode to all-PAD tokens, zero counts and
    ``read_pos == -1``, whatever block's streams occupy the lane."""
    R, M = caps.segs, max(caps.mism, 1)
    I, U = max(caps.indel, 1), max(caps.multi, 1)
    C = caps.tokens
    row = blk["dir"].to(I32)
    nb = row.shape[0]
    dev = row.device
    col = lambda name: row[:, D[name]]  # noqa: E731
    n_segs, n_mism, n_tok, n_reads = col("n_segs"), col("n_mism"), col("n_tokens"), col("n_reads")
    if "valid" in blk:
        valid = blk["valid"].to(I32)[:, 0]
        n_segs, n_mism, n_tok, n_reads = (x * valid for x in (n_segs, n_mism, n_tok, n_reads))
    base_local = col("base_pos")[:, None]

    def ar(n):
        return torch.arange(n, dtype=I32, device=dev).expand(nb, n)

    ar_r, ar_m, ar_t = ar(R), ar(M), ar(C)
    seg_mask = ar_r < n_segs[:, None]
    mism_mask = ar_m < n_mism[:, None]
    tok_mask = ar_t < n_tok[:, None]
    seg_i = seg_mask.to(I32)

    # ---- per-segment streams -------------------------------------------
    map_vals = decode_adaptive(blk["mapg"], blk["mapa"], n_segs, classes["map"], R)
    if fixed_len:
        lens = torch.where(seg_mask, fixed_len, 0).to(I32)
    else:
        lens = torch.where(
            seg_mask, decode_adaptive(blk["leng"], blk["lena"], n_segs, classes["len"], R), 0
        )
    cnts = torch.where(
        seg_mask, decode_adaptive(blk["cntg"], blk["cnta"], n_segs, classes["cnt"], R), 0
    )
    rfl = extract_fields(blk["rfl"], 3 * ar_r, 3)
    rev = (rfl & 1) & seg_i
    cont = ((rfl >> 1) & 1) & seg_i
    corner = ((rfl >> 2) & 1) & seg_i

    # ---- segment positions (block-local) --------------------------------
    is_chain = seg_mask & (cont == 0) & (corner == 0)
    acc = base_local + _cumsum(torch.where(is_chain, map_vals, 0))
    unzig = (map_vals >> 1) ^ -(map_vals & 1)
    pos = torch.where(cont == 1, acc + unzig, acc)

    # ---- token layout ----------------------------------------------------
    cum_lens = _cumsum(lens)
    starts_i = cum_lens - lens
    seg_of_t = torch.searchsorted(cum_lens, ar_t.contiguous(), right=True).to(I32).clamp(0, R - 1)
    seg_start_t = _take(starts_i, seg_of_t)
    j = ar_t - seg_start_t

    # ---- mismatch -> segment mapping ------------------------------------
    cnt_ends = _cumsum(cnts)
    cnt_starts = cnt_ends - cnts
    seg_of_m = torch.searchsorted(cnt_ends, ar_m.contiguous(), right=True).to(I32).clamp(0, R - 1)
    first_m = _take(cnt_starts, seg_of_m)
    mp_deltas = decode_adaptive(blk["mpg"], blk["mpa"], n_mism, classes["mp"], M)
    p_m = _seg_cumsum(mp_deltas, first_m)
    mbb = torch.where(mism_mask, extract_fields(blk["mbb"], 2 * ar_m, 2), 0)

    # ---- indel decode (explicit rank code: mbb==3) -----------------------
    is_ind = torch.where(mism_mask, (mbb == 3).to(I32), 0)
    ind_rank = _cumsum(is_ind) - is_ind
    idg_all = extract_fields(blk["idg"], 2 * ar(I), 2)
    idg_m = _take(idg_all, ind_rank.clamp(0, I - 1))
    is_ins = is_ind * (idg_m & 1)
    is_multi = is_ind * ((idg_m >> 1) & 1)
    mul_rank = _cumsum(is_multi) - is_multi
    idl_all = extract_fields(blk["idl"], 8 * ar(U), 8)
    ilen_m = torch.where(is_multi == 1, _take(idl_all, mul_rank.clamp(0, U - 1)), 1) * is_ind
    ins_len_m = torch.where(is_ins == 1, ilen_m, 0)
    del_len_m = torch.where((is_ind == 1) & (is_ins == 0), ilen_m, 0)
    ibs_off_m = _cumsum(ins_len_m) - ins_len_m

    # ---- consensus cursor per mismatch (for sub rank -> base) -----------
    dshift = del_len_m - ins_len_m
    shift_m_excl = _seg_cumsum(dshift, first_m) - dshift
    cursor_m = _take(pos, seg_of_m) + p_m + shift_m_excl
    cw = _u32(blk["cons"])

    def cons_at(idx: torch.Tensor) -> torch.Tensor:
        idx = idx.clamp(0, caps.window - 1).to(torch.int64)
        return ((torch.gather(cw, -1, idx >> 4) >> (2 * (idx & 15))) & 3).to(I32)

    cons_b_m = cons_at(cursor_m)
    sub_base = mbb + (mbb >= cons_b_m).to(I32)

    # ---- scatter mismatches onto the token axis -------------------------
    t_m = _take(starts_i, seg_of_m) + p_m
    t_m_safe = torch.where(mism_mask, t_m.clamp(0, C - 1), C)
    is_sub = mism_mask & (mbb < 3)
    sub_t = _scatter(C, -1, torch.where(is_sub, t_m_safe, C), sub_base, "set")
    del_at = _scatter(C, 0, t_m_safe, del_len_m, "add")
    del_shift_t = _seg_cumsum(del_at, seg_start_t)
    is_ins_m = mism_mask & (is_ins == 1)
    ins_idx = torch.where(is_ins_m, t_m_safe, C)
    ins_start_mark = _scatter(C, -1, ins_idx, t_m, "amax")
    last_ins_start = torch.cummax(ins_start_mark, dim=-1).values
    ins_len_t0 = _scatter(C, 0, ins_idx, ins_len_m, "amax")
    ins_off_t0 = _scatter(C, 0, ins_idx, ibs_off_m, "amax")
    lis = last_ins_start.clamp(0, C - 1)
    inside_ins = (last_ins_start >= 0) & (ar_t - last_ins_start < _take(ins_len_t0, lis)) & tok_mask
    ibs_idx_t = _take(ins_off_t0, lis) + (ar_t - last_ins_start)
    ibs_val_t = extract_fields(blk["ibs"], 2 * ibs_idx_t.clamp(0, caps.insb), 2)

    # ---- consensus-derived tokens ----------------------------------------
    consumes = (tok_mask & ~inside_ins).to(I32)
    cc_t = _seg_cumsum(consumes, seg_start_t) - consumes
    cons_idx_t = _take(pos, seg_of_t) + cc_t + del_shift_t
    cons_tok = cons_at(cons_idx_t)

    # ---- escape (corner) segments ----------------------------------------
    esc_lens = torch.where(corner == 1, lens, 0)
    esc_start_seg = _cumsum(esc_lens) - esc_lens
    esc_idx_t = _take(esc_start_seg, seg_of_t) + j
    esc_val_t = extract_fields(blk["esc"], 3 * esc_idx_t.clamp(0, caps.escb), 3)
    is_corner_t = _take(corner, seg_of_t) == 1

    tokens = torch.where(
        is_corner_t,
        esc_val_t,
        torch.where(inside_ins, ibs_val_t, torch.where(sub_t >= 0, sub_t, cons_tok)),
    )

    # ---- per-read grouping + reverse-complement --------------------------
    read_first = seg_mask & (cont == 0)
    rf = read_first.to(I32)
    read_id_seg = _cumsum(rf) - rf
    rid_scatter = torch.where(read_first, read_id_seg, R)
    read_rev = _scatter(R, 0, rid_scatter, rev, "amax")
    read_pos = _scatter(R, -1, rid_scatter, torch.where(corner == 1, -1, pos), "amax")
    read_start = _scatter(R, 0, rid_scatter, starts_i, "amax")
    read_len = _scatter(R, 0, torch.where(seg_mask, read_id_seg, R), lens, "add")
    read_corner = _scatter(R, 0, rid_scatter, corner, "amax")

    rid_t = _take(read_id_seg, seg_of_t)
    rev_t = _take(read_rev, rid_t) == 1
    rstart_t = _take(read_start, rid_t)
    rlen_t = _take(read_len, rid_t)
    src = torch.where(rev_t, rstart_t + (rlen_t - 1 - (ar_t - rstart_t)), ar_t)
    out = _take(tokens, src.clamp(0, C - 1))
    out = torch.where(rev_t & (out < 4), 3 - out, out)
    out = torch.where(tok_mask, out, PAD_BASE).to(torch.int8)

    read_mask = ar_r < n_reads[:, None]
    cons_start = col("cons_start")[:, None]
    return {
        "tokens": out,
        "n_tokens": n_tok,
        "read_pos": torch.where(read_mask, read_pos + cons_start * (read_pos >= 0).to(I32), -1),
        "read_rev": torch.where(read_mask, read_rev, 0),
        "read_start": torch.where(read_mask, read_start, 0),
        "read_len": torch.where(read_mask, read_len, 0),
        "read_corner": torch.where(read_mask, read_corner, 0),
        "n_reads": n_reads,
    }


# --------------------------------------------------------------------------
# block-major layout, resident on a device
# --------------------------------------------------------------------------

def _host_rows(a) -> np.ndarray:
    """numpy rows as a torch-compatible array: contiguous, with uint32 words
    reinterpreted as int32 (same bits)."""
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.uint32 else a


def host_to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy block rows -> torch tensor on ``device`` (a plain blocking
    copy); uint32 words are reinterpreted as int32 (same bits)."""
    return torch.from_numpy(_host_rows(a)).to(device)


class Uploader:
    """Host -> device copies of one store (or one caller), on its device.

    On a CUDA device each call stages the host arrays in pinned memory and
    copies them with ``non_blocking=True`` on the uploader's own copy
    stream; the stream current at the call (the compute stream) waits on an
    event recorded after the copies, and every copy is ``record_stream``-ed
    on the compute stream, so the caching allocator keeps its memory until
    the kernels reading it have run. The host never waits for the device.
    On the CPU the arrays become tensors in place, with no stream."""

    def __init__(self, device) -> None:
        self.device = resolve_device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def __call__(self, *arrays) -> list[torch.Tensor]:
        hosts = [torch.from_numpy(_host_rows(a)) for a in arrays]
        if self.stream is None:
            return hosts
        compute = torch.cuda.current_stream(self.device)
        pinned = [h.pin_memory() for h in hosts]
        with torch.cuda.stream(self.stream):
            outs = [torch.empty(h.shape, dtype=h.dtype, device=self.device) for h in pinned]
            for o, h in zip(outs, pinned):
                o.copy_(h, non_blocking=True)
        compute.wait_event(self.stream.record_event())
        for o in outs:
            o.record_stream(compute)
        return outs


def uploader_for(uploaders: dict, device) -> Uploader:
    """``device``'s :class:`Uploader` in ``uploaders`` (one a device, keyed
    by the indexed device, shared by a store and its residencies), made on
    first use."""
    dev = indexed_device(resolve_device(device))
    up = uploaders.get(dev)
    if up is None:
        up = uploaders[dev] = Uploader(dev)
    return up


@dataclasses.dataclass
class DeviceBlocks:
    """Fixed-shape, block-major layout of a SageFile.

    ``arrays`` holds host numpy right after :func:`prepare_device_blocks`;
    :meth:`to` moves every array to a torch device once (uint32 rows as
    int32 bits), after which ranged reads gather and decode with no host
    round trip. ``device`` is None while the arrays are host numpy;
    ``uploader`` carries the small per-read index arrays to ``device``.

    Block-sharded residency (``to(mesh=...)``, ``mesh`` set): every
    ``arrays[k]`` is a list with one tensor a shard, shard ``i`` on
    ``mesh.devices[i]``, and row ``r`` of the layout is row ``r -
    shard_offsets()[i]`` of the shard ``i`` whose run holds it. ``device``
    is the mesh's first device (where reads hand their results back) and
    ``uploaders`` carries index arrays to each device."""

    arrays: dict[str, Any]
    caps: Any
    classes: dict[str, tuple[int, ...]]
    fixed_len: int
    n_blocks: int
    device: Optional[torch.device] = None
    uploader: Optional[Uploader] = dataclasses.field(default=None, repr=False, compare=False)
    mesh: Optional[BlockMesh] = None
    uploaders: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def on_device(self) -> bool:
        return self.device is not None

    def block(self, bi: int) -> dict[str, Any]:
        return {k: v[bi] for k, v in self.arrays.items()}

    def upload(self, *arrays, device=None) -> list[torch.Tensor]:
        """Host arrays onto ``device`` (this residency's device when None;
        see :class:`Uploader`), one uploader a device."""
        dev = self.device if device is None else indexed_device(device)
        if self.uploader is not None and dev == indexed_device(self.device):
            return self.uploader(*arrays)
        return uploader_for(self.uploaders, dev)(*arrays)

    def shard_offsets(self) -> np.ndarray:
        """First row of each shard's run (block-sharded residency)."""
        rows = [t.shape[0] for t in next(iter(self.arrays.values()))]
        return np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int64)

    def take(self, key: str, rows) -> torch.Tensor:
        """Rows ``rows`` of array ``key``, on ``device``."""
        return gather_lanes(self, rows, self.device, keys=(key,))[key]

    def to(self, device=None, uploader: Optional[Uploader] = None, *, mesh: Optional[BlockMesh] = None,
           uploaders: Optional[dict] = None) -> "DeviceBlocks":
        """Copy on ``device`` (no-op when already there), through
        ``uploader`` (a new one of ``device`` when None).

        With ``mesh`` (the counterpart of ``repro``'s ``to_device(mesh=)``)
        the leading block axis splits evenly over the mesh's devices: the
        rows pad with zeros to a multiple of the shard count and shard
        ``i``'s run of them goes to ``mesh.devices[i]`` (``uploaders``, one
        :class:`Uploader` a device, is filled as needed)."""
        if mesh is None:
            dev = resolve_device(device)
            if self.device == dev and self.mesh is None:
                return self
            if self.mesh is not None:
                raise ValueError("a block-sharded residency does not move as a whole; re-prepare it")
            up = uploader if uploader is not None else Uploader(dev)
            host = [k for k, v in self.arrays.items() if not isinstance(v, torch.Tensor)]
            uploaded = dict(zip(host, up(*(self.arrays[k] for k in host))))
            arrays = {k: uploaded[k] if k in uploaded else v.to(dev) for k, v in self.arrays.items()}
            return dataclasses.replace(self, arrays=arrays, device=dev, uploader=up)
        if self.mesh == mesh:
            return self
        if self.mesh is not None or self.on_device:
            raise ValueError("to(mesh=) shards host arrays; prepare the blocks again")
        ups = {} if uploaders is None else uploaders
        n = next(iter(self.arrays.values())).shape[0]
        ranges = block_sharding(mesh, n)
        arrays: dict[str, list] = {k: [] for k in self.arrays}
        for dev, rows in zip(mesh.devices, ranges):
            parts = []
            for v in self.arrays.values():
                part = v[rows.start:min(rows.stop, n)]
                if part.shape[0] < len(rows):
                    part = np.concatenate([part, np.zeros((len(rows) - part.shape[0],) + v.shape[1:], v.dtype)])
                parts.append(part)
            for k, t in zip(self.arrays, uploader_for(ups, dev)(*parts)):
                arrays[k].append(t)
        first = mesh.devices[0]
        return dataclasses.replace(self, arrays=arrays, device=first, uploader=uploader_for(ups, first), mesh=mesh,
                                   uploaders=ups)


def prepare_device_blocks(sf: SageFile) -> DeviceBlocks:
    """Pack a SageFile into fixed-shape block-major arrays (host numpy)."""
    return DeviceBlocks(
        arrays=prepare_block_arrays(sf),
        caps=sf.meta.caps,
        classes=sf.meta.classes,
        fixed_len=sf.meta.fixed_read_len,
        n_blocks=sf.meta.n_blocks,
    )


def unpack_block_rows(packed: torch.Tensor, dicts: torch.Tensor, widths) -> dict[str, torch.Tensor]:
    """Undo the per-extent codec on ``packed``'s device: (n, cap_words)
    payload rows -> stream -> (n, W_s) rows (int32 bits), bit-identical to
    :func:`repro_torch.core.codec.decode_blocks`. ``cons`` widths are
    ignored (consensus windows travel by reference). CUDA tensors run the
    unpack kernel, CPU tensors its plain version."""
    from repro_torch.kernels.sage_decode import sage_unpack

    wmap = dict(widths)
    return sage_unpack(packed, dicts, tuple((s, int(wmap[s])) for s in STREAMS))


# --------------------------------------------------------------------------
# shape-bucketed ranged decode
# --------------------------------------------------------------------------
# Ranges pad to their power-of-two bucket with a per-lane validity mask, as
# in the JAX package: kernel shapes (grid, scratch) then come from a small
# set, and padded lanes decode to deterministic PAD.

def _fill_counts(out: dict[str, torch.Tensor], sub: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Per-block counts from the gathered ``dir`` rows, masked by the
    validity column (the decode kernel emits token/read planes only)."""
    if "n_reads" not in out:
        v = sub["valid"][:, 0]
        out["n_reads"] = sub["dir"][:, D["n_reads"]] * v
        out["n_tokens"] = sub["dir"][:, D["n_tokens"]] * v
    return out


def gather_lanes(db: DeviceBlocks, ids, dev, keys=None, valid=None) -> dict[str, torch.Tensor]:
    """Rows ``ids`` of the resident arrays (``keys``: all when None) as
    tensors on ``dev``, in the order of ``ids``, and with ``valid`` (the
    lanes' validity mask) the (B, 1) int32 column ``"valid"`` the masked
    decoders consume. Each row comes from whichever shard holds it (one
    ``index_select`` a home shard on its own device), rows of another
    device are copied to ``dev`` (a peer copy between cards), and the
    parts are put back in ``ids``' order. When every row's home is on
    ``dev`` (always, for a one-device residency) the ids and the mask go
    up in one copy."""
    ids = np.asarray(ids, dtype=np.int64)
    names = tuple(db.arrays) if keys is None else tuple(keys)
    dev = indexed_device(dev)
    col = () if valid is None else (np.asarray(valid, dtype=np.int32)[:, None],)
    if db.mesh is None:
        shards, devs, offs = [db.arrays], [indexed_device(db.device)], np.zeros(1, dtype=np.int64)
    else:
        shards = [{k: db.arrays[k][i] for k in names} for i in range(db.mesh.shards)]
        devs, offs = list(db.mesh.devices), db.shard_offsets()
    homes = np.searchsorted(offs, ids, side="right") - 1
    loc = ids - offs[homes]
    h0 = int(homes[0]) if ids.size else 0
    if devs[h0] == dev and (homes == h0).all():
        idx, *v = db.upload(loc, *col, device=dev)
        out = {k: shards[h0][k].index_select(0, idx) for k in names}
    else:
        parts, order = [], []
        for h in np.unique(homes):
            sel = np.flatnonzero(homes == h)
            (idx,) = db.upload(loc[sel], device=devs[h])
            rows = {k: shards[h][k].index_select(0, idx) for k in names}
            if devs[h] != dev:
                rows = {k: r.to(dev, non_blocking=True) for k, r in rows.items()}
            parts.append(rows)
            order.append(sel)
        inv, *v = db.upload(np.argsort(np.concatenate(order)), *col, device=dev)
        out = {k: torch.cat([p[k] for p in parts]).index_select(0, inv) for k in names}
    if v:
        out["valid"] = v[0]
    return out


def decode_blocks_sharded(
    db: DeviceBlocks,
    ids: np.ndarray,
    valid: np.ndarray,
    *,
    mesh: BlockMesh,
    postprocess: Optional[Callable[[dict[str, torch.Tensor]], dict[str, torch.Tensor]]] = None,
) -> dict[str, torch.Tensor]:
    """Decode an already-padded block-id set over the lane shards of
    ``mesh``: lane shard ``i`` holds ids ``[i*b, (i+1)*b)``, gathered from
    whichever shard holds each block (:func:`gather_lanes`), and decodes
    on ``mesh.devices[i]`` with its own valid-mask tail (the block-decode
    kernel on CUDA, its plain version on the CPU); ``postprocess`` (the
    format) runs on each shard's output there. The outputs come back as
    one tensor each on the mesh's first device, in lane order.

    ``ids`` must be padded to a multiple of the shard count (see
    :func:`pad_block_ids`)."""
    from repro_torch.kernels.sage_decode import sage_decode_arrays

    ids = np.asarray(ids, dtype=np.int64)
    valid = np.asarray(valid, dtype=np.int32)
    if ids.size % mesh.shards:
        raise ValueError(f"{ids.size} lanes do not split over {mesh.shards} shards; pad with pad_block_ids")
    b = ids.size // mesh.shards
    parts = []
    for i, dev in enumerate(mesh.devices):
        sub = gather_lanes(db, ids[i * b:(i + 1) * b], dev, valid=valid[i * b:(i + 1) * b])
        out = _fill_counts(dict(sage_decode_arrays(sub, caps=db.caps, classes=db.classes,
                                                   fixed_len=db.fixed_len)), sub)
        parts.append(postprocess(out) if postprocess is not None else out)
    if len(parts) == 1:
        return parts[0]
    first = mesh.devices[0]
    return {k: torch.cat([p[k].to(first, non_blocking=True) for p in parts]) for k in parts[0]}


def empty_decode(caps, device) -> dict[str, torch.Tensor]:
    """The decode dict of zero blocks."""
    R, C = caps.segs, caps.tokens
    out = {"tokens": torch.zeros((0, C), dtype=torch.int8, device=device),
           "n_tokens": torch.zeros((0,), dtype=I32, device=device),
           "n_reads": torch.zeros((0,), dtype=I32, device=device)}
    for k in ("read_pos", "read_rev", "read_start", "read_len", "read_corner"):
        out[k] = torch.zeros((0, R), dtype=I32, device=device)
    return out


def decode_blocks_bucketed(
    db: DeviceBlocks,
    ids: np.ndarray,
    *,
    postprocess: Optional[Callable[[dict[str, torch.Tensor]], dict[str, torch.Tensor]]] = None,
    mesh: Optional[BlockMesh] = None,
) -> dict[str, torch.Tensor]:
    """Bucketed ranged decode: pad ``ids`` to its power-of-two bucket,
    decode on the blocks' device, and slice the outputs back to
    ``len(ids)``. ``postprocess`` (e.g. output formatting) runs at the
    padded bucket shape.

    The decode runs over the lane shards of ``mesh`` (a
    :class:`BlockMesh`; :func:`decode_blocks_sharded`, the ids padded to
    the per-shard bucket times the shard count), or with no mesh as one
    shard on the blocks' device (a block-sharded residency's first
    device). The port has one
    decoder per device (the kernel on CUDA, its plain version on the CPU),
    so ``repro``'s ``decoder=`` / ``decoder_key=`` pair has no counterpart;
    a mesh that is not a BlockMesh (a ``DeviceMesh``) raises TypeError."""
    if mesh is not None and not isinstance(mesh, BlockMesh):
        raise TypeError(f"mesh= takes a BlockMesh (the store-level block mesh), got {type(mesh).__name__}")
    ids = np.asarray(ids, dtype=np.int64)
    if ids.size == 0:
        out = empty_decode(db.caps, db.device)
        return postprocess(out) if postprocess is not None else out
    if mesh is None:
        mesh = BlockMesh((db.device,))
    padded, valid = pad_block_ids(ids, mesh.shards)
    out = decode_blocks_sharded(db, padded, valid, mesh=mesh, postprocess=postprocess)
    if padded.size == ids.size:
        return out
    return {k: v[: ids.size] for k, v in out.items()}


# --------------------------------------------------------------------------
# fused decode: gather + decode + format in ONE launch
# --------------------------------------------------------------------------
# Formats opt in through a FUSER registry: ``fn(dec, kmer_k) -> tensor`` maps
# the padded decode dict to the format's output. The three built-in formats
# (2bit, kmer, onehot) are epilogues of the fused kernel B5 itself, and their
# fusers (repro_torch.core.api) state what the epilogue computes; any other
# format with a fuser runs it as torch ops on B5's 2bit output, and a format
# without one takes the two-step path. There is no path switch: CUDA
# tensors launch B5, CPU tensors take its plain version.

#: fmt name -> (out_key, fuser fn | None); None = decode IS the format (2bit)
_FORMAT_FUSERS: dict[str, tuple[str, Optional[Callable]]] = {}


def register_format_fuser(name: str, out_key: str, fn: Optional[Callable] = None) -> None:
    """Register ``fmt``'s fused formatter: ``fn(dec, kmer_k) -> tensor``
    over the padded decode dict. ``fn=None`` marks a format whose output is
    the decode itself (2bit)."""
    _FORMAT_FUSERS[name] = (out_key, fn)


def fused_format_supported(name: str) -> bool:
    return name in _FORMAT_FUSERS


def fused_decode_blocks_bucketed(
    db: DeviceBlocks,
    ids: np.ndarray,
    *,
    fmt_name: str,
    kmer_k: Optional[int] = None,
) -> dict[str, torch.Tensor]:
    """Single-launch bucketed decode+format: the fused twin of
    ``decode_blocks_bucketed(..., postprocess=apply_format)``, with the same
    pad, mask and slice steps and bit-identical outputs."""
    from repro_torch.kernels.sage_decode import FUSED_EPILOGUES, sage_fused_decode

    if fmt_name not in _FORMAT_FUSERS:
        raise KeyError(
            f"format {fmt_name!r} has no registered fuser; "
            f"use the two-step decode path"
        )
    if db.mesh is not None:
        raise ValueError("the fused decode reads one device's residency; a block-sharded one takes "
                         "the two-step path (decode_blocks_bucketed)")
    out_key, fn = _FORMAT_FUSERS[fmt_name]
    epilogue = fmt_name if fmt_name in FUSED_EPILOGUES else "2bit"
    ids = np.asarray(ids, dtype=np.int64)
    if ids.size == 0:
        out = empty_decode(db.caps, db.device)
        if fn is not None:
            out[out_key] = fn(out, kmer_k)
        return out
    padded, valid = pad_block_ids(ids)
    out = sage_fused_decode(
        db.arrays, padded, valid, caps=db.caps, classes=db.classes, fixed_len=db.fixed_len,
        fmt=epilogue, kmer_k=kmer_k, upload=db.upload,
    )
    if epilogue != fmt_name and fn is not None:
        out[out_key] = fn(out, kmer_k)
    if padded.size == ids.size:
        return out
    return {k: v[: ids.size] for k, v in out.items()}
