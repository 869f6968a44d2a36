"""Mamba2 SSD intra-chunk block (B6): the CUDA kernel's wrapper and its plain
torch version.

Replaces the TPU kernel ``ssd_intra_pallas`` (``_ssd_intra_kernel``). Per
(batch b, chunk c) and head, with the log-decay ``a = dt·A`` (<= 0):

    cum = cumsum(a)          L[i,j] = exp(cum_i - cum_j)·[i >= j]
    y   = ((C·Bᵀ) ∘ L) · (x·dt)
    st  = Σ_q B_q x_q dt_q exp(total - cum_q)        total = cum[-1]

The linear recurrence across chunks runs outside, in ``kernels.ops.ssd``.
The wrapper launches ``csrc/ssd_chunk.cu`` for CUDA tensors and takes the
plain version only for CPU tensors. The kernel has two routes, picked from
the shape alone: Q >= 2 (prefill) runs the three products on tensor cores
in split-precision TF32 (f32 accuracy, whatever
``torch.backends.cuda.matmul.allow_tf32`` says), Q = 1 (a decode step) a
bandwidth-bound kernel that writes the state ``(x·dt) ⊗ B``.

The gradient (no TPU twin: the JAX package differentiates its plain
``ssd_chunked``) is :class:`SsdIntra`, whose backward launches
``csrc/ssd_chunk_bwd.cu`` for CUDA tensors (its seven products on tensor
cores in split-precision TF32 over the causal tiles, f32 accuracy whatever
``allow_tf32`` says) and takes :func:`ssd_intra_bwd_plain` for CPU
tensors. Per (b, c, head), with ``u_j = x_j·dt_j``, ``M = (C·Bᵀ)∘L``,
``g_q = exp(total - cum_q)`` and ``w_q = dt_q·g_q``, from the gradients
``dy``, ``dst`` and ``dtotal``:

    dM = (dy·uᵀ)∘[i >= j]      du = Mᵀ·dy        sB_q = dst·B_q    dw_q = x_q·sB_q
    dx = du·dt + w·sB          ddt = Σ_P du∘x + g·dw
    dC = (dM∘L)·B              dB = (dM∘L)ᵀ·C + w·(dstᵀ·x)
    G = dM∘M                   dcum_i = Σ_j G[i,j] - Σ_k G[k,i] - dw_i·w_i
                               dcum_{Q-1} += dtotal + Σ_q dw_q·w_q
    da = reverse_cumsum(dcum)
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_lib

F32 = torch.float32
MAX_CHUNK = 128  # longest chunk one CTA of the kernel holds (QM in ssd_chunk.cu)
MAX_BWD_HEAD_DIM = 128  # widest head dim one gradient launch holds (PMAX in ssd_chunk_bwd.cu)


def ssd_intra_plain(x, dt, a, B_, C_):
    """x: (B, nc, Q, H, P); dt, a: (B, nc, Q, H); B_, C_: (B, nc, Q, H, N).

    Returns (y (B,nc,Q,H,P) in x's dtype, chunk state (B,nc,H,P,N) f32,
    total log-decay (B,nc,H) f32). The causal mask is a select: ``exp`` of
    the upper triangle may be +inf.

    ``cum`` is summed and differenced in f64, and only the differences
    ``cum_i - cum_j`` and ``total - cum_q`` are rounded to f32: at Q = 128
    a chunk's log-decay reaches hundreds, and differences of f32 sums that
    large lose ~1e-4 of ``L`` (``ssd_intra_pallas`` does so). All other
    arithmetic is f32, as in the kernel."""
    Q = x.shape[2]
    xf, dt = x.to(F32), dt.to(F32)
    B_, C_ = B_.to(F32), C_.to(F32)
    cum = torch.cumsum(a.to(torch.float64), dim=2)  # (B,nc,Q,H)
    total = cum[:, :, -1]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp((cum[:, :, :, None, :] - cum[:, :, None, :, :]).to(F32))  # (B,nc,Q,Q,H)
    L = torch.where(tri[None, None, :, :, None], L, torch.zeros((), dtype=F32, device=x.device))
    M = torch.einsum("bcqhn,bcphn->bcqph", C_, B_) * L
    y = torch.einsum("bcqph,bcphd->bcqhd", M, xf * dt[..., None])
    w = dt * torch.exp((total[:, :, None, :] - cum).to(F32))  # (B,nc,Q,H)
    st = torch.einsum("bcqhn,bcqhd->bchdn", B_ * w[..., None], xf)
    return y.to(x.dtype), st, total.to(F32)


@functools.cache
def _lib():
    lib = cuda_lib.lib("ssd_chunk")
    ptrs = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
    lib.ssd_prefill_launch.argtypes = ptrs + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.ssd_decode_launch.argtypes = ptrs + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    for fn in (lib.ssd_prefill_launch, lib.ssd_decode_launch):
        fn.restype = ctypes.c_int
    lib.ssd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib():
    lib = cuda_lib.lib("ssd_chunk_bwd")
    lib.ssd_bwd_launch.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 12
                                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.ssd_bwd_launch.restype = ctypes.c_int
    lib.ssd_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ssd_bwd_smem_bytes.restype = ctypes.c_int
    lib.ssd_bwd_error_string.restype = ctypes.c_char_p
    return lib


def bwd_plan(shape, x_dtype) -> dict:
    """The gradient kernel's launch at (B, nc, Q, H, P, N) with x of
    ``x_dtype``: head-dim chunks (one kernel launch each, one at P <= 128),
    CTAs (one a (b, chunk, head)), threads a CTA and shared memory a CTA,
    from the built library."""
    Bb, nc, _Q, H, P, _N = shape
    return {"head_chunks": -(-P // MAX_BWD_HEAD_DIM), "ctas": Bb * nc * H, "threads": 256,
            "smem_bytes": _bwd_lib().ssd_bwd_smem_bytes(min(P, MAX_BWD_HEAD_DIM), int(x_dtype == torch.bfloat16))}


def _check_shapes(x, dt, a, B_, C_) -> None:
    if x.dim() != 5:
        raise ValueError(f"ssd_intra: x must be (B, nc, Q, H, P), got {tuple(x.shape)}")
    Bb, nc, Q, H, _P = x.shape
    for name, t in (("dt", dt), ("a", a)):
        if tuple(t.shape) != (Bb, nc, Q, H):
            raise ValueError(f"ssd_intra: {name} must be {(Bb, nc, Q, H)}, got {tuple(t.shape)}")
    if B_.dim() != 5 or tuple(B_.shape[:4]) != (Bb, nc, Q, H) or C_.shape != B_.shape:
        raise ValueError(
            f"ssd_intra: B_ and C_ must be {(Bb, nc, Q, H)} + (N,), got "
            f"{tuple(B_.shape)} and {tuple(C_.shape)}"
        )


def _check_dtypes(name, x, *f32) -> None:
    if x.dtype not in (F32, torch.bfloat16):
        raise ValueError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    for arg, t in f32:
        if t.dtype != F32:
            raise ValueError(f"{name}: {arg} must be float32, got {t.dtype}")


def _forward(x, dt, a, B_, C_):
    """One launch of the forward kernel (CUDA) or its plain version (CPU)."""
    if cuda_lib.on_cpu(x, dt, a, B_, C_):
        cuda_lib.COUNTS["plain:ssd_intra"] += 1
        return ssd_intra_plain(x, dt, a, B_, C_)
    _check_dtypes("ssd_intra", x, ("dt", dt), ("a", a), ("B_", B_), ("C_", C_))
    cuda_lib.require_cuda(x, dt, a, B_, C_, name="ssd_intra")
    Bb, nc, Q, H, P = x.shape
    N = B_.shape[-1]
    if Q > MAX_CHUNK:
        raise ValueError(f"ssd_intra: chunk length {Q} exceeds the kernel's {MAX_CHUNK}")
    dev = x.device
    y = torch.empty_like(x)
    st = torch.empty((Bb, nc, H, P, N), dtype=F32, device=dev)
    total = torch.empty((Bb, nc, H), dtype=F32, device=dev)
    lib = _lib()
    ptrs = (x.data_ptr(), int(x.dtype == torch.bfloat16), dt.data_ptr(), a.data_ptr(),
            B_.data_ptr(), C_.data_ptr(), y.data_ptr(), st.data_ptr(), total.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if Q == 1:
            rc = lib.ssd_decode_launch(*ptrs, Bb, nc, H, P, N, stream)
        else:
            rc = lib.ssd_prefill_launch(*ptrs, Bb, nc, Q, H, P, N, stream)
    cuda_lib.check(rc, "ssd_intra", lib.ssd_error_string)
    cuda_lib.COUNTS["launch:ssd_intra"] += 1
    return y, st, total


def ssd_intra(x, dt, a, B_, C_):
    """The intra-chunk block; shapes and results as :func:`ssd_intra_plain`.

    CUDA: x in f32 or bf16 and every other input f32, all contiguous,
    Q <= 128. Q = 1 takes the decode route, Q >= 2 the tensor-core prefill
    route. While grad mode is on and an input requires grad, the call goes
    through :class:`SsdIntra`, whose backward is B6's gradient kernel;
    otherwise (serving) it is one launch of the forward kernel and nothing
    is kept for a backward."""
    _check_shapes(x, dt, a, B_, C_)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, B_, C_)):
        return SsdIntra.apply(x, dt, a, B_, C_)
    return _forward(x, dt, a, B_, C_)


def ssd_intra_bwd_plain(x, dt, a, B_, C_, dy, dst, dtotal):
    """The gradient of :func:`ssd_intra_plain`, written out (not autograd).

    dy: (B,nc,Q,H,P) in any float type; dst: (B,nc,H,P,N); dtotal:
    (B,nc,H). Returns (dx in x's dtype, ddt, da, dB, dC in f32). ``cum``
    is summed in f64 and only its differences are rounded to f32, as in the
    forward; the reverse cumulative sum that gives ``da`` runs in f64 too.
    Everything else is f32, as in the kernel."""
    Q = x.shape[2]
    dev = x.device
    xf, dyf, dt = x.to(F32), dy.to(F32), dt.to(F32)
    B_, C_, dst, dtotal = B_.to(F32), C_.to(F32), dst.to(F32), dtotal.to(F32)
    cum = torch.cumsum(a.to(torch.float64), dim=2)  # (B,nc,Q,H)
    total = cum[:, :, -1]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()[None, None, :, :, None]
    zero = torch.zeros((), dtype=F32, device=dev)
    L = torch.where(tri, torch.exp((cum[:, :, :, None, :] - cum[:, :, None, :, :]).to(F32)), zero)
    M = torch.einsum("bcihn,bcjhn->bcijh", C_, B_) * L  # (B,nc,Q,Q,H): [i, j]
    u = xf * dt[..., None]
    dM = torch.where(tri, torch.einsum("bcihp,bcjhp->bcijh", dyf, u), zero)
    du = torch.einsum("bcijh,bcihp->bcjhp", M, dyf)
    g = torch.exp((total[:, :, None, :] - cum).to(F32))  # (B,nc,Q,H)
    w = dt * g
    sB = torch.einsum("bchpn,bcqhn->bcqhp", dst, B_)  # dst·B_q
    dw = (xf * sB).sum(-1)
    dx = du * dt[..., None] + w[..., None] * sB
    ddt = (du * xf).sum(-1) + g * dw
    dS = dM * L
    dC = torch.einsum("bcijh,bcjhn->bcihn", dS, B_)
    dB = torch.einsum("bcijh,bcihn->bcjhn", dS, C_) + w[..., None] * torch.einsum("bchpn,bcqhp->bcqhn", dst, xf)
    G = dM * M
    dw_w = dw * w
    dcum = G.sum(3) - G.sum(2) - dw_w  # rows i minus columns i
    dcum[:, :, -1] += dtotal + dw_w.sum(2)
    da = torch.flip(torch.cumsum(torch.flip(dcum.to(torch.float64), (2,)), 2), (2,))
    return dx.to(x.dtype), ddt, da.to(F32), dB, dC


def bwd_by_head_chunks(fn, width, x, dt, a, B_, C_, dy, dst, dtotal):
    """``fn``, a gradient with the signature of :func:`ssd_intra_bwd_plain`,
    over head-dim chunks of at most ``width`` columns of x, dy and dst.

    dx is the chunks' dx side by side. Every other result is linear in
    sums over the head dim (dy·uᵀ, dstᵀ·x, Σ_P du∘x, dw), so it is the sum
    of the chunks' results, taken in chunk order, with ``dtotal`` entering
    the first chunk alone. At P <= ``width`` this is one call of ``fn``."""
    P = x.shape[-1]
    if P <= width:
        return fn(x, dt, a, B_, C_, dy, dst, dtotal)
    dxs, sums = [], None
    for p0 in range(0, P, width):
        cols = slice(p0, p0 + width)
        part = fn(x[..., cols].contiguous(), dt, a, B_, C_, dy[..., cols].contiguous(),
                  dst[..., cols, :].contiguous(), dtotal if p0 == 0 else torch.zeros_like(dtotal))
        dxs.append(part[0])
        sums = list(part[1:]) if sums is None else [u + v for u, v in zip(sums, part[1:])]
    return (torch.cat(dxs, dim=-1), *sums)


def _bwd_launch(x, dt, a, B_, C_, dy, dst, dtotal):
    """One launch of the gradient kernel: P <= MAX_BWD_HEAD_DIM."""
    Bb, nc, Q, H, P = x.shape
    N = B_.shape[-1]
    dev = x.device
    dx = torch.empty_like(x)
    ddt = torch.empty((Bb, nc, Q, H), dtype=F32, device=dev)
    da = torch.empty_like(ddt)
    dB = torch.empty((Bb, nc, Q, H, N), dtype=F32, device=dev)
    dC = torch.empty_like(dB)
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        rc = lib.ssd_bwd_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), dt.data_ptr(), a.data_ptr(), B_.data_ptr(),
            C_.data_ptr(), dy.data_ptr(), dst.data_ptr(), dtotal.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), da.data_ptr(), dB.data_ptr(), dC.data_ptr(), Bb, nc, Q, H, P, N,
            torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "ssd_intra_bwd", lib.ssd_bwd_error_string)
    return dx, ddt, da, dB, dC


def ssd_intra_bwd(x, dt, a, B_, C_, dy, dst, dtotal):
    """B6's gradient; inputs and results as :func:`ssd_intra_bwd_plain`.

    CUDA: ``csrc/ssd_chunk_bwd.cu``; x and dy in the same type (f32 or
    bf16), every other input f32, all contiguous, Q <= 128, any P. The
    kernel keeps x and dy in shared memory, so one launch takes at most 128
    head-dim columns: P <= 128 is one launch, a wider head one launch a
    128-column chunk (:func:`bwd_by_head_chunks`). Either counts one
    ``launch:ssd_intra_bwd``."""
    _check_shapes(x, dt, a, B_, C_)
    if cuda_lib.on_cpu(x, dt, a, B_, C_, dy, dst, dtotal):
        cuda_lib.COUNTS["plain:ssd_intra_bwd"] += 1
        return ssd_intra_bwd_plain(x, dt, a, B_, C_, dy, dst, dtotal)
    Bb, nc, Q, H, P = x.shape
    N = B_.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"ssd_intra_bwd: dy must be {tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    if tuple(dst.shape) != (Bb, nc, H, P, N) or tuple(dtotal.shape) != (Bb, nc, H):
        raise ValueError(f"ssd_intra_bwd: dst must be {(Bb, nc, H, P, N)} and dtotal {(Bb, nc, H)}, "
                         f"got {tuple(dst.shape)} and {tuple(dtotal.shape)}")
    _check_dtypes("ssd_intra_bwd", x, ("dt", dt), ("a", a), ("B_", B_), ("C_", C_),
                  ("dst", dst), ("dtotal", dtotal))
    cuda_lib.require_cuda(x, dt, a, B_, C_, dy, dst, dtotal, name="ssd_intra_bwd")
    if Q > MAX_CHUNK:
        raise ValueError(f"ssd_intra_bwd: chunk length {Q} exceeds the kernel's {MAX_CHUNK}")
    out = bwd_by_head_chunks(_bwd_launch, MAX_BWD_HEAD_DIM, x, dt, a, B_, C_, dy, dst, dtotal)
    cuda_lib.COUNTS["launch:ssd_intra_bwd"] += 1
    return out


class SsdIntra(torch.autograd.Function):
    """B6 with its gradient: the forward is one launch of the forward kernel
    (or its plain version on the CPU), the backward one of the gradient
    kernel (or :func:`ssd_intra_bwd_plain`). Inputs are kept, nothing else:
    the backward recomputes ``cum``, ``L`` and ``C·Bᵀ``."""

    @staticmethod
    def forward(ctx, x, dt, a, B_, C_):
        ctx.save_for_backward(x, dt, a, B_, C_)
        return _forward(x, dt, a, B_, C_)

    @staticmethod
    def backward(ctx, dy, dst, dtotal):
        x, dt, a, B_, C_ = ctx.saved_tensors
        return ssd_intra_bwd(x, dt, a, B_, C_, dy.to(x.dtype).contiguous(), dst.contiguous(),
                             dtotal.contiguous())
