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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_lib

F32 = torch.float32
MAX_CHUNK = 128  # longest chunk one CTA of the kernel holds (QM in ssd_chunk.cu)


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


def ssd_intra(x, dt, a, B_, C_):
    """The intra-chunk block; shapes and results as :func:`ssd_intra_plain`.

    CUDA: x in f32 or bf16 and every other input f32, all contiguous,
    Q <= 128. Q = 1 takes the decode route, Q >= 2 the tensor-core prefill
    route. The kernel has no backward yet, so it refuses inputs that require
    grad while grad mode is on."""
    _check_shapes(x, dt, a, B_, C_)
    if cuda_lib.on_cpu(x, dt, a, B_, C_):
        cuda_lib.COUNTS["plain:ssd_intra"] += 1
        return ssd_intra_plain(x, dt, a, B_, C_)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, B_, C_)):
        raise RuntimeError(
            "ssd_intra: the CUDA kernel has no backward yet (it comes with the "
            "training slice); call it under torch.no_grad() or inference_mode()"
        )
    if x.dtype not in (F32, torch.bfloat16):
        raise ValueError(f"ssd_intra: x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("dt", dt), ("a", a), ("B_", B_), ("C_", C_)):
        if t.dtype != F32:
            raise ValueError(f"ssd_intra: {name} must be float32, got {t.dtype}")
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
