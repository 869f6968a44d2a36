"""The SSD chunk-state chain: the state term of the SSD, the CUDA kernel
pair's wrapper and its plain torch version.

No TPU twin: the JAX package runs the recurrence across chunks of
``ssd_chunked`` as array ops around B6. Per (batch, head), over the chunks
c in order, from B6's outputs ``y_intra``, ``st`` and ``total``, the
log-decays ``a`` and C:

    cum = cumsum(a)  (per chunk)          e_q = exp(cum_q)
    y[c] = round(y_intra[c] + e ∘ (C[c] · S_inᵀ))
    S_in ← S_in · exp(total[c]) + st[c]

from ``state0`` (or zeros); the last ``S_in`` is the final state. The
wrapper launches ``csrc/ssd_chain.cu`` for CUDA tensors and takes the plain
version only for CPU tensors. Its product runs on the tensor cores in
split-precision TF32 (f32 accuracy, whatever
``torch.backends.cuda.matmul.allow_tf32`` says), as B6's do.

The gradient is :class:`SsdChain`, whose backward launches the backward
kernel for CUDA tensors and takes :func:`ssd_chain_bwd_plain` for CPU
tensors. From ``dy`` and the final state's gradient, per chunk in reverse,
with ``G`` the gradient of the chunk's outgoing state:

    d y_intra = dy                      dst[c] = G
    dtotal[c] = exp(total[c]) · Σ G ∘ S_in
    dC = e ∘ (dy · S_in)                dcum_q = Σ_n C_qn dC_qn
    da = reverse_cumsum(dcum)           G ← G · exp(total[c]) + Σ_q e_q dy_qᵀ C_q

and ``dstate0`` is the last ``G``. The backward reads each chunk's
incoming state, which the forward keeps (``mid``, chunks 1 ... nc - 1).
``cum`` is summed in f64 and rounded to f32 once, as B6 does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ssd_chunk import MAX_CHUNK

F32 = torch.float32
MAX_STATE = 128  # widest state the kernels hold (NM in ssd_chain.cu)
MAX_BWD_HEAD_DIM = 64  # widest head dim one backward launch holds (PB in ssd_chain.cu)


def _exp_cum(a):
    """e = exp(cumsum(a)) over each chunk (dim 2), summed in f64."""
    return torch.exp(torch.cumsum(a.to(torch.float64), dim=2).to(F32))


def ssd_chain_plain(y_intra, st, total, a, C_, state0=None, keep=False):
    """y_intra: (B, nc, Q, H, P) in x's dtype; st: (B, nc, H, P, N) f32;
    total: (B, nc, H); a: (B, nc, Q, H); C_: (B, nc, Q, H, N); state0:
    (B, H, P, N) or None.

    Returns (y (B,nc,Q,H,P) in y_intra's dtype, final state (B,H,P,N) f32,
    the incoming states of chunks 1 ... nc - 1 (B,nc-1,H,P,N) f32 when
    ``keep``, else None). y is the f32 sum of y_intra and the state term,
    rounded once."""
    Bb, nc, _Q, H, P = y_intra.shape
    N = C_.shape[-1]
    state = torch.zeros((Bb, H, P, N), dtype=F32, device=y_intra.device) if state0 is None else state0.to(F32)
    decay = torch.exp(total.to(F32))  # (B,nc,H)
    states_in = []  # the INCOMING state of each chunk
    for c in range(nc):
        states_in.append(state)
        state = state * decay[:, c, :, None, None] + st[:, c]
    states_in = torch.stack(states_in, dim=1)  # (B,nc,H,P,N)
    y_state = torch.einsum("bcqhn,bchdn->bcqhd", C_.to(F32), states_in) * _exp_cum(a)[..., None]
    y = (y_intra.to(F32) + y_state).to(y_intra.dtype)
    return y, state, (states_in[:, 1:] if keep else None)


def ssd_chain_bwd_plain(total, a, C_, mid, state0, dy, dfinal):
    """The gradient of :func:`ssd_chain_plain`, written out (not autograd).

    ``mid``: the incoming states of chunks 1 ... nc - 1 (None at nc = 1);
    ``state0``: the first chunk's, or None for zeros; dy: (B,nc,Q,H,P) in
    any float type; dfinal: the final state's gradient, or None for zeros.
    Returns (dst (B,nc,H,P,N), dtotal (B,nc,H), da (B,nc,Q,H), dC
    (B,nc,Q,H,N), dstate0 (B,H,P,N), or None where ``state0`` is), all f32.
    The gradient of y_intra is dy itself. The reverse cumulative sum that
    gives ``da`` runs in f64."""
    Bb, nc, _Q, H, P = dy.shape
    N = C_.shape[-1]
    dev = dy.device
    C_ = C_.to(F32)
    s0 = torch.zeros((Bb, H, P, N), dtype=F32, device=dev) if state0 is None else state0.to(F32)
    states_in = s0[:, None] if nc == 1 else torch.cat([s0[:, None], mid.to(F32)], dim=1)
    dz = dy.to(F32) * _exp_cum(a)[..., None]  # (B,nc,Q,H,P)
    dC = torch.einsum("bcqhp,bchpn->bcqhn", dz, states_in)
    dcum = (C_ * dC).sum(-1)  # (B,nc,Q,H)
    da = torch.flip(torch.cumsum(torch.flip(dcum.to(torch.float64), (2,)), 2), (2,)).to(F32)
    dS = torch.einsum("bcqhp,bcqhn->bchpn", dz, C_)  # each chunk's own gradient of S_in
    decay = torch.exp(total.to(F32))
    g = torch.zeros_like(s0) if dfinal is None else dfinal.to(F32)
    dst = torch.empty((Bb, nc, H, P, N), dtype=F32, device=dev)
    dtotal = torch.empty((Bb, nc, H), dtype=F32, device=dev)
    for c in reversed(range(nc)):
        dst[:, c] = g
        dtotal[:, c] = decay[:, c] * (g * states_in[:, c]).sum((-2, -1))
        g = g * decay[:, c, :, None, None] + dS[:, c]
    return dst, dtotal, da, dC, (None if state0 is None else g)


@functools.cache
def _lib():
    lib = cuda_lib.lib("ssd_chain")
    lib.ssd_chain_fwd_launch.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
                                         + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.ssd_chain_bwd_launch.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 11
                                         + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.ssd_chain_bwd_halves.argtypes = [ctypes.c_int]
    for fn in (lib.ssd_chain_fwd_launch, lib.ssd_chain_bwd_launch, lib.ssd_chain_fwd_smem_bytes,
               lib.ssd_chain_bwd_smem_bytes, lib.ssd_chain_bwd_halves):
        fn.restype = ctypes.c_int
    lib.ssd_chain_error_string.restype = ctypes.c_char_p
    return lib


def plan(shape) -> dict:
    """The two kernels' launches at (B, nc, Q, H, P, N): CTAs, threads and
    shared memory a CTA (from the built library), and the backward's
    head-dim chunks (one launch each)."""
    Bb, _nc, _Q, H, P, N = shape
    lib = _lib()
    return {"fwd": {"ctas": Bb * H * -(-P // 64), "threads": 256, "smem_bytes": lib.ssd_chain_fwd_smem_bytes()},
            "bwd": {"ctas": Bb * H * lib.ssd_chain_bwd_halves(N), "threads": 256,
                    "smem_bytes": lib.ssd_chain_bwd_smem_bytes(), "head_chunks": -(-P // MAX_BWD_HEAD_DIM)}}


def _check(y_intra, st, total, a, C_, state0) -> None:
    if y_intra.dim() != 5:
        raise ValueError(f"ssd_chain: y_intra must be (B, nc, Q, H, P), got {tuple(y_intra.shape)}")
    Bb, nc, Q, H, P = y_intra.shape
    N = C_.shape[-1]
    want = {"st": (st, (Bb, nc, H, P, N)), "total": (total, (Bb, nc, H)), "a": (a, (Bb, nc, Q, H)),
            "C_": (C_, (Bb, nc, Q, H, N))}
    if state0 is not None:
        want["state0"] = (state0, (Bb, H, P, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_chain: {name} must be {shape}, got {tuple(t.shape)}")


def _check_card(name, x, tensors) -> None:
    """What the kernels take: x in f32 or bf16, every other tensor f32, all
    on one CUDA device and contiguous, Q <= 128, N <= 128."""
    if x.dtype not in (F32, torch.bfloat16):
        raise ValueError(f"{name}: y_intra and dy must be float32 or bfloat16, got {x.dtype}")
    for arg, t in tensors.items():
        if t is not None and t.dtype != F32:
            raise ValueError(f"{name}: {arg} must be float32, got {t.dtype}")
    cuda_lib.require_cuda(x, *(t for t in tensors.values() if t is not None), name=name)
    Q, N = x.shape[2], tensors["C_"].shape[-1]
    if Q > MAX_CHUNK:
        raise ValueError(f"{name}: chunk length {Q} exceeds the kernel's {MAX_CHUNK}")
    if N > MAX_STATE:
        raise ValueError(f"{name}: state size {N} exceeds the kernel's {MAX_STATE}")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _forward(y_intra, st, total, a, C_, state0, keep):
    """One launch of the forward kernel (CUDA) or its plain version (CPU):
    (y, final state, the incoming states of chunks 1 ... nc - 1 or None)."""
    if cuda_lib.on_cpu(*(t for t in (y_intra, st, total, a, C_, state0) if t is not None)):
        cuda_lib.COUNTS["plain:ssd_chain"] += 1
        return ssd_chain_plain(y_intra, st, total, a, C_, state0, keep)
    _check_card("ssd_chain", y_intra, {"st": st, "total": total, "a": a, "C_": C_, "state0": state0})
    Bb, nc, Q, H, P = y_intra.shape
    N = C_.shape[-1]
    dev = y_intra.device
    y = torch.empty_like(y_intra)
    fin = torch.empty((Bb, H, P, N), dtype=F32, device=dev)
    mid = torch.empty((Bb, nc - 1, H, P, N), dtype=F32, device=dev) if keep and nc > 1 else None
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.ssd_chain_fwd_launch(
            y_intra.data_ptr(), int(y_intra.dtype == torch.bfloat16), st.data_ptr(), total.data_ptr(),
            a.data_ptr(), C_.data_ptr(), _ptr(state0), y.data_ptr(), fin.data_ptr(), _ptr(mid),
            Bb, nc, Q, H, P, N, torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "ssd_chain", lib.ssd_chain_error_string)
    cuda_lib.COUNTS["launch:ssd_chain"] += 1
    return y, fin, mid


def _bwd_launch(total, a, C_, mid, state0, dy, dfinal):
    """One launch of the backward kernel: P <= MAX_BWD_HEAD_DIM."""
    Bb, nc, Q, H, P = dy.shape
    N = C_.shape[-1]
    dev = dy.device
    lib = _lib()
    halves = lib.ssd_chain_bwd_halves(N)  # each half of the state columns gives its share of dtotal and da
    dst = torch.empty((Bb, nc, H, P, N), dtype=F32, device=dev)
    dtotal = torch.empty((halves, Bb, nc, H), dtype=F32, device=dev)
    da = torch.empty((halves, Bb, nc, Q, H), dtype=F32, device=dev)
    dC = torch.empty((Bb, nc, Q, H, N), dtype=F32, device=dev)
    ds0 = None if state0 is None else torch.empty((Bb, H, P, N), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ssd_chain_bwd_launch(
            dy.data_ptr(), int(dy.dtype == torch.bfloat16), total.data_ptr(), a.data_ptr(), C_.data_ptr(),
            _ptr(mid), _ptr(state0), _ptr(dfinal), dst.data_ptr(), dtotal.data_ptr(), da.data_ptr(),
            dC.data_ptr(), _ptr(ds0), Bb, nc, Q, H, P, N, torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "ssd_chain_bwd", lib.ssd_chain_error_string)
    if halves == 2:
        return dst, dtotal[0] + dtotal[1], da[0] + da[1], dC, ds0
    return dst, dtotal[0], da[0], dC, ds0


def bwd_by_head_chunks(fn, width, total, a, C_, mid, state0, dy, dfinal):
    """``fn``, a gradient with the signature of :func:`ssd_chain_bwd_plain`,
    over head-dim chunks of at most ``width`` columns of dy and rows of the
    states. dst and dstate0 are the chunks' side by side; dtotal, da and dC
    are sums over the head dim, so each is the sum of the chunks', taken in
    chunk order. At P <= ``width`` this is one call of ``fn``."""
    P = dy.shape[-1]
    if P <= width:
        return fn(total, a, C_, mid, state0, dy, dfinal)

    def rows(t, cols):
        return None if t is None else t[..., cols, :].contiguous()

    parts = [fn(total, a, C_, rows(mid, cols), rows(state0, cols), dy[..., cols].contiguous(), rows(dfinal, cols))
             for cols in (slice(p0, p0 + width) for p0 in range(0, P, width))]
    dst = torch.cat([p[0] for p in parts], dim=-2)
    ds0 = None if parts[0][4] is None else torch.cat([p[4] for p in parts], dim=-2)
    sums = [functools.reduce(torch.add, (p[i] for p in parts)) for i in (1, 2, 3)]
    return (dst, *sums, ds0)


def ssd_chain_bwd(total, a, C_, mid, state0, dy, dfinal):
    """The chain's gradient; inputs and results as :func:`ssd_chain_bwd_plain`.

    CUDA: ``csrc/ssd_chain.cu``; dy in f32 or bf16, every other input f32,
    all contiguous, Q <= 128, N <= 128, any P: one launch holds 64 head-dim
    columns, a wider head runs one launch a 64-column chunk
    (:func:`bwd_by_head_chunks`). Either counts one
    ``launch:ssd_chain_bwd``."""
    tensors = {"total": total, "a": a, "C_": C_, "mid": mid, "state0": state0, "dfinal": dfinal}
    if cuda_lib.on_cpu(dy, *(t for t in tensors.values() if t is not None)):
        cuda_lib.COUNTS["plain:ssd_chain_bwd"] += 1
        return ssd_chain_bwd_plain(total, a, C_, mid, state0, dy, dfinal)
    Bb, nc, _Q, H, P = dy.shape
    N = C_.shape[-1]
    if mid is None and nc > 1:
        raise ValueError("ssd_chain_bwd: mid (the incoming states of chunks 1 ... nc - 1) is required at nc > 1")
    if mid is not None and tuple(mid.shape) != (Bb, nc - 1, H, P, N):
        raise ValueError(f"ssd_chain_bwd: mid must be {(Bb, nc - 1, H, P, N)}, got {tuple(mid.shape)}")
    if dfinal is not None and tuple(dfinal.shape) != (Bb, H, P, N):
        raise ValueError(f"ssd_chain_bwd: dfinal must be {(Bb, H, P, N)}, got {tuple(dfinal.shape)}")
    _check_card("ssd_chain_bwd", dy, tensors)
    out = bwd_by_head_chunks(_bwd_launch, MAX_BWD_HEAD_DIM, total, a, C_, mid, state0, dy, dfinal)
    cuda_lib.COUNTS["launch:ssd_chain_bwd"] += 1
    return out


class SsdChain(torch.autograd.Function):
    """The chain with its gradient: the forward is one launch of the forward
    kernel (or its plain version on the CPU), which also keeps the incoming
    state of chunks 1 ... nc - 1; the backward one launch of the backward
    kernel (or :func:`ssd_chain_bwd_plain`). An unused final state gives no
    gradient to read (``dfinal`` None)."""

    @staticmethod
    def forward(ctx, y_intra, st, total, a, C_, state0):
        ctx.set_materialize_grads(False)
        y, fin, mid = _forward(y_intra, st, total, a, C_, state0, keep=True)
        ctx.save_for_backward(total, a, C_, mid, state0)
        ctx.y_meta = (y_intra.shape, y_intra.dtype)
        return y, fin

    @staticmethod
    def backward(ctx, dy, dfinal):
        total, a, C_, mid, state0 = ctx.saved_tensors
        shape, dtype = ctx.y_meta
        dy = torch.zeros(shape, dtype=dtype, device=a.device) if dy is None else dy.to(dtype).contiguous()
        dst, dtotal, da, dC, ds0 = ssd_chain_bwd(total, a, C_, mid, state0, dy,
                                                 None if dfinal is None else dfinal.contiguous())
        return dy, dst, dtotal, da, dC, (ds0 if ctx.needs_input_grad[5] else None)


def ssd_chain(y_intra, st, total, a, C_, state0=None):
    """The state term; shapes and results (y, final state) as
    :func:`ssd_chain_plain`.

    CUDA: y_intra in f32 or bf16 and every other input f32, all contiguous,
    Q <= 128, N <= 128, any P. While grad mode is on and an input requires
    grad, the call goes through :class:`SsdChain`; otherwise (serving) it is
    one launch of the forward kernel and nothing is kept for a backward."""
    _check(y_intra, st, total, a, C_, state0)
    if state0 is not None:
        state0 = state0.to(F32).contiguous()
    ins = (y_intra, st, total, a, C_, state0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ins):
        return SsdChain.apply(*ins)
    y, fin, _ = _forward(*ins, keep=False)
    return y, fin
