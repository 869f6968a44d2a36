"""The port's SSD (B6's plain version, ``ops.ssd`` and the model reference
``ssd_chunked``) against the JAX package's interpret-mode Pallas kernel,
``ops.ssd(use_pallas=True)`` and ``ssd_chunked``, on the same numpy inputs.

Tolerances are those of tests/test_kernels.py: y within 1e-5 in f32 and
3e-2 in bf16 (the intra-chunk term is rounded to bf16 before the state
term is added on the kernel path), states within 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.kernels.ssd_chunk import ssd_intra_pallas
from repro.models.ssm import ssd_chunked as jax_ssd_chunked

from repro_torch.kernels import cuda_lib, ops, ref
from repro_torch.kernels import ssd_chain as SC
from repro_torch.kernels.ssd_chunk import bwd_by_head_chunks, ssd_intra, ssd_intra_bwd_plain, ssd_intra_plain
from repro_torch.models.ssm import ssd_chunked

# (B, S, H, P, N, chunk): the three shapes of test_ssd_kernel_sweep
SWEEP = [(2, 64, 4, 16, 16, 16), (1, 128, 8, 32, 32, 32), (2, 96, 2, 64, 64, 32)]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32), "bf16": (None, jnp.bfloat16, torch.bfloat16)}


def make(shape, seed, *, decay="mild"):
    """Inputs of the model's SSD as numpy: x, dt (post-softplus), A, B, C.
    ``decay="large"``: A down to -16 and dt near 2-3, so a chunk's log-decay
    reaches hundreds and exp of the upper triangle overflows to +inf."""
    B, S, H, P, N, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    if decay == "large":
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) + 2.0)).astype(np.float32)
        A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
        A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((B, S, H, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, H, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def to_jax(arrs, xdt):
    x, *rest = arrs
    return (jnp.asarray(x, xdt), *(jnp.asarray(a) for a in rest))


def to_torch(arrs, xdt):
    x, *rest = arrs
    return (torch.from_numpy(x).to(xdt), *(torch.from_numpy(a) for a in rest))


def f32(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def close(ours, theirs, tol):
    np.testing.assert_allclose(f32(ours), f32(theirs), rtol=tol, atol=tol)


def chunked(arrs, chunk):
    """The intra-chunk kernel's inputs for S a multiple of the chunk."""
    x, dt, A, Bm, Cm = arrs
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    a = dt * A[None, None, :]
    return (x.reshape(B, nc, Q, H, P), dt.reshape(B, nc, Q, H), a.reshape(B, nc, Q, H),
            Bm.reshape(B, nc, Q, H, N), Cm.reshape(B, nc, Q, H, N))


CASES = [(s, "mild") for s in SWEEP] + [((2, 64, 4, 16, 16, 32), "large")]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,decay", CASES, ids=[f"{s[1]}x{s[3]}-{d}" for s, d in CASES])
def test_intra_plain_matches_pallas(shape, decay, dtype):
    _, jdt, tdt = DTYPES[dtype]
    arrs = chunked(make(shape, seed=shape[1] + shape[3], decay=decay), shape[-1])
    yj, sj, tj = ssd_intra_pallas(*to_jax(arrs, jdt), interpret=True)
    yt, st, tt = ssd_intra_plain(*to_torch(arrs, tdt))
    assert yt.dtype == tdt and st.dtype == tt.dtype == torch.float32
    assert np.isfinite(f32(yt)).all() and np.isfinite(f32(st)).all()
    close(yt, yj, 1e-5 if dtype == "f32" else 3e-2)
    close(st, sj, 1e-4)
    close(tt, tj, 1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SWEEP, ids=[f"{s[1]}x{s[3]}" for s in SWEEP])
def test_ssd_matches_reference(shape, dtype):
    _, jdt, tdt = DTYPES[dtype]
    arrs = make(shape, seed=shape[1] + shape[3])
    chunk = shape[-1]
    cuda_lib.reset_counts()
    y, s = ops.ssd(*to_torch(arrs, tdt), chunk)
    assert cuda_lib.counts() == {"plain:ssd_intra": 1, "plain:ssd_chain": 1}  # one launch each for every chunk
    yk, sk = JOPS.ssd(*to_jax(arrs, jdt), chunk, use_pallas=True)
    yr, sr = jax_ssd_chunked(*to_jax(arrs, jdt), chunk)
    tol = 1e-5 if dtype == "f32" else 3e-2
    assert y.dtype == tdt and y.shape == tuple(shape[:4])
    for yy, ss in ((yk, sk), (yr, sr)):
        close(y, yy, tol)
        close(s, ss, 1e-4)
    # the model's reference path on both sides
    y2, s2 = ref.ssd_ref(*to_torch(arrs, tdt), chunk)
    close(y2, yr, tol)
    close(s2, sr, 1e-4)


@pytest.mark.parametrize("S,chunk", [(64, 16), (50, 16), (1, 16)], ids=["aligned", "ragged", "decode"])
def test_ssd_with_initial_state(S, chunk):
    """``state0`` carries into the first chunk; S = 50 pads the last chunk
    with dt = 0 steps, S = 1 is a decode step (Q = 1)."""
    shape = (2, S, 4, 16, 16, chunk)
    arrs = make(shape, seed=S)
    s0 = (np.random.default_rng(7).standard_normal((2, 4, 16, 16)) * 0.1).astype(np.float32)
    y, s = ops.ssd(*to_torch(arrs, torch.float32), chunk, state0=torch.from_numpy(s0))
    yk, sk = JOPS.ssd(*to_jax(arrs, jnp.float32), chunk, state0=jnp.asarray(s0), use_pallas=True)
    yr, sr = jax_ssd_chunked(*to_jax(arrs, jnp.float32), chunk, jnp.asarray(s0))
    for yy, ss in ((yk, sk), (yr, sr)):
        close(y, yy, 1e-5)
        close(s, ss, 1e-4)
    y2, s2 = ssd_chunked(*to_torch(arrs, torch.float32), chunk, torch.from_numpy(s0))
    close(y2, yr, 1e-5)
    close(s2, sr, 1e-4)


def test_large_decay_has_no_nan():
    """With A down to -16 the upper triangle's exp overflows: a mask applied
    as a product (inf · 0) would give NaN; the select gives JAX's result."""
    shape = (2, 64, 4, 16, 16, 32)
    arrs = make(shape, seed=3, decay="large")
    x, dt, a, Bm, Cm = to_torch(chunked(arrs, 32), torch.float32)
    cum = torch.cumsum(a, dim=2)
    upper = torch.exp(cum[:, :, None, :, :] - cum[:, :, :, None, :])  # (b,c,j,i,h): exp(cum_i - cum_j)
    assert torch.isinf(upper).any()  # the case the select must survive
    y, s = ops.ssd(*to_torch(arrs, torch.float32), 32)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    yk, sk = JOPS.ssd(*to_jax(arrs, jnp.float32), 32, use_pallas=True)
    close(y, yk, 1e-5)
    close(s, sk, 1e-4)


def test_intra_wrapper_checks_shapes():
    x = torch.zeros((1, 2, 4, 3, 8))
    dt = torch.zeros((1, 2, 4, 3))
    Bm = torch.zeros((1, 2, 4, 3, 5))
    with pytest.raises(ValueError, match="dt"):
        ssd_intra(x, dt[..., :2], dt, Bm, Bm)
    with pytest.raises(ValueError, match="B_ and C_"):
        ssd_intra(x, dt, dt, Bm, Bm[..., :4])
    with pytest.raises(ValueError, match="x must be"):
        ssd_intra(x[0], dt, dt, Bm, Bm)


def test_intra_plain_accuracy_at_full_chunk():
    """At the model's chunk (Q = 128) a chunk's log-decay reaches hundreds:
    exp(cum_i - cum_j) of two f32 sums that large is off by ~1e-5 relative,
    so the TPU kernel's formulation misses the 1e-5 tolerance against an
    f64 evaluation, while the plain version (cum summed and differenced in
    f64) meets it; both hold the state within 1e-4."""
    Bb, nc, Q, H, P, N = 1, 2, 128, 32, 64, 128
    arrs = chunked(make((Bb, nc * Q, H, P, N, Q), seed=21), Q)
    x, dt, a, Bm, Cm = (torch.from_numpy(v).double() for v in arrs)
    cum = torch.cumsum(a, dim=2)
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()[None, None, :, :, None]
    L = torch.where(tri, torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :]), 0.0)
    M = torch.einsum("bcqhn,bcphn->bcqph", Cm, Bm) * L
    w = dt * torch.exp(cum[:, :, -1:, :] - cum)
    exact = (torch.einsum("bcqph,bcphd->bcqhd", M, x * dt[..., None]),
             torch.einsum("bcqhn,bcqhd->bchdn", Bm * w[..., None], x))  # f64 throughout
    ours = ssd_intra_plain(*to_torch(arrs, torch.float32))
    theirs = ssd_intra_pallas(*to_jax(arrs, jnp.float32), interpret=True)
    np.testing.assert_allclose(f32(ours[0]), exact[0].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f32(ours[1]), exact[1].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f32(theirs[1]), exact[1].numpy(), rtol=1e-4, atol=1e-4)
    y_err = np.abs(f32(theirs[0]) - exact[0].numpy()) - 1e-5 * np.abs(exact[0].numpy())
    assert y_err.max() > 1e-5  # the f32-cum formulation misses 1e-5 at Q = 128


def tf32(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the CPU: f32 rounded to nearest on 10
    mantissa bits, ties away from zero (the low 13 bits cleared)."""
    bits = v.to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_rz(v: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 register given as a TF32
    operand: the low 13 bits ignored, i.e. rounded toward zero."""
    return (v.to(torch.float32).view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(v: torch.Tensor):
    """The kernel's split of an f32 operand: hi = tf32(v), lo = v - hi, which
    the MMA truncates to TF32."""
    v = v.to(torch.float32)
    hi = tf32(v)
    return hi, tf32_rz(v - hi)


def product(eq: str, a, b, passes: int) -> torch.Tensor:
    """An einsum of f32 operands as the tensor cores take them: exact
    products of TF32 values (summed in f64 here), one pass (hi·hi), two
    (lo·hi + hi·hi: b taken as its TF32 value, exact when b is a bf16 value)
    or the 3xTF32 sum lo·hi + hi·lo + hi·hi."""
    (ah, al), (bh, bl) = split(a), split(b)
    terms = {1: [(ah, bh)], 2: [(al, bh), (ah, bh)], 3: [(al, bh), (ah, bl), (ah, bh)]}[passes]
    return sum(torch.einsum(eq, x.double(), y.double()) for x, y in terms)


def test_split_tf32_holds_the_tolerance():
    """Why B6's prefill route splits every operand: at mamba2-370m's
    prefill shape (two heads), emulating the TF32 rounding of the kernel's
    operands of C·Bᵀ and M·(x·dt), one TF32 pass misses 1e-5 on y against
    an f64 evaluation, while the 3xTF32 sum meets it (and the state's
    product 1e-4)."""
    Bb, nc, Q, H, P, N = 8, 4, 128, 2, 64, 128
    x, dt, a, Bm, Cm = (torch.from_numpy(v) for v in chunked(make((Bb, nc * Q, H, P, N, Q), seed=31), Q))
    cum = torch.cumsum(a.double(), dim=2)
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()[None, None, :, :, None]
    L = torch.where(tri, torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :]), 0.0)
    xdt = x * dt[..., None]  # f32, as the kernel stages it
    g = torch.exp((cum[:, :, -1:, :] - cum).float())
    exact_cb = torch.einsum("bcqhn,bcphn->bcqph", Cm.double(), Bm.double())
    exact_y = torch.einsum("bcqph,bcphd->bcqhd", exact_cb * L, xdt.double())
    exact_st = torch.einsum("bcqhd,bcqhn->bchdn", (xdt * g[..., None]).double(), Bm.double())

    def run(passes):
        M = (product("bcqhn,bcphn->bcqph", Cm, Bm, passes).float() * L.float())
        y = product("bcqph,bcphd->bcqhd", M, xdt, passes)
        st = product("bcqhd,bcqhn->bchdn", xdt * g[..., None], Bm, passes)
        return y, st

    def miss(got, want, tol):
        return float(((got - want).abs() - tol * want.abs()).max())

    y1, _ = run(1)
    y3, st3 = run(3)
    assert miss(y1, exact_y, 1e-5) > 1e-5  # one TF32 pass misses 1e-5 on y
    assert miss(y3, exact_y, 1e-5) <= 1e-5
    assert miss(st3, exact_st, 1e-4) <= 1e-4


# B6 backward's pass plan (csrc/ssd_chunk_bwd.cu) with bf16 x and dy: TF32
# passes a product, operands as the kernel gives them to the tensor cores
BWD_PASS_PLAN = {"S": 3, "dyx": 1, "du": 2, "sB": 3, "dC": 3, "dSC": 3, "dstx": 2}


def bwd_tf32(x, dt, a, Bm, Cm, dy, dst, plan=None):
    """dx, ddt, dB, dC of B6 backward as the kernel forms them, the seven
    products on emulated TF32 operands with ``plan``'s passes (summed in
    f64), the matrices the kernel keeps in f32 rounded to f32; with
    ``plan=None`` every operation is exact f64. x and dy are bf16 values."""
    exact = plan is None
    F = torch.float64 if exact else torch.float32

    def prod(name, eq, u, v):
        if exact:
            return torch.einsum(eq, u.double(), v.double())
        return product(eq, u, v, plan[name]).float()

    x, dy, dt = x.to(F), dy.to(F), dt.to(F)
    cum = torch.cumsum(a.double(), dim=2)
    Q = x.shape[2]
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()[None, None, :, :, None]
    L = torch.where(tri, torch.exp((cum[:, :, :, None, :] - cum[:, :, None, :, :]).to(F)), 0.0)
    g = torch.exp((cum[:, :, -1:, :] - cum).to(F))
    w = dt * g
    S = prod("S", "bcihn,bcjhn->bcijh", Cm, Bm)
    dM = prod("dyx", "bcihp,bcjhp->bcijh", dy, x) * dt[:, :, None]  # dt moved onto columns j
    dS, M = torch.where(tri, dM * L, 0.0), torch.where(tri, S * L, 0.0)
    du = prod("du", "bcijh,bcihp->bcjhp", M, dy)
    sB = prod("sB", "bcqhn,bchpn->bcqhp", Bm, dst)
    dC = prod("dC", "bcijh,bcjhn->bcihn", dS, Bm)
    dB = prod("dSC", "bcijh,bcihn->bcjhn", dS, Cm) + w[..., None] * prod("dstx", "bchpn,bcqhp->bcqhn", dst, x)
    dw = (x * sB).sum(-1)
    return du * dt[..., None] + w[..., None] * sB, (du * x).sum(-1) + g * dw, dB, dC


def test_bwd_tf32_pass_plan_holds_the_tolerance():
    """Why B6 backward runs each product with the passes it does: at
    mamba2-370m's train shape (two heads, bf16 x and dy), emulating the
    kernel's TF32 operands, its plan holds dx, ddt, dB and dC to rtol 1e-5
    and atol 1e-5·max|grad| (the card tests' bound) against an f64
    evaluation, and each product with one pass fewer misses it. The plan:
      S = C·Bᵀ        f32·f32     3 (3xTF32)
      dy·xᵀ           bf16·bf16   1 (exact; dt moved onto the columns j)
      du = Mᵀ·dy      f32·bf16    2 (M split, dy exact)
      sB = B·dstᵀ     f32·f32     3
      dC = dS·B       f32·f32     3
      dSᵀ·C           f32·f32     3
      x·dst           bf16·f32    2 (dst split, x exact)
    With f32 x every product that takes x or dy runs three passes."""
    Bb, nc, Q, H, P, N = 8, 4, 128, 2, 64, 128
    x, dt, a, Bm, Cm = (torch.from_numpy(v) for v in chunked(make((Bb, nc * Q, H, P, N, Q), seed=33), Q))
    rng = np.random.default_rng(34)
    x = x.to(torch.bfloat16).float()
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(torch.bfloat16).float()
    dst = torch.from_numpy(rng.standard_normal((Bb, nc, H, P, N)).astype(np.float32))
    args = (x, dt, a, Bm, Cm, dy, dst)
    exact = bwd_tf32(*args)

    def miss(plan):
        """The largest excess over the bound, over dx, ddt, dB and dC."""
        return max(float(((got.double() - want).abs() - 1e-5 * want.abs()).max() - 1e-5 * float(want.abs().max()))
                   for got, want in zip(bwd_tf32(*args, plan), exact))

    assert miss(BWD_PASS_PLAN) <= 0.0
    for name, passes in BWD_PASS_PLAN.items():
        if passes > 1:
            assert miss({**BWD_PASS_PLAN, name: passes - 1}) > 0.0, name


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bwd_by_head_chunks_matches_one_pass(xdt):
    """A head wider than one launch of B6 backward holds (P > 128) runs as
    head-dim chunks whose results are summed, dtotal in the first alone.
    With the plain gradient as the chunk's function, P 40 in chunks of 16,
    16 and 8 gives one pass's dx, ddt, da, dB and dC within the card tests'
    bound (rtol 1e-5, atol 1e-5·max|grad|: f32 sums in another order; dx in
    bf16 within one bf16 ulp)."""
    Bb, nc, Q, H, P, N = 2, 2, 16, 3, 40, 24
    x, dt, a, Bm, Cm = (torch.from_numpy(v) for v in chunked(make((Bb, nc * Q, H, P, N, Q), seed=35), Q))
    rng = np.random.default_rng(36)
    x = x.to(xdt)
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(xdt)
    dst = torch.from_numpy(rng.standard_normal((Bb, nc, H, P, N)).astype(np.float32))
    dtot = torch.from_numpy(rng.standard_normal((Bb, nc, H)).astype(np.float32))
    args = (x, dt, a, Bm, Cm, dy, dst, dtot)
    widths = []

    def plain(*chunk):
        widths.append(chunk[0].shape[-1])
        return ssd_intra_bwd_plain(*chunk)

    got = bwd_by_head_chunks(plain, 16, *args)
    assert widths == [16, 16, 8]
    for name, u, v in zip(("dx", "ddt", "da", "dB", "dC"), got, ssd_intra_bwd_plain(*args)):
        assert u.shape == v.shape and u.dtype == v.dtype, name
        rtol = 8e-3 if u.dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(u.float(), v.float(), rtol=rtol, atol=1e-5 * float(v.float().abs().max()),
                                   msg=lambda m, name=name: f"{name}: {m}")
    assert bwd_by_head_chunks(plain, P, *args)[0].shape == x.shape and widths[-1] == P


def test_bf16_x_needs_two_tf32_products():
    """Why B6 with bf16 x runs two MMAs a product of M·x and of the state:
    x is exact in TF32, so its lo part is zero. Moving dt onto M (and dt·g
    onto B) and summing lo·x + hi·x holds y to 1e-5 and the state to 1e-4
    against f64, at mamba2-370m's prefill shape with two heads; x's own
    TF32 rounding changes nothing."""
    Bb, nc, Q, H, P, N = 8, 4, 128, 2, 64, 128
    x, dt, a, Bm, Cm = (torch.from_numpy(v) for v in chunked(make((Bb, nc * Q, H, P, N, Q), seed=32), Q))
    x = x.to(torch.bfloat16).float()
    assert torch.equal(tf32(x), x) and torch.equal(tf32_rz(x), x)
    cum = torch.cumsum(a.double(), dim=2)
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()[None, None, :, :, None]
    L = torch.where(tri, torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :]), 0.0)
    w = dt * torch.exp((cum[:, :, -1:, :] - cum).float())  # dt·g, f32 as the kernel stages it
    cb = torch.einsum("bcqhn,bcphn->bcqph", Cm.double(), Bm.double())
    exact_y = torch.einsum("bcqph,bcphd->bcqhd", cb * L * dt.double()[:, :, None], x.double())
    exact_st = torch.einsum("bcqhd,bcqhn->bchdn", x.double(), (Bm * w[..., None]).double())

    def two(eq, a, xe):
        hi, lo = split(a)
        return sum(torch.einsum(eq, t.double(), xe.double()) for t in (lo, hi))

    M = product("bcqhn,bcphn->bcqph", Cm, Bm, 3).float() * L.float() * dt[:, :, None]
    y = two("bcqph,bcphd->bcqhd", M, x)
    st = two("bcqhn,bcqhd->bchdn", Bm * w[..., None], x)
    assert float(((y - exact_y).abs() - 1e-5 * exact_y.abs()).max()) <= 1e-5
    assert float(((st - exact_st).abs() - 1e-4 * exact_st.abs()).max()) <= 1e-4


def chain_reference(y_intra, st_c, total, ac, Cc, state0=None):
    """The state term as ``ops.ssd`` ran it before the chain was a kernel
    pair: a loop over chunks, f32 throughout (``cum`` summed in f32)."""
    Bb, nc, _Q, H, P = y_intra.shape
    N = Cc.shape[-1]
    state = torch.zeros((Bb, H, P, N)) if state0 is None else state0.to(torch.float32)
    decay = torch.exp(total)
    states_in = []
    for c in range(nc):
        states_in.append(state)
        state = state * decay[:, c, :, None, None] + st_c[:, c]
    states_in = torch.stack(states_in, dim=1)
    cum = torch.cumsum(ac, dim=2)
    y_state = torch.einsum("bcqhn,bchdn->bcqhd", Cc, states_in) * torch.exp(cum)[..., None]
    return (y_intra.to(torch.float32) + y_state).to(y_intra.dtype), state


def chain_inputs(shape, seed, with_state0, xdt=torch.float32):
    """B6's outputs on ``make``'s draw (the chain's inputs) at a SWEEP shape,
    all leaves that require grad, and the gradients of y and the final state."""
    B, S, H, P, N, chunk = shape
    x, dt, a, Bm, Cm = to_torch(chunked(make(shape, seed=seed), chunk), torch.float32)
    y_intra, st_c, total = ssd_intra_plain(x.to(xdt), dt, a, Bm, Cm)
    r = np.random.default_rng(seed + 1)
    s0 = torch.from_numpy((r.standard_normal((B, H, P, N)) * 0.3).astype(np.float32)) if with_state0 else None
    leaves = [t.detach().clone().requires_grad_() for t in (y_intra, st_c, total, a, Cm)]
    if s0 is not None:
        leaves.append(s0.requires_grad_())
    gy = torch.from_numpy(r.standard_normal(tuple(y_intra.shape)).astype(np.float32)).to(xdt)
    gs = torch.from_numpy(r.standard_normal((B, H, P, N)).astype(np.float32))
    return leaves, gy, gs


@pytest.mark.parametrize("with_state0", [False, True], ids=["zeros", "state0"])
@pytest.mark.parametrize("shape", SWEEP, ids=[f"{s[1]}x{s[3]}" for s in SWEEP])
def test_chain_plain_and_its_backward_match_todays_code(shape, with_state0):
    """The plain chain (CPU route of ``ssd_chain``) against the torch code
    ``ops.ssd`` ran before: y within 1e-5 (its ``cum`` is summed in f64, the
    old one in f32), the final state bit for bit (the same ops); its
    written-out backward against autograd of the old code within 1e-5 and
    1e-5·max|grad| for every input (f32 sums in another order)."""
    leaves, gy, gs = chain_inputs(shape, shape[1] + shape[3], with_state0)
    cuda_lib.reset_counts()
    y, s = SC.ssd_chain(*leaves)
    assert cuda_lib.counts() == {"plain:ssd_chain": 1}
    yr, sr = chain_reference(*leaves)
    close(y, yr, 1e-5)
    assert torch.equal(s, sr)
    got = torch.autograd.grad((y * gy).sum() + (s * gs).sum(), leaves)
    assert cuda_lib.counts() == {"plain:ssd_chain": 1, "plain:ssd_chain_bwd": 1}
    want = torch.autograd.grad((yr * gy).sum() + (sr * gs).sum(), leaves)
    names = ["y_intra", "st", "total", "a", "C", "state0"]
    for name, g, w in zip(names, got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()),
                                   msg=lambda m, name=name: f"{name}: {m}")
    assert got[0] is not None and torch.equal(got[0], gy)  # d y_intra is dy itself


@pytest.mark.parametrize("with_state0", [False, True], ids=["zeros", "state0"])
@pytest.mark.parametrize("shape", SWEEP, ids=[f"{s[1]}x{s[3]}" for s in SWEEP])
def test_ssd_gradients_match_ssd_chunked(shape, with_state0):
    """``ops.ssd`` (B6 and the chain, each with its written-out backward on
    the CPU) against autograd of the model's reference ``ssd_chunked``: y
    and the final state within 1e-5 and 1e-4, the gradients of x, dt, A, B,
    C and state0 within 1e-5·max|grad| (f32 sums in another order)."""
    B, S, H, P, N, chunk = shape
    arrs = make(shape, seed=S + P + 1)
    r = np.random.default_rng(S)
    s0 = (r.standard_normal((B, H, P, N)) * 0.3).astype(np.float32) if with_state0 else None
    gy = torch.from_numpy(r.standard_normal((B, S, H, P)).astype(np.float32))
    gs = torch.from_numpy(r.standard_normal((B, H, P, N)).astype(np.float32))

    def run(fn):
        ins = [torch.from_numpy(a).requires_grad_() for a in arrs]
        if s0 is not None:
            ins.append(torch.from_numpy(s0).requires_grad_())
        y, s = fn(*ins[:5], chunk, *ins[5:])
        return y, s, torch.autograd.grad((y * gy).sum() + (s * gs).sum(), ins)

    y, s, got = run(ops.ssd)
    yr, sr, want = run(ssd_chunked)
    close(y, yr, 1e-5)
    close(s, sr, 1e-4)
    for name, g, w in zip(["x", "dt", "A", "B", "C", "state0"], got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()),
                                   msg=lambda m, name=name: f"{name}: {m}")


def test_chain_routes_by_grad_mode():
    """Under no_grad the chain is one forward call that keeps nothing; under
    grad it goes through ``SsdChain``: one forward (which keeps the incoming
    states of chunks 1 ... nc - 1) and one backward. An unused final state
    gives the backward no gradient to read, and no state0 no gradient of it."""
    leaves, gy, _gs = chain_inputs(SWEEP[0], 5, False)
    cuda_lib.reset_counts()
    with torch.no_grad():
        y, s = SC.ssd_chain(*leaves)
    assert y.grad_fn is None and cuda_lib.counts() == {"plain:ssd_chain": 1}
    y, s = SC.ssd_chain(*leaves)
    assert y.grad_fn is not None
    (y * gy).sum().backward()
    assert cuda_lib.counts() == {"plain:ssd_chain": 2, "plain:ssd_chain_bwd": 1}
    assert all(t.grad is not None for t in leaves)
    nc = leaves[0].shape[1]
    _y, _s, mid = SC.ssd_chain_plain(*(t.detach() for t in leaves), keep=True)
    assert mid.shape[1] == nc - 1


@pytest.mark.parametrize("with_state0", [False, True], ids=["zeros", "state0"])
def test_chain_bwd_by_head_chunks_matches_one_pass(with_state0):
    """A head wider than one backward launch holds (P > 64) runs as head-dim
    chunks: with the plain backward as the chunk's function, P 40 in chunks
    of 16, 16 and 8 gives one pass's dst and dstate0 side by side and
    dtotal, da and dC as sums, within 1e-5 and 1e-5·max|grad|."""
    shape = (2, 48, 3, 40, 24, 16)
    leaves, gy, gs = chain_inputs(shape, 9, with_state0)
    y_intra, st_c, total, a, Cm = (t.detach() for t in leaves[:5])
    s0 = leaves[5].detach() if with_state0 else None
    _y, _s, mid = SC.ssd_chain_plain(y_intra, st_c, total, a, Cm, s0, keep=True)
    args = (total, a, Cm, mid, s0, gy, gs)
    widths = []

    def plain(*chunk):
        widths.append(chunk[5].shape[-1])
        return SC.ssd_chain_bwd_plain(*chunk)

    got = SC.bwd_by_head_chunks(plain, 16, *args)
    assert widths == [16, 16, 8]
    want = SC.ssd_chain_bwd_plain(*args)
    for name, u, v in zip(("dst", "dtotal", "da", "dC", "dstate0"), got, want):
        if name == "dstate0" and not with_state0:
            assert u is None and v is None
            continue
        assert u.shape == v.shape, name
        torch.testing.assert_close(u, v, rtol=1e-5, atol=1e-5 * float(v.abs().max()),
                                   msg=lambda m, name=name: f"{name}: {m}")


def test_chain_wrapper_checks_shapes():
    leaves, _gy, _gs = chain_inputs(SWEEP[0], 3, True)
    y_intra, st_c, total, a, Cm, s0 = (t.detach() for t in leaves)
    with pytest.raises(ValueError, match="st must be"):
        SC.ssd_chain(y_intra, st_c[..., :4], total, a, Cm, s0)
    with pytest.raises(ValueError, match="state0 must be"):
        SC.ssd_chain(y_intra, st_c, total, a, Cm, s0[:1])
    with pytest.raises(ValueError, match="y_intra must be"):
        SC.ssd_chain(y_intra[0], st_c, total, a, Cm, s0)
