// Mamba2 SSD intra-chunk block (state-space duality).
//
// Replaces the TPU kernel `_ssd_intra_kernel` / `ssd_intra_pallas` in
// src/repro/kernels/ssd_chunk.py. Per (batch b, chunk c, head h), with
// a = dt * A (log-decay, <= 0) over the chunk's Q steps:
//   cum   = cumsum(a)                         total = cum[Q-1]
//   M     = (C · Bᵀ) ∘ L,  L[i,j] = exp(cum_i - cum_j) if i >= j else 0
//   y     = M · (x · dt)                                  (Q, P), x's type
//   st    = Σ_q B_q ⊗ x_q · dt_q · exp(total - cum_q)     (P, N), f32
// The inter-chunk recurrence runs outside, in kernels/ops.py `ssd`.
//
// Two routes, picked by the wrapper (kernels/ssd_chunk.py) from Q alone.
//
// Prefill (Q >= 2), `ssd_intra_prefill_kernel`: one CTA of 8 warps per
// (b, c, h), two CTAs an SM (~106 KB of shared memory each). All three
// products run on the tensor cores as mma.sync.m16n8k8 TF32 in the
// split-precision "3xTF32" scheme: every f32 operand v is split into
// hi = tf32(v) (cvt.rna) and lo = v - hi, which the MMA truncates to TF32,
// and a product sums lo·hi + hi·lo, then hi·hi. One TF32 pass misses 1e-5
// on y; the split holds it (tests/test_torch_ssd.py shows why). bf16 x is
// exact in TF32, so its products need no lo·hi term: with bf16 x the kernel
// keeps x itself in shared memory and moves dt onto M (y = (M ∘ dt_j) · x)
// and dt·g onto B (st = xᵀ · (B ∘ dt·g)), two MMAs a product instead of
// three. The tensor cores' f32 accumulation truncates, and chained
// over a whole K of 128 (48 MMAs) its bias reached 2e-5 on y, so C·Bᵀ and
// M·X sum each k-step in a fresh accumulator that a rounded f32 add folds
// in (`mma3`); the state, held to 1e-4, chains in one. Order of work:
//   1. cum (f64 scan), dt, g = exp(total - cum) (dt·g with bf16 x) into
//      shared memory, while the first N-slice lands;
//   2. one pass over 16-wide N-slices (cp.async, the next slice landing
//      during this one): C·Bᵀ accumulates in registers, C's slices pass
//      through a two-stage ring and B's land in a 128-column block that
//      stays in shared memory. B and C are read from device memory once a
//      launch (P <= 64; each further 64-wide head-dim tile of x streams them
//      again);
//   3. x·dt (x with bf16 x) for a 64-wide head-dim tile over the ring, rows
//      permuted within each group of 8 so that the C·Bᵀ accumulator layout
//      is the A operand of M·X without a shuffle (as FlashAttention-2 keeps
//      P);
//   4. the block's state st = (x·dt·g)ᵀ · B as a 64 x 128 product over the
//      whole chunk, a 32 x 32 tile a warp (a state slice at a time would give
//      each warp a 16 x 8 tile, and then loads and splits, not the tensor
//      cores, set the pace);
//   5. M = (C·Bᵀ) ∘ L into shared memory over B's block, then y = M · (x·dt).
// C·Bᵀ: warps w and w + 4 share the 16-row strips w and 7 - w, whose causal
// work is equal (18 tiles of 16 x 8, 9 a warp); tiles wholly above the
// diagonal are never computed, and the tile loops hold no branch (a chunk
// shorter than 128 computes tiles past Q on zeros, which the mask drops).
// `cum` is summed and differenced in f64 and only cum_i - cum_j rounded to
// f32: a chunk's log-decay reaches hundreds at Q = 128, and differences of
// f32 sums that large lose ~1e-4 of L. The causal mask is a select, never a
// product: for j > i, cum_i - cum_j >= 0 and exp may overflow to +inf. No
// atomics: two launches give the same bits.
//
// Decode (Q = 1), `ssd_intra_decode_kernel`: the function reduces to
// m = C·B, y = m·dt·x, st = (x·dt) ⊗ B, total = a. One CTA per (b, c, h,
// 16-row head-dim tile) reduces the dot in each warp and writes its state rows
// with 16-byte stores; nothing else is staged.
//
// Bound on the H100 at the serving prefill shape (B 8, nc 4, Q 128, H 32,
// P 64, N 128, bf16 x): ~202 MB moved (B and C arrive broadcast over the
// heads in f32), 0.060 ms at 3.35 TB/s; the causal work Q(Q+1)N + Q(Q+1)P
// + 2QNP = 5.3 MFLOP a (b, c, h) at three TF32 products per f32 product
// (495 / 3 TFLOP/s) takes 0.033 ms. So it is bound by bytes; but mma.sync
// does not reach the dense TF32 rate, and the kernel is held by the loads,
// splits and adds around its MMAs, which overlap its memory traffic only in
// part (PERF.md).
// Decode is bound by the 8.4 MB state write. chip_smoke.py computes both
// bounds from the shapes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "ssd_mma.cuh"  // mma, cp_async16, cp_async4, cp_commit, cp_wait_all

namespace {

constexpr int NT = 256;       // prefill threads a CTA: 8 warps
constexpr int QM = 128;       // longest chunk a CTA holds
constexpr int PT = 64;        // head-dim tile of y and the state
constexpr int NB = 128;       // N-block: the columns of B a CTA holds at once
constexpr int NK = 16;        // depth of one staged N-slice
constexpr int SX = PT + 8;    // row stride (floats) of x·dt: conflict-free fragments
constexpr int SM = QM + 8;    // row stride (floats) of M: conflict-free 8-byte fragments
constexpr int TILES = 9;      // 16 x 8 tiles of C·Bᵀ a warp holds (half of strips p, 7 - p)
constexpr int MAX_DEV = 64;   // devices tracked for the shared-memory attribute

// Shared memory, time-shared by phase. While an N-block streams: B's block
// (Bf) and a two-stage ring of C's slices (Cr). For the state of the block:
// Bf and x·dt (X, over the ring). For y: M (over Bf) and X.
constexpr int BF_FLOATS = QM * NB;                       // 64 KB
constexpr int M_FLOATS = QM * SM;                        // 68 KB: over Bf and a gap
constexpr int CR_FLOATS = 2 * QM * NK;                   // 16 KB, from the end of Bf
constexpr int X_FLOATS = QM * SX;                        // 36 KB, from the end of M
constexpr int UNION_FLOATS = M_FLOATS + X_FLOATS;

struct Smem {
  alignas(16) double cum[QM];  // f64: L takes differences of sums that reach hundreds
  double wsum[QM / 32];
  float g[QM];                 // exp(total - cum_q)
  float dt[QM];
  alignas(16) float u[UNION_FLOATS];
  __device__ float* Bf() { return u; }                     // B[q][n0 + n] at bsw(q, n)
  __device__ float* M() { return u; }                      // M[i][j] at i * SM + j
  __device__ float* Cr(int st) { return u + BF_FLOATS + st * QM * NK; }  // C[q][n0 + k] at csw(q, k)
  __device__ float* X() { return u + M_FLOATS; }           // x_q · dt_q (bf16: x_q), row q at perm8(q)
};
static_assert(BF_FLOATS + CR_FLOATS <= UNION_FLOATS, "the C ring fits beside B's block");

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Position of chunk row q in the X tile: within each group of 8, row 2t goes
// to t and row 2t + 1 to t + 4, the k order of an accumulator used as an A
// fragment (its columns 2t, 2t + 1 become k = t, t + 4).
__device__ __forceinline__ int perm8(int q) { return (q & ~7) | ((q & 7) >> 1) | ((q & 1) << 2); }

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// hi = tf32(v) rounded to nearest; lo = v - hi (exact in f32) goes to the
// MMA as it is: a TF32 operand's low 13 bits are ignored, so the tensor core
// truncates lo to TF32 itself, which costs one instruction less than cvt and
// errs by at most 2^-21 |v|.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi)));
}

// d += a · b in 3xTF32: the small cross terms first, then hi·hi, into a
// fresh accumulator that is then added to d in f32 (round to nearest). The
// tensor cores' own f32 accumulation truncates: chained over a whole K of
// 128 (48 MMAs) its bias reached 2e-5 on y; one k-step of three MMAs a sum
// keeps it to the size of an f32 add.
__device__ __forceinline__ void mma3(float* d, const uint32_t* ah, const uint32_t* al,
                                     const uint32_t* bh, const uint32_t* bl) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, al, bh);
  mma(t, ah, bl);
  mma(t, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = __fadd_rn(d[e], t[e]);
}

// d += a · b where b is exact in TF32 (a bf16 value): b's low part is zero,
// so two products keep the split's accuracy.
__device__ __forceinline__ void mma2(float* d, const uint32_t* ah, const uint32_t* al,
                                     const uint32_t* b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, al, b);
  mma(t, ah, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = __fadd_rn(d[e], t[e]);
}

__device__ __forceinline__ void split4(const float* v, uint32_t* hi, uint32_t* lo) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(v[e], hi[e], lo[e]);
}

__device__ __forceinline__ void split2(float v0, float v1, uint32_t* hi, uint32_t* lo) {
  split(v0, hi[0], lo[0]);
  split(v1, hi[1], lo[1]);
}

// Swizzled positions: C's slices as 16-float rows, B's block as 128-float
// rows, each XOR-ing 4-float chunk indices by row so that the fragment
// patterns below, (row g, column t) and (row 2t, column g), are free of bank
// conflicts.
__device__ __forceinline__ int csw(int q, int k) { return q * NK + (k ^ (((q >> 1) & 3) << 2)); }
__device__ __forceinline__ int bsw(int q, int n) { return q * NB + (n ^ ((q & 7) << 2)); }

// Issue the copies of the N-slice at column n0 + k0 of C (into ring stage
// `st`) and of B (into its block at column k0) as one group. All QM rows
// land: rows past Q and columns past N as zeros. `vec`: 16-byte copies (N a
// multiple of 4 and B, C 16-byte aligned), else 4-byte.
__device__ __forceinline__ void stage_slice(Smem& s, int st, const float* Cg, const float* Bg,
                                            int n0, int k0, int Q, int N, long long rs, bool vec,
                                            int tid) {
  float* cr = s.Cr(st);
  float* bf = s.Bf();
  if (vec) {
    for (int e = tid; e < QM * (NK / 4); e += NT) {
      const int q = e / (NK / 4), k = (e % (NK / 4)) * 4, n = n0 + k0 + k;
      const bool ok = q < Q && n < N;
      const long long off = ok ? q * rs + n : 0;
      cp_async16(&cr[csw(q, k)], Cg + off, ok ? 16 : 0);
      cp_async16(&bf[bsw(q, k0 + k)], Bg + off, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < QM * NK; e += NT) {
      const int q = e / NK, k = e % NK, n = n0 + k0 + k;
      const bool ok = q < Q && n < N;
      const long long off = ok ? q * rs + n : 0;
      cp_async4(&cr[csw(q, k)], Cg + off, ok ? 4 : 0);
      cp_async4(&bf[bsw(q, k0 + k)], Bg + off, ok ? 4 : 0);
    }
  }
  cp_commit();
}

// Call f with a warp's count of strip-A tiles (0, 2, 4, 6 or 8) as a
// compile-time constant, so that the tile loops hold no select.
template <class F>
__device__ __forceinline__ void with_na(int na, F&& f) {
  switch (na) {
    case 0: f(std::integral_constant<int, 0>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 6: f(std::integral_constant<int, 6>{}); break;
    default: f(std::integral_constant<int, 8>{}); break;
  }
}

// C·Bᵀ over one slice (ring stage `cr`, B's block at column k0) for a
// warp's 9 tiles, operands split as they load. Tiles t < NA belong to strip
// A (column tile t), the rest to strip B (column tile jb + t - NA); NA is a
// template parameter so that the tile loop holds no select and no branch.
template <int NA>
__device__ __forceinline__ void cb_slice(float (&cb)[TILES][4], const float* cr, const float* bf,
                                         int k0, int iA, int iB, int jb, int gq, int tq) {
  const int cc = ((gq >> 1) & 3) << 2;  // csw's XOR for rows 8m + g
  const int cbx = gq << 2;              // bsw's XOR for rows 8m + g
#pragma unroll 1
  for (int kk = 0; kk < NK; kk += 8) {
    uint32_t aAh[4], aAl[4], aBh[4], aBl[4];
    const int c0 = (kk + tq) ^ cc, c1 = (kk + tq + 4) ^ cc;
    if (NA > 0) {
      const float v[4] = {cr[iA * NK + c0], cr[(iA + 8) * NK + c0], cr[iA * NK + c1],
                          cr[(iA + 8) * NK + c1]};
      split4(v, aAh, aAl);
    }
    {
      const float v[4] = {cr[iB * NK + c0], cr[(iB + 8) * NK + c0], cr[iB * NK + c1],
                          cr[(iB + 8) * NK + c1]};
      split4(v, aBh, aBl);
    }
    const float* b0 = bf + gq * NB + ((k0 + kk + tq) ^ cbx);
    const int d4 = ((k0 + kk + tq + 4) ^ cbx) - ((k0 + kk + tq) ^ cbx);
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      const float* bt = b0 + 8 * NB * (t < NA ? t : jb + t - NA);
      uint32_t bh[2], bl[2];
      split2(bt[0], bt[d4], bh, bl);
      if (t < NA) mma3(cb[t], aAh, aAl, bh, bl);
      else mma3(cb[t], aBh, aBl, bh, bl);
    }
  }
}

// M = (C·Bᵀ) ∘ L of a warp's 9 tiles into shared memory: the causal mask is
// a select, never a product, since exp(cum_i - cum_j) may be +inf where j > i.
template <int NA, bool XE>
__device__ __forceinline__ void dump_m(const float (&cb)[TILES][4], Smem& s, int iA, int iB,
                                       int jb, int Q, int tq) {
  const double cA0 = s.cum[iA], cA1 = s.cum[iA + 8], cB0 = s.cum[iB], cB1 = s.cum[iB + 8];
  float* m = s.M();
#pragma unroll
  for (int t = 0; t < TILES; ++t) {
    const bool inA = t < NA;
    const int i = inA ? iA : iB, j = 8 * (inA ? t : jb + t - NA) + 2 * tq;
    const double c0 = inA ? cA0 : cB0, c1 = inA ? cA1 : cB1;
    const double2 cj = *reinterpret_cast<const double2*>(&s.cum[j]);
    float v[4] = {cb[t][0], cb[t][1], cb[t][2], cb[t][3]};
    if (XE) {  // y = (M ∘ dt_j) · x: x stays exact in TF32
      const float2 d = *reinterpret_cast<const float2*>(&s.dt[j]);
      v[0] *= d.x; v[1] *= d.y; v[2] *= d.x; v[3] *= d.y;
    }
    const float m0 = (i < Q && j <= i) ? v[0] * expf((float)(c0 - cj.x)) : 0.f;
    const float m1 = (i < Q && j + 1 <= i) ? v[1] * expf((float)(c0 - cj.y)) : 0.f;
    const float m2 = (i + 8 < Q && j <= i + 8) ? v[2] * expf((float)(c1 - cj.x)) : 0.f;
    const float m3 = (i + 8 < Q && j + 1 <= i + 8) ? v[3] * expf((float)(c1 - cj.y)) : 0.f;
    store2(&m[i * SM + j], m0, m1);
    store2(&m[(i + 8) * SM + j], m2, m3);
  }
}

// The A fragment of M at column tile jt for rows i, i + 8, split: the
// accumulator layout (columns 2t, 2t + 1) read over k = t, t + 4, which the
// permuted rows of X match.
__device__ __forceinline__ void frag_m(Smem& s, int i, int jt, int tq, uint32_t* hi,
                                       uint32_t* lo) {
  const float* m = s.M();
  const float2 ra = *reinterpret_cast<const float2*>(&m[i * SM + 8 * jt + 2 * tq]);
  const float2 rb = *reinterpret_cast<const float2*>(&m[(i + 8) * SM + 8 * jt + 2 * tq]);
  const float v[4] = {ra.x, rb.x, ra.y, rb.y};
  split4(v, hi, lo);
}

// One k-step of y for one strip and 32 columns: with XE, X holds x itself
// (exact in TF32) and M carries dt.
template <bool XE>
__device__ __forceinline__ void y_step(float (&ya)[4][4], const uint32_t* ah, const uint32_t* al,
                                       const float* xr) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    if (XE) {
      const uint32_t b[2] = {__float_as_uint(xr[8 * nt]), __float_as_uint(xr[4 * SX + 8 * nt])};
      mma2(ya[nt], ah, al, b);
    } else {
      uint32_t bh[2], bl[2];
      split2(xr[8 * nt], xr[4 * SX + 8 * nt], bh, bl);
      mma3(ya[nt], ah, al, bh, bl);
    }
  }
}

// y rows i, i + 8 of one strip over column tiles [j0, j1), 32 columns at yc.
template <bool XE>
__device__ __forceinline__ void y_strip(float (&ya)[4][4], Smem& s, int i, int j0, int j1,
                                        int yc, int gq, int tq) {
#pragma unroll 2
  for (int jt = j0; jt < j1; ++jt) {
    uint32_t ah[4], al[4];
    frag_m(s, i, jt, tq, ah, al);
    y_step<XE>(ya, ah, al, s.X() + (8 * jt + tq) * SX + yc + gq);
  }
}

// The state of one N-block and head-dim tile: st[p][n] = Σ_q X[q][p] g[q]
// B[q][n] over the whole chunk, a 32 x 32 tile a warp (rows pw.., columns
// nw.. of the block). Its tolerance is 1e-4, so the 3xTF32 products chain
// in one accumulator: the tensor cores' truncation over 48 MMAs, which
// reached 2e-5 on y, stays far inside it.
template <bool XE>
__device__ __forceinline__ void state_block(Smem& s, float* __restrict__ sr, int p0, int nb0,
                                            int pw, int nw, int P, int N, int gq, int tq) {
  float acc[2][4][4];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mb][nt][e] = 0.f;
  const float* X = s.X();
  const float* bf = s.Bf();
  const int x0 = (8 * tq) & 31, x1 = (8 * tq + 4) & 31;  // bsw's XOR for rows 8m + 2t, + 1
#pragma unroll 1
  for (int k0 = 0; k0 < QM; k0 += 8) {
    // A: rows p of X (·g) at k = t, t + 4 (X's rows k0 + t, k0 + t + 4 hold
    // q = k0 + 2t, k0 + 2t + 1). With XE, A is x itself, exact in TF32, and
    // its weight dt·g goes onto B's rows.
    const float g0 = s.g[k0 + 2 * tq], g1 = s.g[k0 + 2 * tq + 1];
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      const float* xr = X + (k0 + tq) * SX + pw + 16 * mb + gq;
      if (XE) {
        ah[mb][0] = __float_as_uint(xr[0]);
        ah[mb][1] = __float_as_uint(xr[8]);
        ah[mb][2] = __float_as_uint(xr[4 * SX]);
        ah[mb][3] = __float_as_uint(xr[4 * SX + 8]);
      } else {
        const float va[4] = {xr[0] * g0, xr[8] * g0, xr[4 * SX] * g1, xr[4 * SX + 8] * g1};
        split4(va, ah[mb], al[mb]);
      }
    }
    const float* b0 = bf + (k0 + 2 * tq) * NB;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = nw + 8 * nt + gq;
      uint32_t bh[2], bl[2];
      if (XE) split2(b0[n ^ x0] * g0, b0[NB + (n ^ x1)] * g1, bh, bl);
      else split2(b0[n ^ x0], b0[NB + (n ^ x1)], bh, bl);
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        if (XE) {
          mma(acc[mb][nt], ah[mb], bl);
        } else {
          mma(acc[mb][nt], al[mb], bh);
          mma(acc[mb][nt], ah[mb], bl);
        }
        mma(acc[mb][nt], ah[mb], bh);
      }
    }
  }
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = nb0 + nw + 8 * nt + 2 * tq;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int p = p0 + pw + 16 * mb + gq + 8 * rr;
        if (p >= P) continue;
        float* dst = sr + (long long)p * N + n;
        const float v0 = acc[mb][nt][2 * rr], v1 = acc[mb][nt][2 * rr + 1];
        if ((N & 1) == 0 && n + 1 < N) {
          store2(dst, v0, v1);
        } else {
          if (n < N) dst[0] = v0;
          if (n + 1 < N) dst[1] = v1;
        }
      }
    }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) ssd_intra_prefill_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const float* __restrict__ Bm, const float* __restrict__ Cm, T* __restrict__ y,
    float* __restrict__ st, float* __restrict__ total, int Q, int H, int P, int N) {
  // bf16 x is exact in TF32: its products need no split (mma2), and dt (and
  // g) move onto the other operand
  constexpr bool XE = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row group and thread in group
  const int h = blockIdx.x % H;
  const long long bc = blockIdx.x / H;  // b * nc + c
  const long long row0 = bc * Q;        // row (b, c, q = 0) of the (.., Q, H, ..) tensors
  const long long rsN = (long long)H * N;  // stride of q in B and C
  const float* Cg = Cm + (row0 * H + h) * (long long)N;
  const float* Bg = Bm + (row0 * H + h) * (long long)N;
  float* sr = st + (bc * H + h) * (long long)P * N;
  const bool vec = (N & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(Bm) | reinterpret_cast<uintptr_t>(Cm)) & 15) == 0;
  const bool xvec = (P & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & (4 * sizeof(T) - 1)) == 0;
  // Warp roles: strip pair `pair` (strips pair and 7 - pair: 18 tiles of
  // C·Bᵀ of equal causal work), `half` of its tiles and of y's columns; in
  // the state, a 32 x 32 tile (rows 32·(warp & 1).., columns 32·(warp >> 1)..).
  const int pair = warp & 3, half = warp >> 2;
  const int sA = pair, sB = 7 - pair, nA = 2 * (pair + 1);
  const int iA = 16 * sA + gq, iB = 16 * sB + gq;
  const int jb = half ? TILES - nA : 0;  // strip B's first column tile in this warp's tiles
  const T* xg = x + (row0 * H + h) * (long long)P;

  stage_slice(s, 0, Cg, Bg, 0, 0, Q, N, rsN, vec, tid);  // overlaps the scan

  // ---- cum = cumsum(a) in f64: a shuffle scan per warp, then the warps' sums ----
  if (tid < QM) {
    double c = tid < Q ? (double)a[(row0 + tid) * H + h] : 0.0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, c, o);
      if (lane >= o) c += u;
    }
    s.cum[tid] = c;
    if (lane == 31) s.wsum[warp] = c;
    s.dt[tid] = tid < Q ? dt[(row0 + tid) * H + h] : 0.f;
  }
  __syncthreads();
  if (tid < QM) {
    double c = s.cum[tid];
    for (int w = 0; w < warp; ++w) c += s.wsum[w];
    s.cum[tid] = c;
  }
  __syncthreads();
  const double tot = s.cum[Q - 1];
  if (tid < QM)
    s.g[tid] = tid < Q ? (XE ? s.dt[tid] : 1.f) * expf((float)(tot - s.cum[tid])) : 0.f;
  if (tid == 0) total[bc * H + h] = (float)tot;

  for (int p0 = 0; p0 < P; p0 += PT) {
    float cb[TILES][4];
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) cb[t][e] = 0.f;
    for (int nb0 = 0; nb0 < N; nb0 += NB) {
      // ---- one pass over the block's N-slices: C·Bᵀ into registers, B's
      // block into shared memory ----
      if (p0 > 0 || nb0 > 0) {
        __syncthreads();  // the previous block's state (or y) is done with Bf, X and M
        stage_slice(s, 0, Cg, Bg, nb0, 0, Q, N, rsN, vec, tid);
      }
      const int nsl = (min(NB, N - nb0) + NK - 1) / NK;
      for (int sl = 0; sl < nsl; ++sl) {
        cp_wait_all();
        __syncthreads();  // slice sl landed; ring stage (sl + 1) & 1 is free
        if (sl + 1 < nsl)
          stage_slice(s, (sl + 1) & 1, Cg, Bg, nb0, (sl + 1) * NK, Q, N, rsN, vec, tid);
        const float* cr = s.Cr(sl & 1);
        with_na(half ? 0 : nA, [&](auto na) {
          cb_slice<decltype(na)::value>(cb, cr, s.Bf(), sl * NK, iA, iB, jb, gq, tq);
        });
      }
      __syncthreads();  // the ring is consumed: X goes over it

      // ---- X = x · dt (bf16: x) for head-dim tile p0, rows permuted; zeros past Q ----
      float* X = s.X();
      if (xvec) {
#pragma unroll 4
        for (int e = tid; e < QM * (PT / 4); e += NT) {
          const int q = e / (PT / 4), p = (e % (PT / 4)) * 4;
          float v[4] = {0.f, 0.f, 0.f, 0.f};
          if (q < Q && p0 + p < P) load4(xg + (long long)q * H * P + p0 + p, v);
          const float d = XE ? 1.f : s.dt[q];
          *reinterpret_cast<float4*>(&X[perm8(q) * SX + p]) =
              make_float4(v[0] * d, v[1] * d, v[2] * d, v[3] * d);
        }
      } else {
        for (int e = tid; e < QM * PT; e += NT) {
          const int q = e / PT, p = e % PT;
          const bool ok = q < Q && p0 + p < P;
          X[perm8(q) * SX + p] = ok ? load(xg + (long long)q * H * P + p0 + p) * (XE ? 1.f : s.dt[q]) : 0.f;
        }
      }
      __syncthreads();

      // ---- the block's state: a 32 x 32 tile a warp ----
      {
        const int pw = 32 * (warp & 1), nw = 32 * (warp >> 1);
        if (p0 + pw < P && nb0 + nw < N) state_block<XE>(s, sr, p0, nb0, pw, nw, P, N, gq, tq);
      }
    }

    // ---- M = (C·Bᵀ) ∘ L to shared memory, over B's block ----
    __syncthreads();  // every warp is done with B's block
    with_na(half ? 0 : nA, [&](auto na) { dump_m<decltype(na)::value, XE>(cb, s, iA, iB, jb, Q, tq); });
    __syncthreads();  // M is written

    // ---- y = M · X for this warp's 32 columns: strips A and B together over
    // their common causal k-steps (one X fragment feeds both), then alone ----
    const int yc = 32 * half;
    if (p0 + yc < P) {
      const int kq = (Q + 7) / 8;
      const int nja = 16 * sA < Q ? min(2 * (sA + 1), kq) : 0;
      const int njb = 16 * sB < Q ? min(2 * (sB + 1), kq) : 0;
      const int njab = min(nja, njb);
      float yA[4][4], yB[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) yA[nt][e] = yB[nt][e] = 0.f;
#pragma unroll 1
      for (int jt = 0; jt < njab; ++jt) {
        uint32_t ahA[4], alA[4], ahB[4], alB[4];
        frag_m(s, iA, jt, tq, ahA, alA);
        frag_m(s, iB, jt, tq, ahB, alB);
        const float* xr = s.X() + (8 * jt + tq) * SX + yc + gq;
        y_step<XE>(yA, ahA, alA, xr);
        y_step<XE>(yB, ahB, alB, xr);
      }
      y_strip<XE>(yB, s, iB, njab, njb, yc, gq, tq);
      y_strip<XE>(yA, s, iA, njab, nja, yc, gq, tq);  // strip B lies past Q
#pragma unroll
      for (int sb = 0; sb < 2; ++sb) {
        const int ib = sb ? iB : iA;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int p = p0 + yc + 8 * nt + 2 * tq;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int i = ib + 8 * rr;
            if (i >= Q) continue;
            const float v0 = sb ? yB[nt][2 * rr] : yA[nt][2 * rr];
            const float v1 = sb ? yB[nt][2 * rr + 1] : yA[nt][2 * rr + 1];
            T* dst = y + ((row0 + i) * H + h) * (long long)P + p;
            if ((P & 1) == 0 && p + 1 < P) {
              store2(dst, v0, v1);
            } else {
              if (p < P) store(dst, v0);
              if (p + 1 < P) store(dst + 1, v1);
            }
          }
        }
      }
    }
  }
}

constexpr int DNT = 128;  // decode threads a CTA
constexpr int DPT = 16;   // head-dim rows of the state a decode CTA writes

template <typename T>
__global__ void __launch_bounds__(DNT) ssd_intra_decode_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const float* __restrict__ Bm, const float* __restrict__ Cm, T* __restrict__ y,
    float* __restrict__ st, float* __restrict__ total, int P, int N, int ptiles) {
  __shared__ float xd[DPT];
  const int tid = threadIdx.x, lane = tid & 31;
  const long long r = blockIdx.x / ptiles;  // (b, c, h): Q = 1, so one row of every input
  const int p0 = (blockIdx.x % ptiles) * DPT;
  const int rows = min(DPT, P - p0);
  const float* Bv = Bm + r * N;
  const float* Cv = Cm + r * N;
  const float dtv = dt[r];
  if (tid < rows) xd[tid] = load(x + r * P + p0 + tid) * dtv;
  // m = C · B, reduced by every warp in the same order
  float m = 0.f;
  for (int n = lane; n < N; n += 32) m = fmaf(Cv[n], Bv[n], m);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m += __shfl_xor_sync(0xffffffffu, m, o);
  if (p0 == 0 && tid == 0) total[r] = a[r];
  __syncthreads();
  if (tid < rows) store(y + r * P + p0 + tid, m * xd[tid]);
  float* sr = st + (r * P + p0) * (long long)N;
  if ((N & 3) == 0 && (reinterpret_cast<uintptr_t>(Bm) & 15) == 0) {
    const int n4 = N / 4;
    for (int e = tid; e < rows * n4; e += DNT) {
      const int q = e / n4, c = e % n4;
      const float4 b = __ldg(reinterpret_cast<const float4*>(Bv) + c);
      const float v = xd[q];
      reinterpret_cast<float4*>(sr)[e] = make_float4(v * b.x, v * b.y, v * b.z, v * b.w);
    }
  } else {
    for (int e = tid; e < rows * N; e += DNT) sr[e] = xd[e / N] * Bv[e % N];
  }
}

// Set the prefill kernel's shared-memory attributes once for each device.
template <typename T>
int prepare_prefill() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEV) return (int)cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << dev;
  if (done.load(std::memory_order_acquire) & bit) return 0;
  e = cudaFuncSetAttribute(ssd_intra_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sizeof(Smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_intra_prefill_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  done.fetch_or(bit, std::memory_order_acq_rel);
  return 0;
}

template <typename T>
int launch_prefill(const void* x, const void* dt, const void* a, const void* B, const void* C,
                   void* y, void* st, void* total, long long ctas, int Q, int H, int P, int N,
                   cudaStream_t stream) {
  const int rc = prepare_prefill<T>();
  if (rc != 0) return rc;
  ssd_intra_prefill_kernel<T><<<(unsigned)ctas, NT, sizeof(Smem), stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const float*)B, (const float*)C, (T*)y,
      (float*)st, (float*)total, Q, H, P, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_decode(const void* x, const void* dt, const void* a, const void* B, const void* C,
                  void* y, void* st, void* total, long long rows, int P, int N,
                  cudaStream_t stream) {
  const int ptiles = (P + DPT - 1) / DPT;
  const long long ctas = rows * ptiles;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssd_intra_decode_kernel<T><<<(unsigned)ctas, DNT, 0, stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const float*)B, (const float*)C, (T*)y,
      (float*)st, (float*)total, P, N, ptiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (Bb, nc, Q, H, P) f32, or bf16 when x_bf16; dt, a: (Bb, nc, Q, H) f32;
// B, C: (Bb, nc, Q, H, N) f32; st: (Bb, nc, H, P, N) f32; total: (Bb, nc, H) f32.
// All contiguous. The prefill route takes 2 <= Q <= 128. Returns a
// cudaError_t (0 on a clean launch).
extern "C" int ssd_prefill_launch(const void* x, int x_bf16, const void* dt, const void* a,
                                  const void* B, const void* C, void* y, void* st, void* total,
                                  int Bb, int nc, int Q, int H, int P, int N, void* stream) {
  if (Q < 2 || Q > QM || H < 1 || P < 1 || N < 1 || Bb < 0 || nc < 0)
    return (int)cudaErrorInvalidValue;
  const long long ctas = (long long)Bb * nc * H;
  if (ctas == 0) return 0;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (x_bf16)
    return launch_prefill<__nv_bfloat16>(x, dt, a, B, C, y, st, total, ctas, Q, H, P, N,
                                         (cudaStream_t)stream);
  return launch_prefill<float>(x, dt, a, B, C, y, st, total, ctas, Q, H, P, N,
                               (cudaStream_t)stream);
}

// The same tensors with Q = 1.
extern "C" int ssd_decode_launch(const void* x, int x_bf16, const void* dt, const void* a,
                                 const void* B, const void* C, void* y, void* st, void* total,
                                 int Bb, int nc, int H, int P, int N, void* stream) {
  if (H < 1 || P < 1 || N < 1 || Bb < 0 || nc < 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)Bb * nc * H;
  if (rows == 0) return 0;
  if (x_bf16)
    return launch_decode<__nv_bfloat16>(x, dt, a, B, C, y, st, total, rows, P, N,
                                        (cudaStream_t)stream);
  return launch_decode<float>(x, dt, a, B, C, y, st, total, rows, P, N, (cudaStream_t)stream);
}

extern "C" const char* ssd_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
