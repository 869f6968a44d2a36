// Gradient of the Mamba2 SSD intra-chunk block (B6 backward).
//
// No TPU twin: the JAX package differentiates its plain `ssd_chunked`
// (src/repro/models/ssm.py) with jax.grad; this kernel computes the same
// function for the block that ssd_chunk.cu computes forward. Per (batch b,
// chunk c, head h), with a = dt·A, cum = cumsum(a) (f64), total = cum[Q-1],
// L[i,j] = exp(cum_i - cum_j)·[i >= j], S = C·Bᵀ, M = S∘L,
// g_q = exp(total - cum_q), w_q = dt_q·g_q, and the incoming gradients
// dy (Q, P), dst (P, N) and dtotal:
//   dM   = (dy·xᵀ)∘dt_j∘[i >= j]      dS = dM∘L          du = Mᵀ·dy
//   sB_q = dst·B_q                    dw_q = x_q·sB_q
//   dx   = du·dt + w·sB               ddt  = Σ_P du∘x + g·dw
//   dC   = dS·B                       dB   = dSᵀ·C + w·(x·dst)
//   G    = dM∘M = dS∘S   dcum_i = Σ_j G[i,j] - Σ_k G[k,i] - dw_i·w_i
//                        dcum_{Q-1} += dtotal + Σ_q dw_q·w_q
//   da   = reverse_cumsum(dcum)       (f64)
// The gradient of dt through a = dt·A, and of A, is left to autograd
// (kernels/ops.py `ssd` builds a outside the kernel).
//
// Bound on the H100 at the training shapes, bf16 x (chip_smoke.py's
// `ssd_bwd_bound` computes both from the shapes): x, dy, dt, a, B, C, dst,
// dtotal read once and dx, ddt, da, dB, dC written once, 0.106 ms at
// mamba2-370m's (B 8, nc 4, Q 128, H 32, P 64, N 128) and 0.152 ms at
// zamba2-2.7b's (H 80, N 64) at 3.35 TB/s; the causal work 3Q(Q+1)N +
// 2Q(Q+1)P + 4QNP operations a (b, c, h) at three TF32 products per f32
// product (495 / 3 TFLOP/s) 0.079 and 0.115 ms. So it is bound by bytes. The
// design, limit by limit:
//
// * Operations: all seven products run on the tensor cores as
//   mma.sync.m16n8k8 TF32, with as many passes as their operands need to
//   hold 1e-5 against f64 (tests/test_torch_ssd.py
//   `test_bwd_tf32_pass_plan_holds_the_tolerance` emulates the plan): f32 ·
//   f32 in 3xTF32 (S, sB, dC, dSᵀ·C; operands split hi = tf32(v), lo =
//   v - hi, summing lo·hi + hi·lo + hi·hi); an f32 operand against bf16 x or
//   dy (exact in TF32) in two (du = Mᵀ·dy, x·dst); dy·xᵀ with both bf16 in
//   one, dt moved onto its columns. With f32 x every product takes three.
//   Each k-step sums into a fresh accumulator that a rounded f32 add folds
//   in: the tensor cores' truncating accumulation chained over K put the
//   forward's y past 1e-5. hi is rounded on the integer pipe, not by cvt.
// * Causal work only: the five Q x Q products (S, dy·xᵀ, dS·B, dSᵀ·C, Mᵀ·dy)
//   skip every 16 x 8 tile wholly above the diagonal. S and dy·xᵀ run as the
//   forward's C·Bᵀ does: warps w and w + 4 share 16-row strips w and 7 - w
//   (18 tiles, 9 a warp); dS·B and dSᵀ·C give warp w strip w of both
//   8-column tiles of an N-slice (2(w + 1) and 16 - 2w k-steps: 18 a warp),
//   Mᵀ·dy strips w and 7 - w of 32 head-dim columns. The mask is a select,
//   never a product: for j > i, exp(cum_i - cum_j) may overflow to +inf.
// * Bytes: each operand comes from device memory once a CTA (P <= 64): x and
//   dy land in shared memory once and stay (bf16 stays bf16); B, C and dst
//   stream in 16-column N-slices through a two-stage cp.async ring, the
//   next slice landing while the current one serves the five products that
//   need it. dS (then M) lives in shared memory as its 72 causal 16 x 8
//   tiles (36 KB), read along rows and along columns. ~112 KB a CTA at
//   P = 64 and bf16 x: two CTAs an SM.
// * Issue and latency, which set the pace on the card (each product needs
//   loads, splits and adds around its MMAs, which wait on each other, at 16
//   warps an SM and 128 registers a thread): the MMAs of independent
//   chains interleave (`mmak`), one copy of the tile code serves every
//   warp, the staging copies run without divisions or branches, and one
//   A fragment of S and dy·xᵀ is live at a time.
// Order of work:
//   1. cum (f64 warp scan), dt, g, w, while x, dy and the first slice land;
//   2. dM = (dy·xᵀ)∘dt_j, 9 tiles a warp; dS = dM∘L into shared memory;
//   3. per N-slice: S += C·Bᵀ (registers, 9 tiles a warp), sB += B·dstᵀ
//      (registers, the first 64 head-dim columns), and the slice's columns
//      of dC = dS·B and dB = dSᵀ·C + w·(x·dst), written out;
//   4. G = dS∘S: row sums by quad shuffles, column sums by lane shuffles,
//      both through per-warp partials summed in a fixed order; M = S∘L
//      into shared memory over dS;
//   5. per 64-wide head-dim chunk: du = Mᵀ·dy, then dx, and the row sums of
//      du∘x and x∘sB (ddt, dw); a chunk past the first streams B and dst
//      again for its sB;
//   6. dcum and da: a reverse warp scan in f64.
// Swizzles keep every fragment pattern free of bank conflicts: (row g,
// column t) and (row t, column g) on the N-slices and on x / dy, the
// transposed reads of the triangle, and the pairs (row g, columns 2t, 2t+1).
// `cum` is summed and differenced in f64 and only cum_i - cum_j rounded to
// f32, as in the forward: at Q = 128 a chunk's log-decay reaches hundreds.
// No atomics: two launches give the same bits. Q <= 128, P <= 128 a launch
// (kernels/ssd_chunk.py runs a wider head as 128-column head-dim chunks and
// sums their results), any N.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "ssd_mma.cuh"  // mma, cp_async16, cp_async4, cp_commit, cp_wait_all

namespace {

constexpr int NT = 256;     // threads a CTA: 8 warps
constexpr int QM = 128;     // longest chunk a CTA holds
constexpr int NS = 16;      // width of a staged N-slice
constexpr int PC = 64;      // head-dim chunk of du, sB and dx
constexpr int PMAX = 128;   // widest head dim the kernel holds (x and dy stay in shared memory)
constexpr int TILES = 9;    // 16 x 8 tiles of S and dy·xᵀ a warp holds (half of strips w, 7 - w)
constexpr int TRI = 72;     // causal 16 x 8 tiles of a QM x QM matrix
constexpr int MAX_DEV = 64;

// Shared memory, carved at run time from the padded head dim pp (P rounded
// up to 64) and x's type.
template <typename T>
struct Smem {
  double* cum;  // [QM] cum; then [QM, QM + 16) scan partials
  float *dt, *g, *w, *dw, *dcum;
  float* D;     // the 72 causal tiles of dS, then M: tile (s, jt) at (s(s+1) + jt)·128
  T *xs, *dys;  // [QM][pp], row r's 4-byte words XOR-ed by xsw(r)
  float* ring;  // two stages of B (QM rows), C (QM rows) and dst (pp rows), NS columns
  int stage;    // floats a stage
  __device__ Smem(unsigned char* p, int pp) {
    cum = reinterpret_cast<double*>(p);
    float* f = reinterpret_cast<float*>(p + (QM + 16) * sizeof(double));
    dt = f; g = f + QM; w = f + 2 * QM; dw = f + 3 * QM; dcum = f + 4 * QM;
    D = f + 5 * QM;
    xs = reinterpret_cast<T*>(D + TRI * 128);
    dys = xs + QM * pp;
    ring = reinterpret_cast<float*>(dys + QM * pp);
    stage = (2 * QM + pp) * NS;
  }
  __device__ float* bs(int st) { return ring + st * stage; }
  __device__ float* cs(int st) { return ring + st * stage + QM * NS; }
  __device__ float* ds(int st) { return ring + st * stage + 2 * QM * NS; }
};

int smem_bytes(int pp, int tsize) {
  return (QM + 16) * 8 + 5 * QM * 4 + TRI * 128 * 4 + 2 * QM * pp * tsize + 2 * (2 * QM + pp) * NS * 4;
}

template <typename T>
__device__ __forceinline__ float ld(const T* p);
template <>
__device__ __forceinline__ float ld<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T>
__device__ __forceinline__ float2 ld2(const T* p);
template <>
__device__ __forceinline__ float2 ld2<float>(const float* p) { return *reinterpret_cast<const float2*>(p); }
template <>
__device__ __forceinline__ float2 ld2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Store the pair (v0, v1) at columns c, c + 1 of a row of width K.
template <typename T>
__device__ __forceinline__ void store_pair(T* row, int c, int K, float v0, float v1) {
  if ((K & 1) == 0 && c + 1 < K) {
    st2(row + c, v0, v1);
  } else {
    if (c < K) st1(row + c, v0);
    if (c + 1 < K) st1(row + c + 1, v1);
  }
}

// Swizzles. An N-slice row r (NS floats) XORs its columns by fsw(r); a row r
// of x or dy XORs its 4-byte words by xsw(r) (for bf16 the element index by
// 2·xsw(r)); a triangle tile row r (8 floats) its columns by r & 4.
__device__ __forceinline__ int fsw(int r) { return ((r & 2) << 2) | (r & 4); }
__device__ __forceinline__ int xsw(int r) { return ((r & 3) << 3) | (r & 4); }
template <typename T>
__device__ __forceinline__ int xpos(int r, int c, int pp) {
  return r * pp + (c ^ (xsw(r) << (sizeof(T) == 2 ? 1 : 0)));
}
__device__ __forceinline__ int tile_base(int s, int jt) { return (s * (s + 1) + jt) << 7; }

// A fragment (rows i, i + 8 of strip s; columns 8·jt + t, + 4) of the
// triangle, read along its rows: dS for dS·B. o0 = 8g + (t ^ (g & 4)).
__device__ __forceinline__ void frag_rows(const float* D, int s, int jt, int o0, float* v) {
  const float* p = D + tile_base(s, jt);
  v[0] = p[o0];
  v[1] = p[64 + o0];
  v[2] = p[o0 ^ 4];
  v[3] = p[64 + (o0 ^ 4)];
}

// A fragment of the transpose (rows j, j + 8 of strip s of Dᵀ; columns
// 8·it + t, + 4, which are rows of D): dSᵀ for dSᵀ·C and Mᵀ for Mᵀ·dy.
// c0 = 8t + g, c2 = 8(t + 4) + (g ^ 4).
__device__ __forceinline__ void frag_cols(const float* D, int s, int it, int c0, int c2, float* v) {
  const float* p = D + tile_base(it >> 1, 2 * s) + 64 * (it & 1);
  v[0] = p[c0];
  v[1] = p[128 + c0];
  v[2] = p[c2];
  v[3] = p[128 + c2];
}

// hi = tf32(v) rounded to nearest, ties away, on the integer pipe: the same
// bits as cvt.rna.tf32.f32 for finite v (tests/test_torch_ssd.py `tf32`),
// off the conversion pipe (a probe copy that rounded with cvt ran slower on
// the H100). lo = v - hi goes to the MMA unrounded, as in
// the forward's split, which keeps cvt: the forward is left as it was
// measured.
__device__ __forceinline__ void spl(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi)));
}
__device__ __forceinline__ void spl4(const float* v, uint32_t* hi, uint32_t* lo) {
#pragma unroll
  for (int e = 0; e < 4; ++e) spl(v[e], hi[e], lo[e]);
}
__device__ __forceinline__ void spl2(float v0, float v1, uint32_t* hi, uint32_t* lo) {
  spl(v0, hi[0], lo[0]);
  spl(v1, hi[1], lo[1]);
}

__device__ __forceinline__ void exact4(const float* v, uint32_t* b) {
#pragma unroll
  for (int e = 0; e < 4; ++e) b[e] = __float_as_uint(v[e]);
}

// K independent sums d_k += a_k · b_k on the tensor cores, each into a fresh
// accumulator that a rounded f32 add folds into d_k (as the forward's mma3
// does), with the K chains' passes interleaved: an MMA never waits on the one
// issued just before it (an MMA's result comes tens of cycles after its
// issue, and `asm volatile` keeps program order, so chains written one after
// another run one after another). MODE:
// P3 = 3xTF32 (al·bh, ah·bl, ah·bh); P2A = a split, b exact in TF32 (al·b,
// ah·b; b in bh); P2B = a exact, b split (a·bl, a·bh; a in ah); P1 = both
// exact.
enum { P3, P2A, P2B, P1 };
template <int MODE, int K>
__device__ __forceinline__ void mmak(float* const (&d)[K], const uint32_t* const (&ah)[K],
                                     const uint32_t* const (&al)[K], const uint32_t* const (&bh)[K],
                                     const uint32_t* const (&bl)[K]) {
  float t[K][4];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) t[k][e] = 0.f;
  if (MODE == P3 || MODE == P2A) {
#pragma unroll
    for (int k = 0; k < K; ++k) mma(t[k], al[k], bh[k]);
  }
  if (MODE == P3 || MODE == P2B) {
#pragma unroll
    for (int k = 0; k < K; ++k) mma(t[k], ah[k], bl[k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) mma(t[k], ah[k], bh[k]);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[k][e] = __fadd_rn(d[k][e], t[k][e]);
}

__device__ __forceinline__ void cp_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Column tile of a warp's tile t: strip A (its rows iA) for t < na, else
// strip B from column tile jb. A warp's count na of strip-A tiles is a run-time
// value: one copy of the tile code serves every warp (five compile-time
// copies, one for each na, were slower on the card: the warps of an SM keep
// all five hot).
__device__ __forceinline__ int tile_col(int t, int na, int jb) { return t < na ? t : jb + t - na; }

// Issue the copies of the N-slice at columns n0.. of B, of C (when withC) and
// of dst into ring stage `st` as one group: zeros past Q, P and N. `vec`:
// 16-byte copies (N a multiple of 4, pointers 16-byte aligned), else 4-byte.
template <typename T>
__device__ __forceinline__ void stage_slice(Smem<T>& s, int st, const float* Bg, const float* Cg,
                                            const float* dg, int n0, int Q, int P, int N, int pp,
                                            long long rsN, bool vec, bool withC, int tid) {
  float* bs = s.bs(st);
  float* cs = s.cs(st);
  float* ds = s.ds(st);
  if (vec) {  // thread tid copies column chunk 4·(tid & 3) of rows tid / 4 + 64m
    const int k = 4 * (tid & 3), n = n0 + k, r0 = tid >> 2;
#pragma unroll
    for (int m = 0; m < QM / 64; ++m) {
      const int r = r0 + 64 * m;
      const bool ok = r < Q && n < N;
      const long long off = ok ? r * rsN + n : 0;
      cp_async16(bs + r * NS + (k ^ fsw(r)), Bg + off, ok ? 16 : 0);
      if (withC) cp_async16(cs + r * NS + (k ^ fsw(r)), Cg + off, ok ? 16 : 0);
    }
    for (int r = r0; r < pp; r += 64) {
      const bool ok = r < P && n < N;
      cp_async16(ds + r * NS + (k ^ fsw(r)), dg + (ok ? (long long)r * N + n : 0), ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < (2 * QM + pp) * NS; e += NT) {
      const int r = e / NS, k = e % NS, n = n0 + k;
      if (!withC && r >= QM && r < 2 * QM) continue;
      const int q = r < QM ? r : (r < 2 * QM ? r - QM : r - 2 * QM);
      const bool ok = n < N && (r < 2 * QM ? q < Q : q < P);
      const float* src = r < QM ? Bg : (r < 2 * QM ? Cg : dg);
      const long long off = ok ? (r < 2 * QM ? q * rsN : (long long)q * N) + n : 0;
      cp_async4(s.bs(st) + r * NS + (k ^ fsw(q)), src + off, ok ? 4 : 0);
    }
  }
  cp_commit();
}

// dM = dy·xᵀ over the head dim for a warp's 9 tiles (rows of dy: A, rows of
// x: B). bf16: both exact, one product; f32: 3xTF32. One A fragment is live
// at a time: strip A's, then from tile na on strip B's (na is even, so each
// pair of tiles lies in one strip; tile 8 is in strip B).
template <bool XE, typename T>
__device__ __forceinline__ void dm_tiles(float (&acc)[TILES][4], const T* xs, const T* dys, int pp,
                                         int kp, int na, int iA, int iB, int jb, int gq, int tq) {
#pragma unroll 1
  for (int k0 = 0; k0 < kp; k0 += 8) {
    const int c0 = k0 + tq, c1 = k0 + tq + 4;
    uint32_t ah[4], al[4];
    auto afrag = [&](int i) {
      const float v[4] = {ld(dys + xpos<T>(i, c0, pp)), ld(dys + xpos<T>(i + 8, c0, pp)),
                          ld(dys + xpos<T>(i, c1, pp)), ld(dys + xpos<T>(i + 8, c1, pp))};
      if (XE) exact4(v, ah);
      else spl4(v, ah, al);
    };
    afrag(na > 0 ? iA : iB);
#pragma unroll
    for (int t0 = 0; t0 < TILES; t0 += 2) {
      if (t0 == na && na > 0) afrag(iB);
      uint32_t bh[2][2], bl[2][2];
      const int nk = t0 + 1 < TILES ? 2 : 1;
#pragma unroll
      for (int k = 0; k < nk; ++k) {
        const int j = 8 * tile_col(t0 + k, na, jb) + gq;
        const float b0 = ld(xs + xpos<T>(j, c0, pp)), b1 = ld(xs + xpos<T>(j, c1, pp));
        if (XE) {
          bh[k][0] = __float_as_uint(b0);
          bh[k][1] = __float_as_uint(b1);
        } else {
          spl2(b0, b1, bh[k], bl[k]);
        }
      }
      if (nk == 2) {
        float* const dd[2] = {acc[t0], acc[t0 + 1]};
        const uint32_t* const AH[2] = {ah, ah};
        const uint32_t* const AL[2] = {al, al};
        const uint32_t* const BH[2] = {bh[0], bh[1]};
        const uint32_t* const BL[2] = {bl[0], bl[1]};
        mmak<XE ? P1 : P3, 2>(dd, AH, AL, BH, BL);
      } else {
        float* const dd[1] = {acc[t0]};
        const uint32_t* const AH[1] = {ah};
        const uint32_t* const AL[1] = {al};
        const uint32_t* const BH[1] = {bh[0]};
        const uint32_t* const BL[1] = {bl[0]};
        mmak<XE ? P1 : P3, 1>(dd, AH, AL, BH, BL);
      }
    }
  }
}

// Write a warp's 9 tiles of v∘L into the triangle, v = acc (∘ dt_j when
// DT): zero outside i >= j, i < Q. Pairs (row i, columns 2t, 2t + 1).
template <bool DT, typename T>
__device__ __forceinline__ void dump_tiles(const float (&acc)[TILES][4], Smem<T>& s, int na, int sA, int sB,
                                           int jb, int Q, int gq, int tq) {
  const int iA = 16 * sA + gq, iB = 16 * sB + gq;
  const double cA0 = s.cum[iA], cA1 = s.cum[iA + 8], cB0 = s.cum[iB], cB1 = s.cum[iB + 8];
  const int o = 8 * gq + ((2 * tq) ^ (gq & 4));
#pragma unroll
  for (int t = 0; t < TILES; ++t) {
    const bool inA = t < na;
    const int jt = tile_col(t, na, jb);
    const int i = inA ? iA : iB, j = 8 * jt + 2 * tq;
    const double c0 = inA ? cA0 : cB0, c1 = inA ? cA1 : cB1;
    const double2 cj = *reinterpret_cast<const double2*>(&s.cum[j]);
    float v[4] = {acc[t][0], acc[t][1], acc[t][2], acc[t][3]};
    if (DT) {
      const float2 d = *reinterpret_cast<const float2*>(&s.dt[j]);
      v[0] *= d.x; v[1] *= d.y; v[2] *= d.x; v[3] *= d.y;
    }
    const float m0 = (i < Q && j <= i) ? v[0] * expf((float)(c0 - cj.x)) : 0.f;
    const float m1 = (i < Q && j + 1 <= i) ? v[1] * expf((float)(c0 - cj.y)) : 0.f;
    const float m2 = (i + 8 < Q && j <= i + 8) ? v[2] * expf((float)(c1 - cj.x)) : 0.f;
    const float m3 = (i + 8 < Q && j + 1 <= i + 8) ? v[3] * expf((float)(c1 - cj.y)) : 0.f;
    float* p = s.D + tile_base(inA ? sA : sB, jt) + o;
    st2(p, m0, m1);
    st2(p + 64, m2, m3);
  }
}

// S += C·Bᵀ over one N-slice for a warp's 9 tiles (3xTF32), two tiles'
// chains interleaved. f1 = fsw(g). One A fragment is live at a time: strip
// A's, then from tile na on strip B's (na is even, so each pair of tiles
// lies in one strip; tile 8 is in strip B). Holding both strips' fragments
// and picking one a tile needs 16 more registers, and was slower.
__device__ __forceinline__ void s_slice(float (&sc)[TILES][4], const float* cs, const float* bs, int na,
                                        int iA, int iB, int jb, int f1, int gq, int tq) {
#pragma unroll
  for (int kk = 0; kk < NS; kk += 8) {
    const int c0 = (kk + tq) ^ f1, c1 = (kk + tq + 4) ^ f1;
    uint32_t ah[4], al[4];
    auto afrag = [&](int i) {
      const float v[4] = {cs[i * NS + c0], cs[(i + 8) * NS + c0], cs[i * NS + c1], cs[(i + 8) * NS + c1]};
      spl4(v, ah, al);
    };
    afrag(na > 0 ? iA : iB);
#pragma unroll
    for (int t0 = 0; t0 < TILES; t0 += 2) {
      if (t0 == na && na > 0) afrag(iB);
      uint32_t bh[2][2], bl[2][2];
      const int nk = t0 + 1 < TILES ? 2 : 1;
#pragma unroll
      for (int k = 0; k < nk; ++k) {
        const int j = 8 * tile_col(t0 + k, na, jb) + gq;
        spl2(bs[j * NS + c0], bs[j * NS + c1], bh[k], bl[k]);
      }
      if (nk == 2) {
        float* const dd[2] = {sc[t0], sc[t0 + 1]};
        const uint32_t* const AH[2] = {ah, ah};
        const uint32_t* const AL[2] = {al, al};
        const uint32_t* const BH[2] = {bh[0], bh[1]};
        const uint32_t* const BL[2] = {bl[0], bl[1]};
        mmak<P3, 2>(dd, AH, AL, BH, BL);
      } else {
        float* const dd[1] = {sc[t0]};
        const uint32_t* const AH[1] = {ah};
        const uint32_t* const AL[1] = {al};
        const uint32_t* const BH[1] = {bh[0]};
        const uint32_t* const BL[1] = {bl[0]};
        mmak<P3, 1>(dd, AH, AL, BH, BL);
      }
    }
  }
}

// sB += B·dstᵀ over one N-slice: rows of strips lo and hi, the 4 head-dim
// tiles from row p0 + g of dst (3xTF32).
__device__ __forceinline__ void sb_slice(float (&sb)[2][4][4], const float* bs, const float* ds, int iA,
                                         int iB, int p0, int f1, int tq) {
#pragma unroll
  for (int kk = 0; kk < NS; kk += 8) {
    const int c0 = (kk + tq) ^ f1, c1 = (kk + tq + 4) ^ f1;
    uint32_t aAh[4], aAl[4], aBh[4], aBl[4];
    {
      const float v[4] = {bs[iA * NS + c0], bs[(iA + 8) * NS + c0], bs[iA * NS + c1], bs[(iA + 8) * NS + c1]};
      spl4(v, aAh, aAl);
    }
    {
      const float v[4] = {bs[iB * NS + c0], bs[(iB + 8) * NS + c0], bs[iB * NS + c1], bs[(iB + 8) * NS + c1]};
      spl4(v, aBh, aBl);
    }
#pragma unroll
    for (int m = 0; m < 4; m += 2) {  // two head-dim tiles of both strips interleaved
      uint32_t bh[2][2], bl[2][2];
      spl2(ds[(p0 + 8 * m) * NS + c0], ds[(p0 + 8 * m) * NS + c1], bh[0], bl[0]);
      spl2(ds[(p0 + 8 * m + 8) * NS + c0], ds[(p0 + 8 * m + 8) * NS + c1], bh[1], bl[1]);
      float* const dd[4] = {sb[0][m], sb[1][m], sb[0][m + 1], sb[1][m + 1]};
      const uint32_t* const AH[4] = {aAh, aBh, aAh, aBh};
      const uint32_t* const AL[4] = {aAl, aBl, aAl, aBl};
      const uint32_t* const BH[4] = {bh[0], bh[0], bh[1], bh[1]};
      const uint32_t* const BL[4] = {bl[0], bl[0], bl[1], bl[1]};
      mmak<P3, 4>(dd, AH, AL, BH, BL);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) ssd_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const float* __restrict__ Bm, const float* __restrict__ Cm, const T* __restrict__ dy,
    const float* __restrict__ dst, const float* __restrict__ dtotal, T* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ da, float* __restrict__ dB,
    float* __restrict__ dC, int Q, int H, int P, int N, int pp) {
  constexpr bool XE = std::is_same<T, __nv_bfloat16>::value;  // x and dy exact in TF32
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T> s(smem_raw, pp);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row group and thread in group
  const long long cta = blockIdx.x;         // (b·nc + c)·H + h
  const int h = (int)(cta % H);
  const long long row0 = (cta / H) * Q;     // row (b, c, q = 0) of the (.., Q, H, ..) tensors
  const long long rsN = (long long)H * N, rsP = (long long)H * P;
  const float* Bg = Bm + (row0 * H + h) * (long long)N;
  const float* Cg = Cm + (row0 * H + h) * (long long)N;
  const T* xg = x + (row0 * H + h) * (long long)P;
  const T* dyg = dy + (row0 * H + h) * (long long)P;
  const float* dg = dst + cta * (long long)P * N;
  const bool vecN = (N & 3) == 0 &&
                    ((reinterpret_cast<uintptr_t>(Bm) | reinterpret_cast<uintptr_t>(Cm) |
                      reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const bool vecP = (P * (int)sizeof(T)) % 16 == 0 &&
                    ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) & 15) == 0;
  // Warp roles: strip pair (lo, hi) = (pair, 7 - pair); `half` takes half of
  // their S and dy·xᵀ tiles (as the forward's C·Bᵀ) and 32 columns of each
  // head-dim chunk of du and sB; dC and dB take strip `warp` (below).
  const int pair = warp & 3, half = warp >> 2;
  const int lo = pair, hi = 7 - pair;
  const int na = half ? 0 : 2 * (pair + 1);  // this warp's tiles of strip lo (S, dy·xᵀ)
  const int iA = 16 * lo + gq, iB = 16 * hi + gq;
  const int jb = half ? TILES - 2 * (pair + 1) : 0;  // strip hi's first column tile in this warp's tiles
  const int kq = (Q + 7) / 8, kp = (P + 7) / 8 * 8;
  const int nsl = (N + NS - 1) / NS;
  const int f1 = fsw(gq), f2a = fsw(tq), f2b = fsw(tq + 4);  // slice swizzles: rows g; t; t + 4
  const int o0 = 8 * gq + (tq ^ (gq & 4));                   // triangle, along rows
  const int c0 = 8 * tq + gq, c2 = 8 * (tq + 4) + (gq ^ 4);   // triangle, along columns

  // ---- x and dy land once (group 1), the first N-slice after them (group 2) ----
  if (vecP) {  // thread tid copies 16-byte chunk tid % cpr of rows tid / cpr + (NT / cpr)·m
    constexpr int E = 16 / sizeof(T);
    const int lc = 31 - __clz(pp / E);  // log2 of the chunks a row: pp is 64 or 128
    const int c = (tid & ((1 << lc) - 1)) * E;
    for (int r = tid >> lc; r < QM; r += NT >> lc) {
      const bool ok = r < Q && c < P;
      const long long off = ok ? r * rsP + c : 0;
      cp_async16(s.xs + xpos<T>(r, c, pp), xg + off, ok ? 16 : 0);
      cp_async16(s.dys + xpos<T>(r, c, pp), dyg + off, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < 2 * QM * pp; e += NT) {
      const int which = e / (QM * pp), r = (e / pp) % QM, c = e % pp;
      const T* src = which ? dyg : xg;
      (which ? s.dys : s.xs)[xpos<T>(r, c, pp)] = (r < Q && c < P) ? src[r * rsP + c] : T(0.f);
    }
  }
  cp_commit();
  stage_slice(s, 0, Bg, Cg, dg, 0, Q, P, N, pp, rsN, vecN, true, tid);

  // ---- 1. cum = cumsum(a) in f64: a shuffle scan per warp, then the warps' sums ----
  if (tid < QM) {
    double c = tid < Q ? (double)a[(row0 + tid) * H + h] : 0.0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, c, o);
      if (lane >= o) c += u;
    }
    s.cum[tid] = c;
    if (lane == 31) s.cum[QM + warp] = c;
    s.dt[tid] = tid < Q ? dt[(row0 + tid) * H + h] : 0.f;
  }
  __syncthreads();
  if (tid < QM) {
    double c = s.cum[tid];
    for (int v = 0; v < warp; ++v) c += s.cum[QM + v];
    s.cum[tid] = c;
  }
  __syncthreads();
  if (tid < QM) {
    const float g = tid < Q ? expf((float)(s.cum[Q - 1] - s.cum[tid])) : 0.f;
    s.g[tid] = g;
    s.w[tid] = s.dt[tid] * g;
  }
  cp_wait_one();
  __syncthreads();  // x, dy, cum, dt, g and w are in shared memory

  // ---- 2. dM = (dy·xᵀ)∘dt_j; dS = dM∘L into the triangle ----
  {
    float acc[TILES][4];
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
    dm_tiles<XE>(acc, s.xs, s.dys, pp, kp, na, iA, iB, jb, gq, tq);
    dump_tiles<true>(acc, s, na, lo, hi, jb, Q, gq, tq);
  }

  // ---- 3. per N-slice: S, sB (head-dim chunk 0), and the slice's dC and dB ----
  float sc[TILES][4], sb[2][4][4];
#pragma unroll
  for (int t = 0; t < TILES; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[t][e] = 0.f;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) sb[u][m][e] = 0.f;
#pragma unroll 1
  for (int sl = 0; sl < nsl; ++sl) {
    cp_wait_all();
    __syncthreads();  // slice sl landed (and the triangle is written); stage (sl + 1) & 1 is free
    if (sl + 1 < nsl) stage_slice(s, (sl + 1) & 1, Bg, Cg, dg, (sl + 1) * NS, Q, P, N, pp, rsN, vecN, true, tid);
    const float* bs = s.bs(sl & 1);
    const float* cs = s.cs(sl & 1);
    const float* ds = s.ds(sl & 1);
    s_slice(sc, cs, bs, na, iA, iB, jb, f1, gq, tq);
    sb_slice(sb, bs, ds, iA, iB, 32 * half + gq, f1, tq);

    // dC = dS·B and dB = w·(x·dst) + dSᵀ·C for strip `warp` (rows i0, i0 + 8),
    // both 8-column tiles of the slice: one A fragment feeds two chains
    const int i0 = 16 * warp + gq;
    const int n = sl * NS + 2 * tq;  // this lane's output columns n + 8u, n + 8u + 1
    {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const int nk = min(2 * (warp + 1), kq);  // j <= i
#pragma unroll 1
      for (int jt = 0; jt < nk; ++jt) {
        float v[4];
        uint32_t ah[4], al[4];
        frag_rows(s.D, warp, jt, o0, v);
        spl4(v, ah, al);
        const float* b0 = bs + (8 * jt + tq) * NS;
        const float* b1 = bs + (8 * jt + tq + 4) * NS;
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int u = 0; u < 2; ++u) spl2(b0[(8 * u + gq) ^ f2a], b1[(8 * u + gq) ^ f2b], bh[u], bl[u]);
        float* const dd[2] = {acc[0], acc[1]};
        const uint32_t* const AH[2] = {ah, ah};
        const uint32_t* const AL[2] = {al, al};
        const uint32_t* const BH[2] = {bh[0], bh[1]};
        const uint32_t* const BL[2] = {bl[0], bl[1]};
        mmak<P3, 2>(dd, AH, AL, BH, BL);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          if (i0 + 8 * rr < Q)
            store_pair(dC + ((row0 + i0 + 8 * rr) * H + h) * (long long)N, n + 8 * u, N, acc[u][2 * rr],
                       acc[u][2 * rr + 1]);
    }
    {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 1
      for (int k0 = 0; k0 < kp; k0 += 8) {  // x·dst over the head dim
        const float v[4] = {ld(s.xs + xpos<T>(i0, k0 + tq, pp)), ld(s.xs + xpos<T>(i0 + 8, k0 + tq, pp)),
                            ld(s.xs + xpos<T>(i0, k0 + tq + 4, pp)), ld(s.xs + xpos<T>(i0 + 8, k0 + tq + 4, pp))};
        uint32_t ah[4], al[4];
        if (XE) exact4(v, ah);
        else spl4(v, ah, al);
        const float* d0 = ds + (k0 + tq) * NS;
        const float* d1 = ds + (k0 + tq + 4) * NS;
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int u = 0; u < 2; ++u) spl2(d0[(8 * u + gq) ^ f2a], d1[(8 * u + gq) ^ f2b], bh[u], bl[u]);
        float* const dd[2] = {acc[0], acc[1]};
        const uint32_t* const AH[2] = {ah, ah};
        const uint32_t* const AL[2] = {al, al};
        const uint32_t* const BH[2] = {bh[0], bh[1]};
        const uint32_t* const BL[2] = {bl[0], bl[1]};
        mmak<XE ? P2B : P3, 2>(dd, AH, AL, BH, BL);
      }
      const float w0 = s.w[i0], w1 = s.w[i0 + 8];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        acc[u][0] *= w0; acc[u][1] *= w0; acc[u][2] *= w1; acc[u][3] *= w1;
      }
#pragma unroll 1
      for (int it = 2 * warp; it < kq; ++it) {  // i >= j
        float v[4];
        uint32_t ah[4], al[4];
        frag_cols(s.D, warp, it, c0, c2, v);
        spl4(v, ah, al);
        const float* c0p = cs + (8 * it + tq) * NS;
        const float* c1p = cs + (8 * it + tq + 4) * NS;
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int u = 0; u < 2; ++u) spl2(c0p[(8 * u + gq) ^ f2a], c1p[(8 * u + gq) ^ f2b], bh[u], bl[u]);
        float* const dd[2] = {acc[0], acc[1]};
        const uint32_t* const AH[2] = {ah, ah};
        const uint32_t* const AL[2] = {al, al};
        const uint32_t* const BH[2] = {bh[0], bh[1]};
        const uint32_t* const BL[2] = {bl[0], bl[1]};
        mmak<P3, 2>(dd, AH, AL, BH, BL);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          if (i0 + 8 * rr < Q)
            store_pair(dB + ((row0 + i0 + 8 * rr) * H + h) * (long long)N, n + 8 * u, N, acc[u][2 * rr],
                       acc[u][2 * rr + 1]);
    }
  }
  __syncthreads();  // the ring is consumed: the partial sums go over it

  // ---- 4. G = dS∘S: row sums and column sums through per-warp partials ----
  float* rowP = s.ring;             // [2][QM]: by half
  float* colP = s.ring + 2 * QM;    // [8][QM]: by warp
  for (int q = lane; q < QM; q += 32) colP[warp * QM + q] = 0.f;
  __syncwarp();
  {
    const int o = 8 * gq + ((2 * tq) ^ (gq & 4));
    float rA0 = 0.f, rA1 = 0.f, rB0 = 0.f, rB1 = 0.f;
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      const int jt = tile_col(t, na, jb);
      const float* p = s.D + tile_base(t < na ? lo : hi, jt) + o;
      const float2 d0 = *reinterpret_cast<const float2*>(p), d1 = *reinterpret_cast<const float2*>(p + 64);
      const float G0 = d0.x * sc[t][0], G1 = d0.y * sc[t][1], G2 = d1.x * sc[t][2], G3 = d1.y * sc[t][3];
      if (t < na) { rA0 += G0 + G1; rA1 += G2 + G3; }
      else { rB0 += G0 + G1; rB1 += G2 + G3; }
      float k0 = G0 + G2, k1 = G1 + G3;  // columns 8jt + 2t, + 1, summed over the 8 row groups
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        k0 += __shfl_xor_sync(0xffffffffu, k0, off);
        k1 += __shfl_xor_sync(0xffffffffu, k1, off);
      }
      if (gq == 0) {
        colP[warp * QM + 8 * jt + 2 * tq] += k0;
        colP[warp * QM + 8 * jt + 2 * tq + 1] += k1;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rA0 += __shfl_xor_sync(0xffffffffu, rA0, off);
      rA1 += __shfl_xor_sync(0xffffffffu, rA1, off);
      rB0 += __shfl_xor_sync(0xffffffffu, rB0, off);
      rB1 += __shfl_xor_sync(0xffffffffu, rB1, off);
    }
    if (tq == 0) {
      rowP[half * QM + iA] = rA0;
      rowP[half * QM + iA + 8] = rA1;
      rowP[half * QM + iB] = rB0;
      rowP[half * QM + iB + 8] = rB1;
    }
  }
  // M = S∘L into the triangle, over dS: each lane overwrites the pairs it
  // has just read, so no barrier stands between the two
  dump_tiles<false>(sc, s, na, lo, hi, jb, Q, gq, tq);
  __syncthreads();  // the partial sums are written
  if (tid < QM) {
    float col = 0.f;
#pragma unroll
    for (int v = 0; v < 8; ++v) col += colP[v * QM + tid];
    s.dcum[tid] = (rowP[tid] + rowP[QM + tid]) - col;
  }

  // ---- 5. per head-dim chunk: du = Mᵀ·dy, dx, and the row sums for ddt and dw ----
  float pddt[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, pdw[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  const int ft = xsw(tq) << (XE ? 1 : 0), ft4 = xsw(tq + 4) << (XE ? 1 : 0);  // dy rows t, t + 4
#pragma unroll 1
  for (int p0 = 0; p0 < P; p0 += PC) {
    if (p0 > 0) {  // sB of this chunk: B and dst stream again
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) sb[u][m][e] = 0.f;
      __syncthreads();  // the ring is free
      stage_slice(s, 0, Bg, Cg, dg, 0, Q, P, N, pp, rsN, vecN, false, tid);
#pragma unroll 1
      for (int sl = 0; sl < nsl; ++sl) {
        cp_wait_all();
        __syncthreads();
        if (sl + 1 < nsl) stage_slice(s, (sl + 1) & 1, Bg, Cg, dg, (sl + 1) * NS, Q, P, N, pp, rsN, vecN, false, tid);
        sb_slice(sb, s.bs(sl & 1), s.ds(sl & 1), iA, iB, p0 + 32 * half + gq, f1, tq);
      }
    }
    __syncthreads();  // M is written (and, past the first chunk, the sweep is done)
    const int pw = p0 + 32 * half;  // this warp's 32 columns
    float du[2][4][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) du[u][m][e] = 0.f;
    if (pw < P) {
#pragma unroll 1
      for (int it = 2 * lo; it < kq; ++it) {
        uint32_t ahL[4], alL[4], ahH[4], alH[4];
        float v[4];
        frag_cols(s.D, lo, it, c0, c2, v);
        spl4(v, ahL, alL);
        const bool withH = it >= 2 * hi;
        if (withH) {
          frag_cols(s.D, hi, it, c0, c2, v);
          spl4(v, ahH, alH);
        }
        const T* r0 = s.dys + (8 * it + tq) * pp;
        const T* r1 = s.dys + (8 * it + tq + 4) * pp;
#pragma unroll
        for (int m = 0; m < 4; m += 2) {  // two head-dim tiles (of both strips) interleaved
          uint32_t bh[2][2], bl[2][2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int p = pw + 8 * (m + k) + gq;
            const float b0 = ld(r0 + (p ^ ft)), b1 = ld(r1 + (p ^ ft4));
            if (XE) {
              bh[k][0] = __float_as_uint(b0);
              bh[k][1] = __float_as_uint(b1);
            } else {
              spl2(b0, b1, bh[k], bl[k]);
            }
          }
          if (withH) {
            float* const dd[4] = {du[0][m], du[0][m + 1], du[1][m], du[1][m + 1]};
            const uint32_t* const AH[4] = {ahL, ahL, ahH, ahH};
            const uint32_t* const AL[4] = {alL, alL, alH, alH};
            const uint32_t* const BH[4] = {bh[0], bh[1], bh[0], bh[1]};
            const uint32_t* const BL[4] = {bl[0], bl[1], bl[0], bl[1]};
            mmak<XE ? P2A : P3, 4>(dd, AH, AL, BH, BL);
          } else {
            float* const dd[2] = {du[0][m], du[0][m + 1]};
            const uint32_t* const AH[2] = {ahL, ahL};
            const uint32_t* const AL[2] = {alL, alL};
            const uint32_t* const BH[2] = {bh[0], bh[1]};
            const uint32_t* const BL[2] = {bl[0], bl[1]};
            mmak<XE ? P2A : P3, 2>(dd, AH, AL, BH, BL);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int j = 16 * (u ? hi : lo) + gq + 8 * rr;
        const float dtj = s.dt[j], wj = s.w[j];
        T* out = dx + ((row0 + j) * H + h) * (long long)P;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int p = pw + 8 * m + 2 * tq;
          const float d0 = du[u][m][2 * rr], d1 = du[u][m][2 * rr + 1];
          const float s0 = sb[u][m][2 * rr], s1 = sb[u][m][2 * rr + 1];
          const float2 xv = p < pp ? ld2(s.xs + xpos<T>(j, p, pp)) : make_float2(0.f, 0.f);
          pddt[u][rr] = fmaf(d0, xv.x, fmaf(d1, xv.y, pddt[u][rr]));
          pdw[u][rr] = fmaf(xv.x, s0, fmaf(xv.y, s1, pdw[u][rr]));
          if (j < Q) store_pair(out, p, P, d0 * dtj + wj * s0, d1 * dtj + wj * s1);
        }
      }
  }

  // ---- 6. ddt, dw, then dcum and da (a reverse scan in f64) ----
  __syncthreads();  // the ring is free
  float* ddtP = s.ring;           // [2][QM]: by half
  float* dwP = s.ring + 2 * QM;   // [2][QM]
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float vt = pddt[u][rr], vw = pdw[u][rr];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        vt += __shfl_xor_sync(0xffffffffu, vt, off);
        vw += __shfl_xor_sync(0xffffffffu, vw, off);
      }
      if (tq == 0) {
        const int j = 16 * (u ? hi : lo) + gq + 8 * rr;
        ddtP[half * QM + j] = vt;
        dwP[half * QM + j] = vw;
      }
    }
  __syncthreads();
  if (tid < QM) {
    const int q = tid;
    const float dwq = dwP[q] + dwP[QM + q];
    const float dww = q < Q ? dwq * s.w[q] : 0.f;
    if (q < Q) ddt[(row0 + q) * H + h] = (ddtP[q] + ddtP[QM + q]) + s.g[q] * dwq;
    double c = q < Q ? (double)(s.dcum[q] - dww) : 0.0;  // reverse inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_down_sync(0xffffffffu, c, o);
      if (lane + o < 32) c += u;
    }
    double e = (double)dww;  // Σ dw·w
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) e += __shfl_xor_sync(0xffffffffu, e, o);
    if (lane == 0) {
      s.cum[QM + warp] = c;      // the warp's sum of dcum
      s.cum[QM + 8 + warp] = e;  // the warp's sum of dw·w
    }
    s.cum[q] = c;
  }
  __syncthreads();
  if (tid < QM && tid < Q) {
    const int q = tid;
    double c = s.cum[q] + (double)dtotal[cta];
    for (int v = 0; v < QM / 32; ++v) {
      c += s.cum[QM + 8 + v];
      if (v > warp) c += s.cum[QM + v];
    }
    da[(row0 + q) * H + h] = (float)c;
  }
}

// Set the kernel's shared-memory attributes once for each device.
template <typename T>
int prepare() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEV) return (int)cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << dev;
  if (done.load(std::memory_order_acquire) & bit) return 0;
  e = cudaFuncSetAttribute(ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes(PMAX, (int)sizeof(T)));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  done.fetch_or(bit, std::memory_order_acq_rel);
  return 0;
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* B, const void* C,
           const void* dy, const void* dst, const void* dtotal, void* dx, void* ddt, void* da,
           void* dB, void* dC, long long ctas, int Q, int H, int P, int N, cudaStream_t stream) {
  const int rc = prepare<T>();
  if (rc != 0) return rc;
  const int pp = (P + PC - 1) / PC * PC;
  ssd_bwd_kernel<T><<<(unsigned)ctas, NT, smem_bytes(pp, (int)sizeof(T)), stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const float*)B, (const float*)C,
      (const T*)dy, (const float*)dst, (const float*)dtotal, (T*)dx, (float*)ddt, (float*)da,
      (float*)dB, (float*)dC, Q, H, P, N, pp);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx: (Bb, nc, Q, H, P) f32, or bf16 when x_bf16; dt, a, ddt, da:
// (Bb, nc, Q, H) f32; B, C, dB, dC: (Bb, nc, Q, H, N) f32; dst: (Bb, nc, H,
// P, N) f32; dtotal: (Bb, nc, H) f32. All contiguous, 1 <= Q <= 128,
// 1 <= P <= 128. Returns a cudaError_t (0 on a clean launch).
extern "C" int ssd_bwd_launch(const void* x, int x_bf16, const void* dt, const void* a,
                              const void* B, const void* C, const void* dy, const void* dst,
                              const void* dtotal, void* dx, void* ddt, void* da, void* dB,
                              void* dC, int Bb, int nc, int Q, int H, int P, int N, void* stream) {
  if (Q < 1 || Q > QM || H < 1 || P < 1 || P > PMAX || N < 1 || Bb < 0 || nc < 0)
    return (int)cudaErrorInvalidValue;
  const long long ctas = (long long)Bb * nc * H;
  if (ctas == 0) return 0;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (x_bf16)
    return launch<__nv_bfloat16>(x, dt, a, B, C, dy, dst, dtotal, dx, ddt, da, dB, dC, ctas, Q, H,
                                 P, N, (cudaStream_t)stream);
  return launch<float>(x, dt, a, B, C, dy, dst, dtotal, dx, ddt, da, dB, dC, ctas, Q, H, P, N,
                       (cudaStream_t)stream);
}

// Shared memory a CTA takes at head dim P, x in bf16 when x_bf16 (bytes).
extern "C" int ssd_bwd_smem_bytes(int P, int x_bf16) { return smem_bytes((P + PC - 1) / PC * PC, x_bf16 ? 2 : 4); }

extern "C" const char* ssd_bwd_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
