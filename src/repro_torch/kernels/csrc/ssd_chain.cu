// Mamba2 SSD chunk-state chain: the state term of the SSD, forward and
// backward.
//
// No TPU twin: it is the state term of `ssd_chunked` (src/repro/models/ssm.py),
// the recurrence across chunks that the JAX package (and, before this kernel,
// kernels/ops.py `ssd`) runs as a loop of array ops around B6. Per (batch b,
// head h), over the chunks c in order, from B6's outputs (the intra-chunk
// term y_intra, the chunk state st and the total log-decay) and the chunk's
// log-decays a and C:
//   cum   = cumsum(a)                        e_q = exp(cum_q)      (per chunk)
//   y[c]  = round(y_intra[c] + e ∘ (C[c] · S_inᵀ))                  (Q, P)
//   S_in  ← S_in · exp(total[c]) + st[c]                           (P, N), f32
// starting from state0 (or zeros); the last S_in is the final state.
//
// Forward, `ssd_chain_fwd_kernel`: one CTA of 8 warps per (b, h, 64-row
// head-dim tile), which walks the chunks in order with the state tile in
// shared memory (f32, [p][n]); two CTAs an SM (~107 KB of shared memory
// each). Warp w owns rows 16w.. of the chunk. Its rows of C stream through a
// per-warp cp.async ring, three 16-column groups in flight, each lane copying
// (and reading back) its own 16 bytes of a row: the k order of the MMAs is
// permuted to match (k = t, t + 4 of k-step s are the state columns
// 4t + 2s, 4t + 2s + 1 of the group). C · S_inᵀ runs on the tensor cores as
// mma.sync m16n8k8 TF32 in B6's split-precision scheme (hi rounded on the
// integer pipe, lo = v - hi; lo·hi + hi·lo + hi·hi, f32 accuracy): each
// 16-column group sums in a fresh accumulator folded in by a rounded f32
// add, four n-tiles' chains interleaved. C made from bf16, as the model
// makes it, is exact in TF32: a warp vote finds a fragment with no low part
// and skips its lo·hi pass, a product of zero. The rows are scaled by e and
// added to y_intra (with bf16 y loaded before the products), rounding y
// once. Meanwhile the chunk's own state st lands in a second tile by
// cp.async; the update S·exp(total) + st then runs in shared memory. Under
// autograd the kernel also writes the incoming state of every chunk after
// the first (`mid`, f32), which the backward reads.
//
// Backward, `ssd_chain_bwd_kernel`: one CTA of 8 warps per (b, h, 64-column
// half of the state) (head dims up to 64; the wrapper splits a wider head),
// over the chunks in reverse with the state's gradient G in registers; two
// CTAs an SM (~91 KB of shared memory each), so that one CTA's loads may
// overlap the other's products. From dy and the final state's gradient, per
// chunk (d y_intra is dy itself, no kernel):
//   dst[c]    = G                              dtotal[c] = exp(total)·Σ G ∘ S_in
//   dC        = e ∘ (dy · S_in)                dcum_q = Σ_n C_qn dC_qn
//   da        = reverse cumsum of dcum (f64)   G ← G·exp(total) + Σ_q e_q dy_qᵀ C_q
// and dstate0 = G at the end. dcum and Σ G ∘ S_in are sums over the state
// columns, so each half writes its share of da and dtotal and the wrapper
// adds the two. The products run as the forward's; with bf16 dy, dy is exact
// in TF32 and each product takes two MMAs (dy·lo + dy·hi of the other
// operand) instead of three. S_in is read from `mid` (saved by the forward),
// not recomputed: the reverse sweep needs each chunk's state in reverse
// order, and holding a (b, h)'s states on chip does not fit past a few
// chunks, so a recompute would go through device memory too and read st
// again. The next chunk's state lands by cp.async while the current chunk's
// second product runs; a and total are read a phase ahead of their use.
//
// `cum` is summed in f64 and rounded to f32 once before exp, as B6 does. No
// atomics: two launches give the same bits.
//
// Bound on the H100 at mamba2-370m's train shape (B 64, nc 4, Q 128, H 32,
// P 64, N 128, bf16 y): the forward moves ~1.34 GB under autograd (C 537 MB,
// st 268, y_intra and y 134 each, the final state 67, `mid` 201), 0.40 ms at
// 3.35 TB/s; its product, 2QNP = 2.1 MFLOP a (b, chunk, head), takes ~0.1 ms
// in 3xTF32 at the dense rate. The backward moves ~1.69 GB, 0.50 ms. Both are
// bound by bytes; what holds them back on the card is the latency between a
// CTA's loads and its products (PERF.md). chip_smoke.py computes the bounds
// from the shapes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "ssd_mma.cuh"  // mma, cp_async16, cp_async4, cp_commit, cp_wait_all

namespace {

constexpr int QM = 128;       // longest chunk
constexpr int NM = 128;       // widest state
constexpr int FT = 256;       // forward threads: 8 warps, a 16-row strip of the chunk each
constexpr int PT = 64;        // head-dim tile of a forward CTA
constexpr int SSF = NM + 16;  // forward state row stride (floats): conflict-free 16-byte fragments
constexpr int BT = 256;       // backward threads: 8 warps
constexpr int PB = 64;        // widest head dim of one backward launch
constexpr int NH = NM / 2;    // state columns of a backward CTA
constexpr int SCB = NH + 8;   // backward row stride of C ([q][n]) and S ([p][n])
constexpr int SDB = PB + 4;   // backward row stride of dy ([q][p], f32)
constexpr int MAX_DEV = 64;   // devices tracked for the shared-memory attribute

constexpr int RS = 4;         // stages of a forward warp's ring of C: three 16-column groups in flight

struct FwdSmem {
  alignas(16) float S[PT * SSF];   // the incoming state of the chunk, [p][n]
  alignas(16) float Sn[PT * SSF];  // the chunk's own state st, staged by cp.async
  // each warp's ring of C: a stage holds, for row q0 + g then q0 + g + 8, each
  // lane's 4 columns of a 16-column group, [row][lane][4]; a lane reads back
  // only what it copied
  alignas(16) float ring[FT / 32][RS][2 * 32 * 4];
  float e[QM];                     // exp(cum_q)
  double wsum[QM / 32];
};

struct BwdSmem {
  alignas(16) float C[QM * SCB];   // the CTA's columns of C of the chunk, [q][n]
  alignas(16) float S[PB * SCB];   // and of its incoming state, [p][n]
  alignas(16) float D[QM * SDB];   // dy, [q][p] in f32
  float e[QM];
  float dcum[QM];                  // Σ_n C·dC over the CTA's columns
  float red[BT / 32];
  double wsum[QM / 32];
};

// Wait until at most n (0 ... RS - 1) of this thread's latest cp.async groups are in flight.
__device__ __forceinline__ void cp_wait_upto(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
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

// f32 values a and b at columns n, n + 1 of a row of N (n even): one 8-byte
// store where both lie in the row and `pair` holds (N even, base aligned).
__device__ __forceinline__ void store_pair(float* p, int n, int N, bool pair, float a, float b) {
  if (pair && n + 1 < N) {
    store2(p, a, b);
  } else {
    if (n < N) p[0] = a;
    if (n + 1 < N) p[1] = b;
  }
}

// hi = tf32(v) rounded to nearest, ties away, on the integer pipe (the bits
// of cvt.rna.tf32.f32 for finite v, off the slower conversion pipe, as B6's
// backward rounds); lo = v - hi, which the MMA truncates to TF32 itself.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi)));
}
__device__ __forceinline__ void split2(float v0, float v1, uint32_t* hi, uint32_t* lo) {
  split(v0, hi[0], lo[0]);
  split(v1, hi[1], lo[1]);
}
__device__ __forceinline__ void split4(const float* v, uint32_t* hi, uint32_t* lo) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(v[e], hi[e], lo[e]);
}
__device__ __forceinline__ void exact4(const float* v, uint32_t* a) {
#pragma unroll
  for (int e = 0; e < 4; ++e) a[e] = __float_as_uint(v[e]);
}

// Four independent sums d[i] += Σ_s a[s] · b[i][s] over a 16-deep group (two
// k-steps s), in split-precision TF32: a_lo·b_hi (when ALO), a_hi·b_lo and
// a_hi·b_hi. Each chain sums its six (or four) MMAs in a fresh accumulator
// that a rounded f32 add folds into d[i] (the tensor cores' own accumulation
// truncates), and the four chains' MMAs interleave: `asm volatile` keeps
// program order, so a chain written after another would wait on each MMA's
// result. ALO is false where a is exact in TF32 (a bf16 value, or a
// fragment whose low parts are all zero), and the product it skips is zero.
template <bool ALO>
__device__ __forceinline__ void mma_group4(float (*d)[4], const uint32_t (*ah)[4], const uint32_t (*al)[4],
                                           const uint32_t (*bh)[2][2], const uint32_t (*bl)[2][2]) {
  float t[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) t[i][e] = 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (ALO) {
#pragma unroll
      for (int i = 0; i < 4; ++i) mma(t[i], al[k], bh[i][k]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) mma(t[i], ah[k], bl[i][k]);
#pragma unroll
    for (int i = 0; i < 4; ++i) mma(t[i], ah[k], bh[i][k]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] = __fadd_rn(d[i][e], t[i][e]);
}

// Stage an R x Cn block of f32 (row stride gs floats in device memory) into
// shared memory (row stride ss) as rows [0, RP) x columns [0, CP), zeros
// outside the block; a null src stages zeros. cp.async: the caller commits
// and waits. vec: 16-byte copies (Cn and gs multiples of 4, src 16-byte
// aligned); CP a multiple of 4.
template <int NTH>
__device__ __forceinline__ void stage_f32(float* dst, int ss, const float* src, long long gs, int R,
                                          int Cn, int RP, int CP, bool vec, int tid) {
  if (src == nullptr) {
    for (int e = tid; e < RP * CP; e += NTH) dst[(e / CP) * ss + e % CP] = 0.f;
    return;
  }
  if (vec) {
    const int c4 = CP / 4;
    for (int e = tid; e < RP * c4; e += NTH) {
      const int r = e / c4, col = (e % c4) * 4;
      const bool ok = r < R && col < Cn;
      cp_async16(&dst[r * ss + col], ok ? src + r * gs + col : src, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < RP * CP; e += NTH) {
      const int r = e / CP, col = e % CP;
      const bool ok = r < R && col < Cn;
      cp_async4(&dst[r * ss + col], ok ? src + r * gs + col : src, ok ? 4 : 0);
    }
  }
}

// Write rows [0, R) x columns [0, N) of a shared [r][ss] tile to device
// memory (row stride N).
template <int NTH>
__device__ __forceinline__ void store_tile(float* dst, const float* src, int ss, int R, int N,
                                           bool vec, int tid) {
  if (vec) {
    const int n4 = N / 4;
    for (int e = tid; e < R * n4; e += NTH) {
      const int r = e / n4, col = (e % n4) * 4;
      *reinterpret_cast<float4*>(dst + (long long)r * N + col) =
          *reinterpret_cast<const float4*>(&src[r * ss + col]);
    }
  } else {
    for (int e = tid; e < R * N; e += NTH) dst[e] = src[(e / N) * ss + e % N];
  }
}

// A chunk's log-decay a_q for thread q < Q (a's row stride H floats), 0
// elsewhere: loaded a phase ahead of exp_cum, so that its latency hides.
__device__ __forceinline__ float chunk_a(const float* a, int H, int Q, int tid) {
  return tid < Q ? a[(long long)tid * H] : 0.f;
}

// e_q = exp(cum_q), cum the chunk's cumulative log-decay: the threads' a_q
// (chunk_a) summed in f64 by the first four warps, a shuffle scan each and
// then the warps' sums, and rounded to f32 once; e is 0 past Q. Every thread
// calls it; it holds one barrier, and the caller's next barrier publishes e.
__device__ __forceinline__ void exp_cum(float aq, int Q, float* e, double* wsum, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  double c = aq;
  if (tid < QM) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, c, o);
      if (lane >= o) c += u;
    }
    if (lane == 31) wsum[warp] = c;
  }
  __syncthreads();
  if (tid < QM) {
    for (int w = 0; w < warp; ++w) c += wsum[w];
    e[tid] = tid < Q ? expf((float)c) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(FT, 2) ssd_chain_fwd_kernel(
    const T* __restrict__ yi, const float* __restrict__ st, const float* __restrict__ total,
    const float* __restrict__ a, const float* __restrict__ Cm, const float* __restrict__ s0,
    T* __restrict__ y, float* __restrict__ fin, float* __restrict__ mid, int nc, int Q, int H,
    int P, int N, int ptiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row group and thread in group
  const long long bh = blockIdx.x / ptiles;  // b * H + h
  const int p0 = (int)(blockIdx.x % ptiles) * PT;
  const int h = (int)(bh % H);
  const long long b = bh / H;
  const int rows = min(PT, P - p0);     // state rows of this tile
  const int ntiles = (rows + 7) >> 3;   // 8-column tiles of y
  const int nk = (N + 15) & ~15;        // state columns the products run over
  const long long PN = (long long)P * N;
  const bool vec = (N & 3) == 0 && aligned16(st) && aligned16(Cm) && aligned16(fin) &&
                   (s0 == nullptr || aligned16(s0)) && (mid == nullptr || aligned16(mid));
  const bool ypair = (P & 1) == 0 && ((reinterpret_cast<uintptr_t>(yi) | reinterpret_cast<uintptr_t>(y)) &
                                      (2 * sizeof(T) - 1)) == 0;
  const int q0 = 16 * warp, qa = q0 + g, qb = qa + 8;

  // the incoming state of the first chunk: state0's tile, or zeros
  stage_f32<FT>(s.S, SSF, s0 ? s0 + bh * PN + (long long)p0 * N : nullptr, N, rows, N, PT, nk, vec, tid);
  cp_commit();
  cp_wait_all();  // each thread's copies; the loop's first barrier publishes them
  const int nj = nk / 16;  // 16-column groups of C
  float* ring = s.ring[warp][0];
  float aq = chunk_a(a + b * nc * Q * H + h, H, Q, tid);  // the first chunk's
  for (int c = 0; c < nc; ++c) {
    const long long bc = b * nc + c;
    const float tot = total[bc * H + h];  // read at the update
    stage_f32<FT>(s.Sn, SSF, st + (bc * H + h) * PN + (long long)p0 * N, N, rows, N, PT, nk, vec, tid);
    cp_commit();
    const float* ca = Cm + ((bc * Q + qa) * H + h) * (long long)N;
    const float* cb = Cm + ((bc * Q + qb) * H + h) * (long long)N;
    // group j of rows qa and qb into ring stage j % RS, this lane's columns 4t.. of it; zeros past Q and N
    auto issue = [&](int j) {
      float* sg = ring + (j % RS) * (2 * 32 * 4) + 4 * lane;
      const int n = 16 * j + 4 * t;
      if (vec) {
        const bool oka = qa < Q && n < N, okb = qb < Q && n < N;
        cp_async16(sg, oka ? ca + n : Cm, oka ? 16 : 0);
        cp_async16(sg + 128, okb ? cb + n : Cm, okb ? 16 : 0);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool oka = qa < Q && n + i < N, okb = qb < Q && n + i < N;
          cp_async4(sg + i, oka ? ca + n + i : Cm, oka ? 4 : 0);
          cp_async4(sg + 128 + i, okb ? cb + n + i : Cm, okb ? 4 : 0);
        }
      }
      cp_commit();
    };
    if (q0 < Q)
      for (int j = 0; j < min(RS - 1, nj); ++j) issue(j);  // in flight during the scan and the barrier
    exp_cum(aq, Q, s.e, s.wsum, tid);
    if (c + 1 < nc) aq = chunk_a(a + (bc + 1) * Q * H + h, H, Q, tid);  // lands during the products
    __syncthreads();  // e, and S (staged or updated), are in place
    if (mid != nullptr && c > 0)
      store_tile<FT>(mid + ((b * (nc - 1) + c - 1) * H + h) * PN + (long long)p0 * N, s.S, SSF, rows, N,
                     vec, tid);

    // ---- y of this warp's 16 rows: C (through the ring) · S_inᵀ ----
    if (q0 < Q) {
      // with bf16 y, this lane's pairs of y_intra land during the products
      constexpr bool YPRE = std::is_same<T, __nv_bfloat16>::value;
      uint32_t yin[YPRE ? 8 : 1][2];
      if (YPRE) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int q = rr ? qb : qa, p = p0 + 8 * nt + 2 * t;
            const T* src = yi + ((bc * Q + q) * H + h) * (long long)P + p;
            uint32_t v = 0;
            if (nt < ntiles && q < Q) {
              if (ypair && p + 1 < P) {
                v = *reinterpret_cast<const uint32_t*>(src);
              } else {
                const unsigned short* u = reinterpret_cast<const unsigned short*>(src);
                if (p < P) v = u[0];
                if (p + 1 < P) v |= (uint32_t)u[1] << 16;
              }
            }
            yin[YPRE ? nt : 0][rr] = v;
          }
      }
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 1
      for (int j = 0; j < nj; ++j) {
        cp_wait_upto(min(RS - 2, nj - 1 - j));  // group j has landed
        const float* sg = ring + (j % RS) * (2 * 32 * 4) + 4 * lane;
        const float4 va = *reinterpret_cast<const float4*>(sg);
        const float4 vb = *reinterpret_cast<const float4*>(sg + 128);
        if (j + RS - 1 < nj) issue(j + RS - 1);  // into the stage group j - 1 left
        uint32_t ah[2][4], al[2][4];
        {
          const float v0[4] = {va.x, vb.x, va.y, vb.y}, v1[4] = {va.z, vb.z, va.w, vb.w};
          split4(v0, ah[0], al[0]);
          split4(v1, ah[1], al[1]);
        }
        // C from bf16 (as the model makes it) is exact in TF32: its a_lo·b_hi pass is zero, skipped
        uint32_t any = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) any |= al[0][e] | al[1][e];
        const bool alo = __any_sync(0xffffffffu, any != 0);
        const int jc = 16 * j;
#pragma unroll
        for (int h4 = 0; h4 < 2; ++h4) {
          if (32 * h4 >= rows) break;
          uint32_t bhi[4][2][2], blo[4][2][2];  // n-tiles 4·h4 + i, k-steps s
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 w = *reinterpret_cast<const float4*>(&s.S[(32 * h4 + 8 * i + g) * SSF + jc + 4 * t]);
            split2(w.x, w.y, bhi[i][0], blo[i][0]);
            split2(w.z, w.w, bhi[i][1], blo[i][1]);
          }
          if (alo) mma_group4<true>(acc + 4 * h4, ah, al, bhi, blo);
          else mma_group4<false>(acc + 4 * h4, ah, al, bhi, blo);
        }
      }
      // y = round(y_intra + e ∘ (C · S_inᵀ))
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= ntiles) continue;
        const int p = p0 + 8 * nt + 2 * t;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int q = rr ? qb : qa;
          if (q >= Q) continue;
          const float eq = s.e[q];
          const long long off = ((bc * Q + q) * H + h) * (long long)P + p;
          const float v0 = __fmul_rn(acc[nt][2 * rr], eq), v1 = __fmul_rn(acc[nt][2 * rr + 1], eq);
          if (YPRE) {
            const uint32_t w = yin[YPRE ? nt : 0][rr];
            const float in0 = __uint_as_float(w << 16), in1 = __uint_as_float(w & 0xFFFF0000u);
            if (ypair && p + 1 < P) {
              store2(y + off, __fadd_rn(in0, v0), __fadd_rn(in1, v1));
            } else {
              if (p < P) store(y + off, __fadd_rn(in0, v0));
              if (p + 1 < P) store(y + off + 1, __fadd_rn(in1, v1));
            }
          } else if (ypair && p + 1 < P) {
            const float2 in = load2(yi + off);
            store2(y + off, __fadd_rn(in.x, v0), __fadd_rn(in.y, v1));
          } else {
            if (p < P) store(y + off, __fadd_rn(load(yi + off), v0));
            if (p + 1 < P) store(y + off + 1, __fadd_rn(load(yi + off + 1), v1));
          }
        }
      }
    }

    // ---- S_in ← S_in · exp(total) + st ----
    cp_wait_all();
    __syncthreads();  // every warp is done with S; st has landed
    const float d = expf(tot);
    for (int e = tid; e < PT * (nk / 4); e += FT) {
      const int r = e / (nk / 4), col = (e % (nk / 4)) * 4;
      float4* sp = reinterpret_cast<float4*>(&s.S[r * SSF + col]);
      const float4 u = *reinterpret_cast<const float4*>(&s.Sn[r * SSF + col]);
      float4 v = *sp;
      v.x = __fadd_rn(__fmul_rn(v.x, d), u.x);
      v.y = __fadd_rn(__fmul_rn(v.y, d), u.y);
      v.z = __fadd_rn(__fmul_rn(v.z, d), u.z);
      v.w = __fadd_rn(__fmul_rn(v.w, d), u.w);
      *sp = v;
    }
    __syncthreads();  // S is updated; Sn and e are free
  }
  store_tile<FT>(fin + bh * PN + (long long)p0 * N, s.S, SSF, rows, N, vec, tid);
}

// dy's [q][p] block of one chunk into shared memory as f32: rows [0, RP) x
// columns [0, CP), zeros past Q and P. vec: 4-element loads. Each thread's
// loads of a batch are all in flight before the first is stored.
template <typename T>
__device__ __forceinline__ void stage_dy(float* dst, const T* src, long long gs, int Q, int P, int RP,
                                         int CP, bool vec, int tid) {
  constexpr int BATCH = 8;
  const int c4 = CP / 4, total4 = RP * c4;
  for (int base = tid; base < total4; base += BT * BATCH) {
    float v[BATCH][4];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = base + u * BT, r = e / c4, col = (e % c4) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) v[u][i] = 0.f;
      if (e < total4 && r < Q) {
        const T* p = src + r * gs + col;
        if (vec && col < P) {
          load4(p, v[u]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (col + i < P) v[u][i] = load(p + i);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = base + u * BT, r = e / c4, col = (e % c4) * 4;
      if (e < total4) *reinterpret_cast<float4*>(&dst[r * SDB + col]) = make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(BT, 2) ssd_chain_bwd_kernel(
    const T* __restrict__ dy, const float* __restrict__ total, const float* __restrict__ a,
    const float* __restrict__ Cm, const float* __restrict__ mid, const float* __restrict__ s0,
    const float* __restrict__ dfin, float* __restrict__ dst, float* __restrict__ dtot,
    float* __restrict__ da, float* __restrict__ dC, float* __restrict__ ds0, int nc, int Q, int H,
    int P, int N, int halves) {
  constexpr bool XE = std::is_same<T, __nv_bfloat16>::value;  // dy exact in TF32
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& s = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int half = (int)(blockIdx.x % halves);
  const long long bh = blockIdx.x / halves;  // b * H + h
  const int h = (int)(bh % H);
  const long long b = bh / H;
  const int n0 = half * NH, Nh = min(NH, N - n0);  // this CTA's state columns
  const long long parts = (long long)gridDim.x / halves * nc;  // (b, chunk, head) rows of dtot
  float* dap = da + half * parts * Q;    // this half's share of da
  float* dtp = dtot + half * parts;      // and of dtotal
  const int q16 = (Q + 15) & ~15, p16 = (P + 15) & ~15;
  const int n32 = (Nh + 31) & ~31;  // staged columns: the products run over 32-column groups
  const long long PN = (long long)P * N;
  const bool vec = (N & 3) == 0 && aligned16(Cm) && (mid == nullptr || aligned16(mid)) &&
                   (s0 == nullptr || aligned16(s0));
  const bool pair = (N & 1) == 0;  // every f32 output is freshly allocated: 8-byte aligned
  const bool dvec = (P & 3) == 0 && (reinterpret_cast<uintptr_t>(dy) & (4 * sizeof(T) - 1)) == 0;
  // the gradient G of the state: a 16 x 32 tile a warp (rows ps.., columns nq.. of this half)
  const int ps = 16 * (warp & 3), nq = 32 * (warp >> 2);
  const bool g_on = ps < P && nq < Nh;
  // dy · S_in: a 16 x 64 tile a warp (rows qs.. of the chunk, this half's columns)
  const int qs = 16 * warp;
  auto state_src = [&](int c) -> const float* {
    if (c > 0) return mid + ((b * (nc - 1) + c - 1) * H + h) * PN + n0;
    return s0 ? s0 + bh * PN + n0 : nullptr;
  };

  float G[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = ps + g + 8 * (e >> 1), n = nq + 8 * nt + 2 * t + (e & 1);
      G[nt][e] = (dfin != nullptr && g_on && p < P && n < Nh) ? dfin[bh * PN + (long long)p * N + n0 + n] : 0.f;
    }

  stage_f32<BT>(s.S, SCB, state_src(nc - 1), N, P, Nh, p16, n32, vec, tid);
  float aq = chunk_a(a + ((b * nc + nc - 1) * Q) * H + h, H, Q, tid);  // the last chunk's
  for (int c = nc - 1; c >= 0; --c) {
    const long long bc = b * nc + c;
    const float tot = total[bc * H + h];  // read after the first product
    stage_f32<BT>(s.C, SCB, Cm + (bc * Q * H + h) * (long long)N + n0, (long long)H * N, Q, Nh, q16, n32, vec,
                  tid);
    cp_commit();
    stage_dy<T>(s.D, dy + (bc * Q * H + h) * (long long)P, (long long)H * P, Q, P, q16, p16, dvec, tid);
    exp_cum(aq, Q, s.e, s.wsum, tid);
    if (c > 0) aq = chunk_a(a + (bc - 1) * Q * H + h, H, Q, tid);  // the next chunk's, during the products
    cp_wait_all();
    __syncthreads();  // C, S, dy and e are in place

    // ---- dC = e ∘ (dy · S_in), and Σ_n C·dC over this half's columns ----
    if (qs < Q) {
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 1
      for (int k0 = 0; k0 < p16; k0 += 16) {  // dy and S are zero past P
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float* d0 = s.D + (qs + g) * SDB + k0 + 8 * k + t;
          const float av[4] = {d0[0], d0[8 * SDB], d0[4], d0[8 * SDB + 4]};
          if (XE) exact4(av, ah[k]);
          else split4(av, ah[k], al[k]);
        }
#pragma unroll
        for (int h4 = 0; h4 < 2; ++h4) {
          if (32 * h4 >= Nh) break;
          uint32_t bhi[4][2][2], blo[4][2][2];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const float* sr = s.S + (k0 + 8 * k + t) * SCB + 32 * h4 + 8 * i + g;
              split2(sr[0], sr[4 * SCB], bhi[i][k], blo[i][k]);
            }
          mma_group4<!XE>(acc + 4 * h4, ah, al, bhi, blo);
        }
      }
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = 8 * nt + 2 * t;
        if (8 * nt >= Nh) continue;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int q = qs + g + 8 * rr;
          if (q >= Q) continue;
          const float eq = s.e[q];
          const float v0 = __fmul_rn(acc[nt][2 * rr], eq), v1 = __fmul_rn(acc[nt][2 * rr + 1], eq);
          store_pair(dC + ((bc * Q + q) * H + h) * (long long)N + n0 + n, n, Nh, pair, v0, v1);
          const float2 cc = *reinterpret_cast<const float2*>(&s.C[q * SCB + n]);
          part[rr] = fmaf(cc.x, v0, fmaf(cc.y, v1, part[rr]));
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        part[rr] += __shfl_xor_sync(0xffffffffu, part[rr], 1);
        part[rr] += __shfl_xor_sync(0xffffffffu, part[rr], 2);
        const int q = qs + g + 8 * rr;
        if (t == 0 && q < Q) s.dcum[q] = part[rr];
      }
    }

    // ---- dst = G, and this warp's share of Σ G ∘ S_in ----
    {
      float part = 0.f;
      if (g_on) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nq + 8 * nt >= Nh) continue;
          const int n = nq + 8 * nt + 2 * t;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int p = ps + g + 8 * rr;
            const float2 sv = *reinterpret_cast<const float2*>(&s.S[p * SCB + n]);
            part = fmaf(G[nt][2 * rr], sv.x, fmaf(G[nt][2 * rr + 1], sv.y, part));
            if (p < P) store_pair(dst + ((bc * H + h) * (long long)P + p) * N + n0 + n, n, Nh, pair,
                                  G[nt][2 * rr], G[nt][2 * rr + 1]);
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) s.red[warp] = part;
    }
    __syncthreads();  // dcum and the warps' sums are in; S is free

    const float d = expf(tot);
    if (tid == 0) {
      float sum = 0.f;
      for (int w = 0; w < BT / 32; ++w) sum += s.red[w];
      dtp[bc * H + h] = __fmul_rn(d, sum);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) G[nt][e] = __fmul_rn(G[nt][e], d);
    if (c > 0) {  // the next chunk's incoming state lands during this chunk's second product
      stage_f32<BT>(s.S, SCB, state_src(c - 1), N, P, Nh, p16, n32, vec, tid);
      cp_commit();
    }

    // ---- this half's share of da: the reverse cumsum of dcum, in f64; lane l holds q = 4l .. 4l + 3 ----
    if (warp == 0) {
      double v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = 4 * lane + i;
        v[i] = q < Q ? (double)s.dcum[q] : 0.0;
      }
      v[2] += v[3];
      v[1] += v[2];
      v[0] += v[1];
      double tot = v[0];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_down_sync(0xffffffffu, tot, o);
        if (lane + o < 32) tot += u;
      }
      const double above = tot - v[0];  // the lanes past this one
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = 4 * lane + i;
        if (q < Q) dap[(bc * Q + q) * H + h] = (float)(above + v[i]);
      }
    }

    // ---- G += Σ_q e_q dy_qᵀ C_q ----
    if (g_on) {
#pragma unroll 1
      for (int k0 = 0; k0 < q16; k0 += 16) {  // dy, C and e are zero past Q
        uint32_t ah[2][4], al[2][4], bhi[4][2][2], blo[4][2][2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int q = k0 + 8 * k + t;
          const float* d0 = s.D + q * SDB + ps + g;
          const float av[4] = {d0[0], d0[8], d0[4 * SDB], d0[4 * SDB + 8]};
          if (XE) exact4(av, ah[k]);
          else split4(av, ah[k], al[k]);
          const float e0 = s.e[q], e1 = s.e[q + 4];
          const float* cr = s.C + q * SCB + nq + g;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split2(__fmul_rn(e0, cr[8 * i]), __fmul_rn(e1, cr[4 * SCB + 8 * i]), bhi[i][k], blo[i][k]);
        }
        mma_group4<!XE>(G, ah, al, bhi, blo);
      }
    }
    __syncthreads();  // C, dy, e and dcum are free for the next chunk
  }
  if (ds0 != nullptr && g_on) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nq + 8 * nt >= Nh) continue;
      const int n = nq + 8 * nt + 2 * t;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int p = ps + g + 8 * rr;
        if (p < P) store_pair(ds0 + bh * PN + (long long)p * N + n0 + n, n, Nh, pair, G[nt][2 * rr],
                              G[nt][2 * rr + 1]);
      }
    }
  }
}

// Set a kernel's shared-memory attributes once for each device.
template <class K>
int prepare(K kernel, int bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEV) return (int)cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << dev;
  if (done.load(std::memory_order_acquire) & bit) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  done.fetch_or(bit, std::memory_order_acq_rel);
  return 0;
}

template <typename T>
int launch_fwd(const void* yi, const void* st, const void* total, const void* a, const void* C,
               const void* s0, void* y, void* fin, void* mid, int Bb, int nc, int Q, int H, int P, int N,
               cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  const int rc = prepare(ssd_chain_fwd_kernel<T>, (int)sizeof(FwdSmem), done);
  if (rc != 0) return rc;
  const int ptiles = (P + PT - 1) / PT;
  const long long ctas = (long long)Bb * H * ptiles;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssd_chain_fwd_kernel<T><<<(unsigned)ctas, FT, sizeof(FwdSmem), stream>>>(
      (const T*)yi, (const float*)st, (const float*)total, (const float*)a, (const float*)C,
      (const float*)s0, (T*)y, (float*)fin, (float*)mid, nc, Q, H, P, N, ptiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* dy, const void* total, const void* a, const void* C, const void* mid,
               const void* s0, const void* dfin, void* dst, void* dtot, void* da, void* dC, void* ds0,
               int Bb, int nc, int Q, int H, int P, int N, cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  const int rc = prepare(ssd_chain_bwd_kernel<T>, (int)sizeof(BwdSmem), done);
  if (rc != 0) return rc;
  const int halves = (N + NH - 1) / NH;
  const long long ctas = (long long)Bb * H * halves;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssd_chain_bwd_kernel<T><<<(unsigned)ctas, BT, sizeof(BwdSmem), stream>>>(
      (const T*)dy, (const float*)total, (const float*)a, (const float*)C, (const float*)mid,
      (const float*)s0, (const float*)dfin, (float*)dst, (float*)dtot, (float*)da, (float*)dC,
      (float*)ds0, nc, Q, H, P, N, halves);
  return (int)cudaGetLastError();
}

}  // namespace

// y_intra, y: (Bb, nc, Q, H, P) f32, or bf16 when x_bf16; st: (Bb, nc, H, P, N)
// f32; total: (Bb, nc, H) f32; a: (Bb, nc, Q, H) f32; C: (Bb, nc, Q, H, N)
// f32; s0 (may be null) and fin: (Bb, H, P, N) f32; mid (may be null):
// (Bb, nc - 1, H, P, N) f32, the incoming state of chunks 1 ... nc - 1. All
// contiguous; 1 <= Q <= 128, 1 <= N <= 128. Returns a cudaError_t (0 on a
// clean launch).
extern "C" int ssd_chain_fwd_launch(const void* yi, int x_bf16, const void* st, const void* total,
                                    const void* a, const void* C, const void* s0, void* y, void* fin,
                                    void* mid, int Bb, int nc, int Q, int H, int P, int N, void* stream) {
  if (Q < 1 || Q > QM || N < 1 || N > NM || H < 1 || P < 1 || Bb < 0 || nc < 1)
    return (int)cudaErrorInvalidValue;
  if (Bb == 0) return 0;
  if (x_bf16)
    return launch_fwd<__nv_bfloat16>(yi, st, total, a, C, s0, y, fin, mid, Bb, nc, Q, H, P, N,
                                     (cudaStream_t)stream);
  return launch_fwd<float>(yi, st, total, a, C, s0, y, fin, mid, Bb, nc, Q, H, P, N, (cudaStream_t)stream);
}

// dy: (Bb, nc, Q, H, P) f32, or bf16 when x_bf16; total, a, C, mid and s0 as
// the forward's; dfin (may be null) and ds0 (may be null): (Bb, H, P, N) f32;
// dst: (Bb, nc, H, P, N), dC: (Bb, nc, Q, H, N); dtot: (halves, Bb, nc, H)
// and da: (halves, Bb, nc, Q, H), each half of the state columns' share
// (halves = ceil(N / 64)), all f32. All contiguous; 1 <= Q <= 128,
// 1 <= P <= 64, 1 <= N <= 128. Returns a cudaError_t.
extern "C" int ssd_chain_bwd_launch(const void* dy, int x_bf16, const void* total, const void* a,
                                    const void* C, const void* mid, const void* s0, const void* dfin,
                                    void* dst, void* dtot, void* da, void* dC, void* ds0, int Bb, int nc,
                                    int Q, int H, int P, int N, void* stream) {
  if (Q < 1 || Q > QM || N < 1 || N > NM || P < 1 || P > PB || H < 1 || Bb < 0 || nc < 1)
    return (int)cudaErrorInvalidValue;
  if (Bb == 0) return 0;
  if (x_bf16)
    return launch_bwd<__nv_bfloat16>(dy, total, a, C, mid, s0, dfin, dst, dtot, da, dC, ds0, Bb, nc, Q,
                                     H, P, N, (cudaStream_t)stream);
  return launch_bwd<float>(dy, total, a, C, mid, s0, dfin, dst, dtot, da, dC, ds0, Bb, nc, Q, H, P, N,
                           (cudaStream_t)stream);
}

extern "C" int ssd_chain_fwd_smem_bytes() { return (int)sizeof(FwdSmem); }
extern "C" int ssd_chain_bwd_smem_bytes() { return (int)sizeof(BwdSmem); }
extern "C" int ssd_chain_bwd_halves(int N) { return (N + NH - 1) / NH; }
extern "C" const char* ssd_chain_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
