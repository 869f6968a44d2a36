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
// Design: the TPU grid step holds all H heads of a chunk in VMEM (~6 MiB);
// here one CTA owns one (b, c, h) and keeps M (Q x Q) and x·dt (Q x 64) in
// shared memory, while C and B stream through in 32-deep slices. Each of
// the three products is a register-tiled f32 FMA loop over shared memory
// (8x8, 8x4 and 4x8 outputs a thread). All arithmetic is f32 without tensor
// cores: the port is held to 1e-5 on y and 1e-4 on the state, which TF32
// or bf16 products would miss. `cum` is summed and differenced in f64 and
// only cum_i - cum_j rounded to f32: a chunk's log-decay reaches hundreds
// at Q = 128, and differences of f32 sums that large lose ~1e-4 of L. The
// causal mask is a select, never a product: for j > i, cum_i - cum_j >= 0
// and exp may overflow to +inf.
// Tiles of M above the diagonal and rows past Q are skipped, so a decode
// step (Q = 1) costs one tile per CTA.
//
// Bound on the H100 at the serving prefill shape (B 8, nc 4, Q 128, H 32,
// P 64, N 128): the products are causal, so C·Bᵀ and M·(x·dt) need only
// the Q(Q+1)/2 entries on and below the diagonal: Q(Q+1)N + Q(Q+1)P + 2QNP
// = 5.3 MFLOP per CTA, 5.4 GFLOP per launch, 0.08 ms at 67 TFLOP/s f32;
// ~200 MB moved (B and C arrive pre-broadcast over the heads in f32),
// 0.06 ms at 3.35 TB/s. So it is bound by operations; chip_smoke.py
// computes both from the shapes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;     // threads a CTA: a 16 x 16 grid of register tiles
constexpr int QM = 128;     // longest chunk a CTA holds
constexpr int PT = 64;      // head-dim tile of y and the state
constexpr int NTL = 128;    // state-size tile of the state
constexpr int KC = 32;      // depth of one staged slice (n for C·Bᵀ, q for the state)
constexpr int LS = QM + 4;  // row stride (floats) of the transposed tiles

struct Smem {
  double cum[QM];  // f64: L takes differences of sums that reach hundreds
  float g[QM];     // exp(total - cum_q)
  float dt[QM];
  float Mt[QM * LS];  // Mt[j * LS + i] = M[i][j]
  float X[QM * PT];   // x_q · dt_q for one head-dim tile
  union {
    struct {
      float Ct[KC * LS];  // Ct[k * LS + q] = C[q][n0 + k]
      float Bt[KC * LS];
    } cb;
    float Bg[KC * NTL];  // Bg[q * NTL + n] = B[q0 + q][n0 + n] · g[q0 + q]
  } u;
  double wsum[QM / 32];
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void unpack8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(NT) ssd_intra_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const float* __restrict__ Bm, const float* __restrict__ Cm, T* __restrict__ y,
    float* __restrict__ st, float* __restrict__ total, int Q, int H, int P, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int h = blockIdx.x % H;
  const long long bc = blockIdx.x / H;  // b * nc + c
  const long long row0 = bc * Q;        // row (b, c, q = 0) of the (.., Q, H, ..) tensors

  // ---- cum = cumsum(a) in f64: a shuffle scan per warp, then the warps' sums ----
  if (tid < QM) {
    double c = tid < Q ? (double)a[(row0 + tid) * H + h] : 0.0;
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, c, o);
      if ((tid & 31) >= o) c += u;
    }
    s.cum[tid] = c;
    if ((tid & 31) == 31) s.wsum[tid >> 5] = c;
    s.dt[tid] = tid < Q ? dt[(row0 + tid) * H + h] : 0.f;
  }
  __syncthreads();
  if (tid < QM) {
    double c = s.cum[tid];
    for (int w = 0; w < (tid >> 5); ++w) c += s.wsum[w];
    s.cum[tid] = c;
  }
  __syncthreads();
  const double tot = s.cum[Q - 1];
  if (tid < QM) s.g[tid] = tid < Q ? expf((float)(tot - s.cum[tid])) : 0.f;
  if (tid == 0) total[bc * H + h] = (float)tot;

  // ---- M = (C · Bᵀ) ∘ L: thread tile rows i0..i0+7, cols j0..j0+7 ----
  const int ty = tid / 16, tx = tid % 16;
  const int i0 = ty * 8, j0 = tx * 8;
  const bool live = i0 < Q && j0 < Q && j0 <= i0 + 7;  // meets the causal triangle
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  for (int n0 = 0; n0 < N; n0 += KC) {
    __syncthreads();  // the previous slice is consumed
    for (int e = tid; e < KC * QM; e += NT) {
      const int k = e % KC, q = e / KC, n = n0 + k;
      const bool ok = q < Q && n < N;
      const long long gi = ((row0 + q) * H + h) * (long long)N + n;
      s.u.cb.Ct[k * LS + q] = ok ? Cm[gi] : 0.f;
      s.u.cb.Bt[k * LS + q] = ok ? Bm[gi] : 0.f;
    }
    __syncthreads();
    if (live) {
      for (int k = 0; k < KC; ++k) {
        float ci[8], bj[8];
        unpack8(&s.u.cb.Ct[k * LS + i0], ci);
        unpack8(&s.u.cb.Bt[k * LS + j0], bj);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(ci[r], bj[c], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int j = j0 + c;
    float m[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + r;
      // select, never multiply: exp(cum_i - cum_j) may be +inf where j > i
      m[r] = (live && i < Q && j <= i) ? acc[r][c] * expf((float)(s.cum[i] - s.cum[j])) : 0.f;
    }
    *reinterpret_cast<float4*>(&s.Mt[j * LS + i0]) = make_float4(m[0], m[1], m[2], m[3]);
    *reinterpret_cast<float4*>(&s.Mt[j * LS + i0 + 4]) = make_float4(m[4], m[5], m[6], m[7]);
  }

  for (int p0 = 0; p0 < P; p0 += PT) {
    __syncthreads();  // Mt written; the previous tile's X and Bg consumed
    for (int e = tid; e < QM * PT; e += NT) {
      const int p = e % PT, q = e / PT;
      const bool ok = q < Q && p0 + p < P;
      s.X[e] = ok ? load(x + ((row0 + q) * H + h) * (long long)P + p0 + p) * s.dt[q] : 0.f;
    }
    __syncthreads();

    // ---- y = M · X: thread tile rows i0..i0+7, cols pc..pc+3 ----
    {
      const int pc = tx * 4;
      float ya[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) ya[r][c] = 0.f;
      const int jend = i0 < Q ? min(Q, i0 + 8) : 0;  // M[i][j] = 0 for j > i
      for (int j = 0; j < jend; ++j) {
        float mi[8];
        unpack8(&s.Mt[j * LS + i0], mi);
        const float4 xv = *reinterpret_cast<const float4*>(&s.X[j * PT + pc]);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) ya[r][c] = fmaf(mi[r], xs[c], ya[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = i0 + r;
        if (i >= Q) continue;
        T* yr = y + ((row0 + i) * H + h) * (long long)P;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = p0 + pc + c;
          if (p < P) store(yr + p, ya[r][c]);
        }
      }
    }

    // ---- st = Xᵀ · (B ∘ g): thread tile rows pr..pr+3, cols nc0..nc0+7 ----
    const int pr = ty * 4, nc0 = tx * 8;
    for (int n0 = 0; n0 < N; n0 += NTL) {
      float sa[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) sa[r][c] = 0.f;
      for (int q0 = 0; q0 < Q; q0 += KC) {
        __syncthreads();  // Bg (or the C·Bᵀ slices sharing its memory) is free
        for (int e = tid; e < KC * NTL; e += NT) {
          const int n = e % NTL, q = e / NTL;
          const bool ok = q0 + q < Q && n0 + n < N;
          s.u.Bg[e] = ok ? Bm[((row0 + q0 + q) * H + h) * (long long)N + n0 + n] * s.g[q0 + q] : 0.f;
        }
        __syncthreads();
        const int qn = min(KC, Q - q0);
        for (int q = 0; q < qn; ++q) {
          const float4 xv = *reinterpret_cast<const float4*>(&s.X[(q0 + q) * PT + pr]);
          const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
          float bn[8];
          unpack8(&s.u.Bg[q * NTL + nc0], bn);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) sa[r][c] = fmaf(xs[r], bn[c], sa[r][c]);
        }
      }
      float* sr = st + (bc * H + h) * (long long)P * N;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = p0 + pr + r;
        if (p >= P) continue;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = n0 + nc0 + c;
          if (n < N) sr[(long long)p * N + n] = sa[r][c];
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* B, const void* C, void* y,
           void* st, void* total, long long ctas, int Q, int H, int P, int N,
           cudaStream_t stream) {
  const int bytes = (int)sizeof(Smem);
  cudaError_t e = cudaFuncSetAttribute(ssd_intra_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  ssd_intra_kernel<T><<<(unsigned)ctas, NT, bytes, stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const float*)B, (const float*)C, (T*)y,
      (float*)st, (float*)total, Q, H, P, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (Bb, nc, Q, H, P) f32, or bf16 when x_bf16; dt, a: (Bb, nc, Q, H) f32;
// B, C: (Bb, nc, Q, H, N) f32; st: (Bb, nc, H, P, N) f32; total: (Bb, nc, H) f32.
// All contiguous. Returns a cudaError_t (0 on a clean launch).
extern "C" int ssd_intra_launch(const void* x, int x_bf16, const void* dt, const void* a,
                                const void* B, const void* C, void* y, void* st, void* total,
                                int Bb, int nc, int Q, int H, int P, int N, void* stream) {
  if (Q < 1 || Q > QM || H < 1 || P < 1 || N < 1 || Bb < 0 || nc < 0)
    return (int)cudaErrorInvalidValue;
  const long long ctas = (long long)Bb * nc * H;
  if (ctas == 0) return 0;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (x_bf16)
    return launch<__nv_bfloat16>(x, dt, a, B, C, y, st, total, ctas, Q, H, P, N,
                                 (cudaStream_t)stream);
  return launch<float>(x, dt, a, B, C, y, st, total, ctas, Q, H, P, N, (cudaStream_t)stream);
}

extern "C" const char* ssd_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
