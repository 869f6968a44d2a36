// Gradient of the Mamba2 SSD intra-chunk block (B6 backward).
//
// No TPU twin: the JAX package differentiates its plain `ssd_chunked`
// (src/repro/models/ssm.py) with jax.grad; this kernel computes the same
// function for the block that ssd_chunk.cu computes forward. Per (batch b,
// chunk c, head h), with a = dt·A, cum = cumsum(a) (f64), total = cum[Q-1],
// L[i,j] = exp(cum_i - cum_j)·[i >= j], u_j = x_j·dt_j, M = (C·Bᵀ)∘L,
// g_q = exp(total - cum_q), w_q = dt_q·g_q, and the incoming gradients
// dy (Q, P), dst (P, N) and dtotal:
//   dM   = (dy·uᵀ)∘[i >= j]          du = Mᵀ·dy
//   sB_q = dst·B_q                    dw_q = x_q·sB_q
//   dx   = du·dt + w·sB               ddt  = Σ_P du∘x + g·dw
//   dC   = (dM∘L)·B                   dB   = (dM∘L)ᵀ·C + w·(dstᵀ·x)
//   G    = dM∘M      dcum_i = Σ_j G[i,j] - Σ_k G[k,i] - dw_i·w_i
//                    dcum_{Q-1} += dtotal + Σ_q dw_q·w_q
//   da   = reverse_cumsum(dcum)       (f64)
// The gradient of dt through a = dt·A, and of A, is left to autograd
// (kernels/ops.py `ssd` builds a outside the kernel).
//
// Design: one CTA of 8 warps per (b, c, h), ~195 KB of shared memory (one
// CTA an SM). The Q x Q tiles M and dS = dM∘L live in shared memory for the
// whole launch; every operand read from device memory (x, dy, B, C, dst)
// passes through 32-column slices staged in shared memory (rows past Q and
// columns past P or N are zeros), so P and N take any size. Five phases:
//   1. a, dt -> cum (f64, one thread), g, w;
//   2. S = C·Bᵀ over N-slices, 8 x 8 outputs a thread; M = S∘L kept;
//   3. dM = (dy·uᵀ) over P-slices, 8 x 8 a thread; dS = dM∘L kept, and the
//      row and column sums of G = dM∘M reduced by warp shuffles and a
//      fixed-order pass over 8 per-warp partials (no atomics);
//   4. per 32-wide head-dim slice: du = Mᵀ·dy and sB = B·dstᵀ (over
//      N-slices), then dx, and per row ddt and dw (shuffle-reduced);
//      then dcum and da (f64, one thread);
//   5. per 32-wide state slice: dC = dS·B, dSᵀ·C, and dstᵀ·x over P-slices,
//      giving dB.
// All arithmetic is f32 FMAs (SIMT) but cum and the reverse sum. No atomics:
// two launches give the same bits. Products over Q x Q run on the whole
// tile (the causal half is zeros), twice the causal work.
//
// Bound on the H100 at the training shape (B 8, nc 4, Q 128, H 32, P 64,
// N 128, bf16 x): x, dt, a, B, C, dy, dst, dtotal read once and dx, ddt,
// da, dB, dC written once, ~0.34 GB, 0.10 ms at 3.35 TB/s; the causal work
// 3Q(Q+1)N + 2Q(Q+1)P + 4QNP f32 operations a (b, c, h), ~15 GOP, 0.22 ms at
// the 67 TFLOP/s f32 SIMT rate: bound by operations. chip_smoke.py computes
// both from the shapes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int NT = 256;      // threads a CTA: 8 warps
constexpr int NW = NT / 32;  // warps a CTA
constexpr int QM = 128;      // longest chunk a CTA holds
constexpr int KT = 32;       // width of a staged column slice
constexpr int TS = KT + 1;   // row stride of a staged slice (floats): no bank conflicts
constexpr int MS = QM + 1;   // row stride of a Q x Q tile
constexpr int MAX_DEV = 64;

struct Smem {
  double cum[QM];
  float M[QM * MS];   // M = (C·Bᵀ)∘L, rows i, columns j
  float D[QM * MS];   // dS = dM∘L
  float tA[QM * TS];  // staged slices of Q rows
  float tB[QM * TS];
  float tC[QM * TS];
  float tD[KT * TS];  // a 32 x 32 tile of dst
  float dt[QM], g[QM], w[QM], dw[QM], rowG[QM], dcum[QM];
  float colG[NW][QM];  // per-warp column sums of G
};

template <typename T>
__device__ __forceinline__ float ld(const T* p);
template <>
__device__ __forceinline__ float ld<float>(const float* p) { return __ldg(p); }
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T cvt(float v);
template <>
__device__ __forceinline__ float cvt<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Stage columns [k0, k0 + KT) of the Q rows at base + q·rs into t (QM rows
// of stride TS), each row times scale[q] when scale is given; zeros past Q
// and past K.
template <typename T>
__device__ void stage_rows(float* t, const T* base, long long rs, int Q, int k0, int K,
                           const float* scale) {
  for (int e = threadIdx.x; e < QM * KT; e += NT) {
    const int q = e / KT, k = e % KT;
    float v = 0.f;
    if (q < Q && k0 + k < K) {
      v = ld(base + q * rs + k0 + k);
      if (scale) v *= scale[q];
    }
    t[q * TS + k] = v;
  }
}

// Stage dst[p0 + r][n0 + k] (P x N, row-major) for r, k < KT; zeros outside.
__device__ void stage_dst(float* t, const float* dst, int P, int N, int p0, int n0) {
  for (int e = threadIdx.x; e < KT * KT; e += NT) {
    const int r = e / KT, k = e % KT;
    t[r * TS + k] = (p0 + r < P && n0 + k < N) ? __ldg(dst + (long long)(p0 + r) * N + n0 + k) : 0.f;
  }
}

// acc[r][c] += Σ_k ta[i_r][k]·tb[j_c][k] over one staged slice, with
// i_r = ty + 16r and j_c = tx + 16c (a QM x QM product, 8 x 8 a thread).
__device__ __forceinline__ void qq_slice(float (&acc)[8][8], const float* ta, const float* tb,
                                         int tx, int ty) {
#pragma unroll 4
  for (int k = 0; k < KT; ++k) {
    float av[8], bv[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) av[r] = ta[(ty + 16 * r) * TS + k];
#pragma unroll
    for (int c = 0; c < 8; ++c) bv[c] = tb[(tx + 16 * c) * TS + k];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

__device__ __forceinline__ float lmask(const Smem& s, int i, int j) {
  return expf((float)(s.cum[i] - s.cum[j]));
}

// Sum over the 2^m lanes of a group of 2^m consecutive lanes.
template <int GROUP>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = GROUP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(NT, 1) ssd_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const float* __restrict__ B, const float* __restrict__ C, const T* __restrict__ dy,
    const float* __restrict__ dst, const float* __restrict__ dtotal, T* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ da, float* __restrict__ dB,
    float* __restrict__ dC, int Q, int H, int P, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long cta = blockIdx.x;
  const long long bc = cta / H;
  const int h = (int)(cta % H);
  const long long row0 = bc * Q * H + h;  // (b, c, q = 0, h) in (B, nc, Q, H)
  const long long xrs = (long long)H * P, nrs = (long long)H * N;
  const T* xb = x + row0 * P;
  const T* dyb = dy + row0 * P;
  const float* Bb = B + row0 * N;
  const float* Cb = C + row0 * N;
  const float* dstb = dst + cta * P * N;

  // 1. cum (f64), dt, g = exp(total - cum), w = dt·g
  for (int q = tid; q < QM; q += NT) {
    s.dt[q] = q < Q ? __ldg(dt + row0 + (long long)q * H) : 0.f;
    s.cum[q] = q < Q ? (double)__ldg(a + row0 + (long long)q * H) : 0.0;
  }
  __syncthreads();
  if (tid == 0) {
    double run = 0.0;
    for (int q = 0; q < Q; ++q) {
      run += s.cum[q];
      s.cum[q] = run;
    }
  }
  __syncthreads();
  const double total = s.cum[Q - 1];
  for (int q = tid; q < QM; q += NT) {
    const float g = q < Q ? expf((float)(total - s.cum[q])) : 0.f;
    s.g[q] = g;
    s.w[q] = s.dt[q] * g;
  }

  // 2. M = (C·Bᵀ)∘L
  const int tx = tid & 15, ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  for (int n0 = 0; n0 < N; n0 += KT) {
    __syncthreads();
    stage_rows(s.tA, Cb, nrs, Q, n0, N, nullptr);
    stage_rows(s.tB, Bb, nrs, Q, n0, N, nullptr);
    __syncthreads();
    qq_slice(acc, s.tA, s.tB, tx, ty);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = tx + 16 * c;
      s.M[i * MS + j] = (i < Q && j <= i) ? acc[r][c] * lmask(s, i, j) : 0.f;
      acc[r][c] = 0.f;
    }
  }

  // 3. dM = (dy·uᵀ)∘[i >= j]; dS = dM∘L; row and column sums of G = dM∘M
  for (int p0 = 0; p0 < P; p0 += KT) {
    __syncthreads();
    stage_rows(s.tA, dyb, xrs, Q, p0, P, nullptr);
    stage_rows(s.tB, xb, xrs, Q, p0, P, s.dt);
    __syncthreads();
    qq_slice(acc, s.tA, s.tB, tx, ty);
  }
  {
    float colp[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) colp[c] = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      float rowp = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = tx + 16 * c;
        float dS = 0.f, G = 0.f;
        if (i < Q && j <= i) {
          const float dm = acc[r][c];
          G = dm * s.M[i * MS + j];
          dS = dm * lmask(s, i, j);
        }
        s.D[i * MS + j] = dS;
        rowp += G;
        colp[c] += G;
      }
      rowp = group_sum<16>(rowp);  // the 16 lanes of this half-warp hold row i
      if (tx == 0) s.rowG[i] = rowp;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float v = colp[c] + __shfl_xor_sync(0xffffffffu, colp[c], 16);
      if (lane < 16) s.colG[warp][tx + 16 * c] = v;
    }
  }
  __syncthreads();
  for (int q = tid; q < QM; q += NT) {
    float col = 0.f;
#pragma unroll
    for (int v = 0; v < NW; ++v) col += s.colG[v][q];
    s.dcum[q] = s.rowG[q] - col;
  }

  // 4. per head-dim slice: du = Mᵀ·dy, sB = B·dstᵀ; dx, ddt and dw
  const int ux = tid & 7, uy = tid >> 3;  // outputs (uy + 32r, ux + 8c), 4 x 4 a thread
  float ddt_p[4] = {0.f, 0.f, 0.f, 0.f}, dw_p[4] = {0.f, 0.f, 0.f, 0.f};
  for (int p0 = 0; p0 < P; p0 += KT) {
    float du[4][4], sb[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) du[r][c] = sb[r][c] = 0.f;
    __syncthreads();
    stage_rows(s.tA, dyb, xrs, Q, p0, P, nullptr);
    stage_rows(s.tC, xb, xrs, Q, p0, P, nullptr);
    __syncthreads();
    for (int i = 0; i < Q; ++i) {
      float mv[4], dv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) mv[r] = s.M[i * MS + uy + 32 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) dv[c] = s.tA[i * TS + ux + 8 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) du[r][c] = fmaf(mv[r], dv[c], du[r][c]);
    }
    for (int n0 = 0; n0 < N; n0 += KT) {
      __syncthreads();
      stage_rows(s.tB, Bb, nrs, Q, n0, N, nullptr);
      stage_dst(s.tD, dstb, P, N, p0, n0);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KT; ++k) {
        float bv[4], dv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) bv[r] = s.tB[(uy + 32 * r) * TS + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) dv[c] = s.tD[(ux + 8 * c) * TS + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sb[r][c] = fmaf(bv[r], dv[c], sb[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = uy + 32 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = p0 + ux + 8 * c;
        const float xv = s.tC[j * TS + ux + 8 * c];
        if (j < Q && p < P) dx[(row0 + (long long)j * H) * P + p] = cvt<T>(du[r][c] * s.dt[j] + s.w[j] * sb[r][c]);
        ddt_p[r] = fmaf(du[r][c], xv, ddt_p[r]);
        dw_p[r] = fmaf(xv, sb[r][c], dw_p[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = uy + 32 * r;
    const float dwj = group_sum<8>(dw_p[r]);  // the 8 lanes of this group hold row j
    const float dtj = group_sum<8>(ddt_p[r]);
    if (ux == 0 && j < Q) {
      s.dw[j] = dwj;
      ddt[row0 + (long long)j * H] = dtj + s.g[j] * dwj;
    }
  }
  __syncthreads();
  if (tid == 0) {
    double extra = (double)__ldg(dtotal + cta);
    for (int q = 0; q < Q; ++q) {
      const float dww = s.dw[q] * s.w[q];
      s.dcum[q] -= dww;
      extra += (double)dww;
    }
    double run = extra;  // dcum[Q-1] gets dtotal + Σ dw·w
    for (int q = Q - 1; q >= 0; --q) {
      run += (double)s.dcum[q];
      da[row0 + (long long)q * H] = (float)run;
    }
  }

  // 5. per state slice: dC = dS·B; dB = dSᵀ·C + w·(dstᵀ·x)
  for (int n0 = 0; n0 < N; n0 += KT) {
    float dc[4][4], db[4][4], sx[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dc[r][c] = db[r][c] = sx[r][c] = 0.f;
    __syncthreads();
    stage_rows(s.tA, Bb, nrs, Q, n0, N, nullptr);
    stage_rows(s.tB, Cb, nrs, Q, n0, N, nullptr);
    __syncthreads();
    for (int k = 0; k < Q; ++k) {
      float dr[4], dcol[4], bv[4], cv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        dr[r] = s.D[(uy + 32 * r) * MS + k];    // dS[i][k], i = uy + 32r
        dcol[r] = s.D[k * MS + uy + 32 * r];    // dS[k][j], j = uy + 32r
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        bv[c] = s.tA[k * TS + ux + 8 * c];
        cv[c] = s.tB[k * TS + ux + 8 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          dc[r][c] = fmaf(dr[r], bv[c], dc[r][c]);
          db[r][c] = fmaf(dcol[r], cv[c], db[r][c]);
        }
    }
    for (int p0 = 0; p0 < P; p0 += KT) {
      __syncthreads();
      stage_rows(s.tC, xb, xrs, Q, p0, P, nullptr);
      stage_dst(s.tD, dstb, P, N, p0, n0);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KT; ++k) {
        float xv[4], dv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) xv[r] = s.tC[(uy + 32 * r) * TS + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) dv[c] = s.tD[k * TS + ux + 8 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sx[r][c] = fmaf(xv[r], dv[c], sx[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = uy + 32 * r;
      if (j >= Q) continue;
      const long long o = (row0 + (long long)j * H) * N;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = n0 + ux + 8 * c;
        if (n < N) {
          dC[o + n] = dc[r][c];
          dB[o + n] = db[r][c] + s.w[j] * sx[r][c];
        }
      }
    }
  }
}

// Set the kernel's shared-memory attribute once for each device.
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
                           (int)sizeof(Smem));
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
  ssd_bwd_kernel<T><<<(unsigned)ctas, NT, sizeof(Smem), stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const float*)B, (const float*)C,
      (const T*)dy, (const float*)dst, (const float*)dtotal, (T*)dx, (float*)ddt, (float*)da,
      (float*)dB, (float*)dC, Q, H, P, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx: (Bb, nc, Q, H, P) f32, or bf16 when x_bf16; dt, a, ddt, da:
// (Bb, nc, Q, H) f32; B, C, dB, dC: (Bb, nc, Q, H, N) f32; dst: (Bb, nc, H,
// P, N) f32; dtotal: (Bb, nc, H) f32. All contiguous, 1 <= Q <= 128.
// Returns a cudaError_t (0 on a clean launch).
extern "C" int ssd_bwd_launch(const void* x, int x_bf16, const void* dt, const void* a,
                              const void* B, const void* C, const void* dy, const void* dst,
                              const void* dtotal, void* dx, void* ddt, void* da, void* dB,
                              void* dC, int Bb, int nc, int Q, int H, int P, int N, void* stream) {
  if (Q < 1 || Q > QM || H < 1 || P < 1 || N < 1 || Bb < 0 || nc < 0)
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

extern "C" const char* ssd_bwd_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
