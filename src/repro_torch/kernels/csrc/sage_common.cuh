// Shared device helpers for the SAGe CUDA kernels (sm_90a).
//
// CTA-wide scans built from warp shuffles: the TPU kernels lean on
// jnp.cumsum / lax.cummax over whole rows held in VMEM; here a row is walked
// in tiles of NT*K items with a running carry, each tile scanned across the
// CTA (per-thread serial scan of K items, warp shuffle scan, one shared
// array of per-warp totals).
#pragma once

#include <stdint.h>
#include <limits.h>

#include <cuda_runtime.h>

#define SAGE_SMEM(T, name)                                  \
  extern __shared__ __align__(16) unsigned char sage_smem_[]; \
  T* name = reinterpret_cast<T*>(sage_smem_)

#define SAGE_DEV __device__ __forceinline__

namespace sage {

SAGE_DEV int imin(int a, int b) { return a < b ? a : b; }
SAGE_DEV int imax(int a, int b) { return a > b ? a : b; }
SAGE_DEV int iclamp(int v, int lo, int hi) { return imin(imax(v, lo), hi); }
// int32 arithmetic with two's-complement wraparound, as jnp int32 computes
SAGE_DEV int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
SAGE_DEV int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
SAGE_DEV int wmul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }
// floor division by a positive constant (jnp `//` on int32)
SAGE_DEV int floordiv(int a, int b) {
  long long q = (long long)a / b;
  if ((long long)q * b != a && a < 0) q -= 1;
  return (int)q;
}

struct Sum {
  static SAGE_DEV int id() { return 0; }
  SAGE_DEV int operator()(int a, int b) const { return wadd(a, b); }
};
struct Max {
  static SAGE_DEV int id() { return INT_MIN; }
  SAGE_DEV int operator()(int a, int b) const { return a > b ? a : b; }
};

// Exclusive scan of one value per thread across the CTA (Op identity for
// thread 0); *total receives the reduction over the whole CTA. `sh` holds
// NT/32 ints of shared memory. Every thread of the CTA must call it.
template <int NT, class Op>
SAGE_DEV int cta_exclusive_scan(int v, int* sh, int* total) {
  static_assert(NT % 32 == 0 && NT <= 1024, "CTA size");
  Op op;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = op(y, incl);
  }
  int ex = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) ex = Op::id();
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NT / 32 ? sh[lane] : Op::id();
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = op(y, w);
    }
    if (lane < NT / 32) sh[lane] = w;
  }
  __syncthreads();
  if (warp > 0) ex = op(sh[warp - 1], ex);
  *total = sh[NT / 32 - 1];
  __syncthreads();
  return ex;
}

// Inclusive scan of load(i) over i in [0, n): store(i, prefix) receives
// each inclusive prefix. Thread t of a tile owns items [base + t*K, +K).
// Returns the reduction over all n items (the same on every thread).
template <int NT, int K, class Op, class Load, class Store>
SAGE_DEV int cta_scan(int n, Load load, Store store, int* sh) {
  Op op;
  int carry = Op::id();
  for (int base = 0; base < n; base += NT * K) {
    int x[K];
    int acc = Op::id();
    const int i0 = base + threadIdx.x * K;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = i0 + k;
      acc = op(acc, i < n ? load(i) : Op::id());
      x[k] = acc;
    }
    int total;
    const int pre = op(carry, cta_exclusive_scan<NT, Op>(acc, sh, &total));
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = i0 + k;
      if (i < n) store(i, op(pre, x[k]));
    }
    carry = op(carry, total);
  }
  return carry;
}

}  // namespace sage
