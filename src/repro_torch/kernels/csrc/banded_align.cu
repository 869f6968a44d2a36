// Banded edit-distance DP of the SAGe_Write mapper front-end.
//
// Replaces `_align_scan` in src/repro/kernels/banded_align.py: a jitted
// `lax.scan` over the L rows of a read, `vmap`-ed over a batch of lanes
// (no Pallas kernel; XLA runs the whole scan of a chunk as one program).
// The plain torch version, `align_scan_plain` in
// src/repro_torch/kernels/banded_align.py, would dispatch ~15 small ops a row,
// ~2,250 launches a 1024-lane chunk at L = 150; this is one launch a chunk.
//
// Function (bit for bit that of `_align_scan`, int32 throughout): for a
// lane with read r (L), window win (wmax; columns past wlen ignored) and
// anchor off0, js0 = off0 - band, width = 2*band + 1, row i = 1..L:
//   j      = (i-1) + js0 + c            window column of cell c
//   valid  = 0 <= j < wlen
//   diag   = prev[c] + (match ? 0 : 1) + (valid ? 0 : INF),
//            match = valid && r[i-1] < 4 && win[j] == r[i-1]
//   up     = prev[c+1] + 1 (INF + 1 past the band)
//   cur    = min(diag, up); mv = up < diag ? 1 : 0
//   lft    = inclusive prefix-min over c' <= c of
//            (c' < b_lo - 1 ? INF : cur[c'] - c') + c,
//            kept only for b_lo <= c <= b_hi (b_lo = 1 - i - js0,
//            b_hi = wlen - i - js0), else cur
//   mv     = lft < cur ? 2 : mv; cur = min(lft, cur)
// Outputs: moves (B, L, width) u8 and the last row (B, width) i32.
//
// Bound on the H100: bytes. One Illumina chunk (1024 lanes, L 150, band
// 24) moves 7.53 MB of moves, 0.20 MB of last rows, 0.61 MB of reads and
// 0.81 MB of windows: 2.7 us at 3.35 TB/s. The recurrence is a chain of L
// dependent rows, so a lane's time is L times a row's latency; the design
// keeps a row's latency short and runs many lanes at once.
//
// Design: one warp per lane, 4 lanes a CTA, no CTA barrier. Each thread
// holds CPT consecutive cells of the row in registers (CPT, a template
// parameter, is the smallest of 2..32 with 32*CPT >= width, so widths 49
// to 1024 share one code path). `up` of a thread's last cell comes from the
// next thread through one __shfl_down_sync. The prefix-min is a serial min
// over a thread's cells, a 5-step __shfl_up_sync min-scan of the thread
// totals, and one min per cell; masked cells are INF, not skipped. The
// lane's window is copied into shared memory once (int32, so the compare is
// exact for any input); the read's next base is loaded a row ahead. The
// moves of up to STAGE bytes of rows are staged in shared memory and stored
// as 16-byte vectors (the staging keeps the destination's alignment, so
// only a ragged head and tail go byte by byte).
#include "sage_common.cuh"

namespace {

constexpr int INF = 1 << 20;
constexpr int WARPS = 4;           // lanes a CTA at most
constexpr int STAGE = 4096;        // move bytes a warp stages before a flush
constexpr int SMEM_CAP = 200 * 1024;
constexpr int MAX_WIDTH = 32 * 32;
constexpr unsigned FULL = 0xffffffffu;

int round16(int n) { return (n + 15) & ~15; }

int cells_per_thread(int width) {
  const int need = (width + 31) / 32;
  const int opts[] = {2, 4, 8, 12, 16, 24, 32};
  for (int c : opts)
    if (c >= need) return c;
  return 0;
}

// Copy n staged bytes to dst; src and dst share their address mod 16.
SAGE_DEV void flush(const uint8_t* src, uint8_t* dst, int n, int lane) {
  const int head = sage::imin(n, (int)((16 - ((uintptr_t)dst & 15)) & 15));
  for (int k = lane; k < head; k += 32) dst[k] = src[k];
  const int nv = (n - head) >> 4;
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int v = lane; v < nv; v += 32) d4[v] = s4[v];
  for (int k = head + (nv << 4) + lane; k < n; k += 32) dst[k] = src[k];
}

template <int CPT>
__global__ void __launch_bounds__(WARPS * 32)
align_scan_kernel(const int32_t* __restrict__ reads, const int32_t* __restrict__ wins,
                  const int32_t* __restrict__ off0, const int32_t* __restrict__ wlen,
                  uint8_t* __restrict__ moves, int32_t* __restrict__ last,
                  int B, int L, int band, int wmax, int warp_smem) {
  SAGE_SMEM(uint8_t, sm);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // a whole warp: no barrier below spans warps
  const int width = 2 * band + 1;
  int32_t* win = reinterpret_cast<int32_t*>(sm + (size_t)warp * warp_smem);
  uint8_t* stage = sm + (size_t)warp * warp_smem + ((wmax * 4 + 15) & ~15);
  const int32_t* wsrc = wins + (long long)b * wmax;
  for (int k = lane; k < wmax; k += 32) win[k] = wsrc[k];
  __syncwarp();

  const int js0 = off0[b] - band;
  const int wl = wlen[b];
  const int c0 = lane * CPT;
  int prev[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) prev[q] = c0 + q < width ? 0 : INF;

  const int32_t* rd = reads + (long long)b * L;
  uint8_t* mrow = moves + (long long)b * L * width;
  const int rows_per = STAGE / width;  // >= 4: width <= MAX_WIDTH
  int r0 = 0;                          // first row staged
  uint8_t* sdst = stage + ((uintptr_t)mrow & 15);
  int base = L > 0 ? rd[0] : 0;
  for (int i = 1; i <= L; ++i) {
    const int nbase = i < L ? rd[i] : 0;  // next row's base, a row ahead
    const int jb = (i - 1) + js0 + c0;
    int nx = __shfl_down_sync(FULL, prev[0], 1);
    if (lane == 31) nx = INF;
    int cur[CPT];
    uint8_t mv[CPT];
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int j = jb + q;
      const bool valid = j >= 0 && j < wl;
      const bool match = valid && base < 4 && win[j < wmax ? j : wmax - 1] == base;
      const int d = prev[q] + (match ? 0 : 1) + (valid ? 0 : INF);
      const int u = (q + 1 < CPT ? prev[q + 1] : nx) + 1;
      cur[q] = u < d ? u : d;
      mv[q] = u < d ? 1 : 0;
    }
    // left moves: inclusive prefix-min of y over the band, y INF below b_lo - 1
    const int b_lo = 1 - i - js0;
    const int b_hi = wl - i - js0;
    int pm[CPT];
    int run = INT_MAX;
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int c = c0 + q;
      const int y = c < b_lo - 1 ? INF : cur[q] - c;
      run = y < run ? y : run;
      pm[q] = run;
    }
    int incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o && t < incl) incl = t;
    }
    int ex = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) ex = INT_MAX;
    const int rr = i - 1 - r0;
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int c = c0 + q;
      int lft = (pm[q] < ex ? pm[q] : ex) + c;
      if (c < b_lo || c > b_hi) lft = cur[q];
      if (lft < cur[q]) {
        mv[q] = 2;
        cur[q] = lft;
      }
      if (c < width) {
        sdst[rr * width + c] = mv[q];
        prev[q] = cur[q];
      } else {
        prev[q] = INF;
      }
    }
    if (rr + 1 == rows_per || i == L) {
      __syncwarp();
      flush(sdst, mrow + (long long)r0 * width, (rr + 1) * width, lane);
      __syncwarp();
      r0 = i;
      sdst = stage + ((uintptr_t)(mrow + (long long)r0 * width) & 15);
    }
    base = nbase;
  }
  int32_t* lrow = last + (long long)b * width;
#pragma unroll
  for (int q = 0; q < CPT; ++q)
    if (c0 + q < width) lrow[c0 + q] = prev[q];
}

template <int CPT>
int launch_cpt(const int32_t* reads, const int32_t* wins, const int32_t* off0,
               const int32_t* wlen, uint8_t* moves, int32_t* last, int B, int L, int band,
               int wmax, const int* plan, cudaStream_t stream) {
  const int smem = plan[2];
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        align_scan_kernel<CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  align_scan_kernel<CPT><<<plan[0], plan[1], smem, stream>>>(
      reads, wins, off0, wlen, moves, last, B, L, band, wmax, plan[5]);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch shape: out = {grid, threads, dynamic shared memory bytes, cells a
// thread, lanes a CTA, shared bytes a lane}. Cells a thread is 0 when the
// width is past MAX_WIDTH, shared memory -1 when a lane's window and
// staging do not fit in SMEM_CAP: the kernel does not take those shapes.
extern "C" void align_scan_plan(int B, int band, int wmax, int* out) {
  const int width = 2 * band + 1;
  const int warp_smem = round16(wmax * 4) + STAGE + 16;
  int warps = WARPS;
  while (warps > 1 && warps * warp_smem > SMEM_CAP) --warps;
  out[0] = B > 0 ? (B + warps - 1) / warps : 0;
  out[1] = warps * 32;
  out[2] = warp_smem > SMEM_CAP ? -1 : warps * warp_smem;
  out[3] = band >= 0 && width <= MAX_WIDTH ? cells_per_thread(width) : 0;
  out[4] = warps;
  out[5] = warp_smem;
}

extern "C" int align_scan_launch(const void* reads, const void* wins, const void* off0,
                                 const void* wlen, void* moves, void* last, int B, int L,
                                 int band, int wmax, void* stream) {
  int plan[6];
  align_scan_plan(B, band, wmax, plan);
  if (plan[3] == 0 || plan[2] < 0 || wmax < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int32_t* r = (const int32_t*)reads;
  const int32_t* w = (const int32_t*)wins;
  const int32_t* o = (const int32_t*)off0;
  const int32_t* wl = (const int32_t*)wlen;
  uint8_t* mv = (uint8_t*)moves;
  int32_t* ls = (int32_t*)last;
  cudaStream_t st = (cudaStream_t)stream;
  switch (plan[3]) {
    case 2: return launch_cpt<2>(r, w, o, wl, mv, ls, B, L, band, wmax, plan, st);
    case 4: return launch_cpt<4>(r, w, o, wl, mv, ls, B, L, band, wmax, plan, st);
    case 8: return launch_cpt<8>(r, w, o, wl, mv, ls, B, L, band, wmax, plan, st);
    case 12: return launch_cpt<12>(r, w, o, wl, mv, ls, B, L, band, wmax, plan, st);
    case 16: return launch_cpt<16>(r, w, o, wl, mv, ls, B, L, band, wmax, plan, st);
    case 24: return launch_cpt<24>(r, w, o, wl, mv, ls, B, L, band, wmax, plan, st);
    default: return launch_cpt<32>(r, w, o, wl, mv, ls, B, L, band, wmax, plan, st);
  }
}

extern "C" const char* align_scan_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
