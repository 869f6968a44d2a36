// Codec unpack: stored compressed extents -> the 14 per-block stream rows.
//
// Replaces the TPU kernel `_unpack_kernel` / `_build_pallas_unpack` /
// `sage_unpack_pallas` (src/repro/kernels/sage_decode.py), itself the device
// twin of `repro.core.codec.decode_blocks`.
//
// Bound on the H100: bytes. Each block reads its cap_words payload once and
// writes sum(W_s) row words; the arithmetic is a handful of shifts per byte.
// A 32-extent group of the Illumina container at token_target 65536
// (cap_words 358, sum(W_s) 538) moves ~115 KB: 0.03 us at 3.35 TB/s, so the
// kernel's own chain of dependent steps and the launch, not the bound, set
// its time.
//
// Design: one warp per (extent, stream), WARPS warps a CTA, so a 32-extent
// group is 448 warps on 112 CTAs spread over the card's SMs. There is no CTA
// barrier anywhere. Each warp:
//   1. reads the extent's 28 descriptor words (lane l < ns: stream l's word
//      and escape count) and its stream's 16 dictionary bytes (lane l < 16)
//      straight from global memory, in parallel;
//   2. sizes every section and takes their offsets by a warp scan
//      (__shfl_up_sync), then broadcasts its own stream's used words, mode
//      and offset (__shfl_sync);
//   3. raw section: copies the truncated prefix, one word a lane;
//      nibble section: walks the row in steps of TILE words, 4 consecutive
//      words (16 nibbles) a lane: the codes come in two word loads, the
//      dictionary lookup is a __shfl_sync from the lane that holds the byte,
//      and escapes are ranked by a warp scan of per-lane counts with the
//      carry broadcast from lane 31. An escape byte is one load of the word
//      that holds it, from the same lines as the codes (L1).
// The payload is read in place. Staging the row in shared memory behind a
// CTA barrier, a CTA per extent, was slower on the card (tools/b1_b3_ab.py
// times both; PERF.md).
//
// Out-of-range descriptors (used words past W_s, escape counts or offsets
// past cap) clip and wrap exactly as the plain version does: int32 sums wrap
// (wadd), every payload index is clamped to [0, cap - 1] (iclamp).
#include "sage_common.cuh"

static constexpr int MAX_STREAMS = 14;

// Parameter block, filled by the ctypes wrapper (same field order).
struct UnpackParams {
  const uint32_t* packed;  // (n, cap) payload rows, zero padded
  const uint8_t* dicts;    // (ns, 16) nibble dictionaries
  uint32_t* out[MAX_STREAMS];  // (n, widths[s]) per stream
  int widths[MAX_STREAMS];
  int n;
  int cap;
  int ns;
};

namespace {

constexpr int WARPS = 4;         // warps a CTA, one (extent, stream) each
constexpr int TILE = 128;        // output words a warp decodes per step: 4 a lane
constexpr unsigned FULL = 0xffffffffu;
constexpr int USED_MASK = (1 << 20) - 1;
constexpr int MODE_NIBBLE = 1;
constexpr int ESCAPE = 15;

__global__ void __launch_bounds__(32 * WARPS) sage_unpack_kernel(UnpackParams p) {
  using namespace sage;
  const int lane = threadIdx.x & 31;
  const int ns = p.ns;
  const long long gw = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (gw >= (long long)p.n * ns) return;  // the whole warp leaves together
  const int b = (int)(gw / ns);
  const int s = (int)(gw - (long long)b * ns);
  const int cap = p.cap;
  const uint32_t* row = p.packed + (long long)b * cap;  // read in place (L1 / L2)

  // descriptor: ns words of (mode << 20 | used), then ns escape counts
  int desc = 0, nesc = 0;
  if (lane < ns) {
    desc = (int)row[lane];
    nesc = (int)row[ns + lane];
  }
  const uint32_t dict_byte = lane < 16 ? p.dicts[s * 16 + lane] : 0u;
  const int u_l = desc & USED_MASK;
  const int m_l = (desc >> 20) & 3;
  const int sec = m_l == MODE_NIBBLE  // 0 on lanes >= ns
      ? wadd(floordiv(wadd(u_l, 1), 2), floordiv(wadd(nesc, 3), 4))
      : u_l;
  int incl = sec;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl = wadd(y, incl);
  }
  const int u = __shfl_sync(FULL, u_l, s);
  const int mode = __shfl_sync(FULL, m_l, s);
  const int off = wadd(2 * ns, __shfl_sync(FULL, wsub(incl, sec), s));

  const int w = p.widths[s];
  uint32_t* dst = p.out[s] + (long long)b * w;
  if (mode != MODE_NIBBLE) {
    for (int kw = lane; kw < w; kw += 32)
      dst[kw] = kw < u ? row[iclamp(wadd(off, kw), 0, cap - 1)] : 0u;
    return;
  }
  const int eoff = wadd(off, floordiv(wadd(u, 1), 2));
  const int nbytes = wmul(4, u);
  int carry = 0;  // escapes ranked so far in this section
  for (int base = 0; base < w; base += TILE) {
    const int kw0 = base + 4 * lane;  // this lane's words kw0 .. kw0 + 3
    // word kw's 4 nibbles sit in code word kw >> 1, half kw & 1
    const uint32_t code[2] = {row[iclamp(wadd(off, kw0 >> 1), 0, cap - 1)],
                              row[iclamp(wadd(off, (kw0 >> 1) + 1), 0, cap - 1)]};
    int nib[16];
    uint32_t look[16];
    int n_esc = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int kw = kw0 + (i >> 2);
      const int kb = 4 * kw + (i & 3);
      nib[i] = (int)((code[i >> 3] >> (4 * (i & 7))) & 15u);
      look[i] = __shfl_sync(FULL, dict_byte, nib[i]);
      if (kw >= w || kb >= nbytes) nib[i] = -1;  // not in use: byte 0
      n_esc += nib[i] == ESCAPE;
    }
    int esc_incl = n_esc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, esc_incl, o);
      if (lane >= o) esc_incl += y;
    }
    int rank = carry + esc_incl - n_esc;
    carry += __shfl_sync(FULL, esc_incl, 31);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = nib[4 * r + j];
        uint32_t byte = v < 0 ? 0u : look[4 * r + j];
        if (v == ESCAPE) {
          byte = (row[iclamp(wadd(eoff, rank >> 2), 0, cap - 1)] >> (8 * (rank & 3))) & 255u;
          ++rank;
        }
        word |= byte << (8 * j);
      }
      if (kw0 + r < w) dst[kw0 + r] = word;
    }
  }
}

}  // namespace

// Launch shape for n extents of ns streams: out = {grid, threads, shared
// memory bytes}.
extern "C" void sage_unpack_plan(int n, int ns, int* out) {
  const long long warps = (long long)n * ns;
  out[0] = (int)((warps + WARPS - 1) / WARPS);
  out[1] = 32 * WARPS;
  out[2] = 0;
}

extern "C" int sage_unpack_launch(const UnpackParams* p, void* stream) {
  if (p->n == 0 || p->ns == 0) return 0;
  if ((long long)p->n * p->ns > (long long)INT_MAX * WARPS) return (int)cudaErrorInvalidConfiguration;
  int plan[3];
  sage_unpack_plan(p->n, p->ns, plan);
  sage_unpack_kernel<<<plan[0], plan[1], plan[2], (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" const char* sage_unpack_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
