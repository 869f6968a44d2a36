// Codec unpack: stored compressed extents -> the 14 per-block stream rows.
//
// Replaces the TPU kernel `_unpack_kernel` / `_build_pallas_unpack` /
// `sage_unpack_pallas` (src/repro/kernels/sage_decode.py), itself the device
// twin of `repro.core.codec.decode_blocks`.
//
// Design: one CTA per stored extent. The extent's payload row (cap_words
// uint32, a few KiB after compression) and the (14, 16) nibble dictionaries
// are staged in shared memory with coalesced loads; thread 0 parses the
// 28-word descriptor (used words, mode, escape count per stream) and the
// section offsets. Raw sections copy their truncated prefix; nibble sections
// give each thread one output word (4 nibbles -> 4 bytes through the
// dictionary), and byte escapes are ranked by a CTA-wide exclusive scan of
// the per-word escape counts, carried across tiles.
//
// Bound on the H100: bytes. Each block reads its cap_words payload once and
// writes sum(W_s) row words; the arithmetic is a handful of shifts per byte.
// A 32-extent group of the Illumina container at token_target 65536
// (cap_words 358, sum(W_s) 538) moves ~115 KB: 0.03 us at 3.35 TB/s, so
// launch latency, not the bound, sets this kernel's time.
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

constexpr int NT = 256;
constexpr int USED_MASK = (1 << 20) - 1;
constexpr int MODE_NIBBLE = 1;
constexpr int ESCAPE = 15;

__global__ void __launch_bounds__(NT) sage_unpack_kernel(UnpackParams p) {
  using namespace sage;
  SAGE_SMEM(uint32_t, row);  // cap words | scan scratch | section table | dicts
  int* sh = reinterpret_cast<int*>(row + p.cap);
  int* used = sh + 32;
  int* mode = used + MAX_STREAMS;
  int* sec_off = mode + MAX_STREAMS;
  uint8_t* dict = reinterpret_cast<uint8_t*>(sec_off + MAX_STREAMS);

  const int b = blockIdx.x;
  const int cap = p.cap;
  const int ns = p.ns;
  const uint32_t* src = p.packed + (long long)b * cap;
  for (int i = threadIdx.x; i < cap; i += NT) row[i] = src[i];
  for (int i = threadIdx.x; i < ns * 16; i += NT) dict[i] = p.dicts[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    // descriptor: ns words of (mode << 20 | used), then ns escape counts
    int off = 2 * ns;
    for (int s = 0; s < ns; ++s) {
      const int desc = (int)row[s];
      const int u = desc & USED_MASK;
      const int m = (desc >> 20) & 3;
      const int nesc = (int)row[ns + s];
      used[s] = u;
      mode[s] = m;
      sec_off[s] = off;
      const int sec = m == MODE_NIBBLE
          ? wadd(floordiv(wadd(u, 1), 2), floordiv(wadd(nesc, 3), 4))
          : u;
      off = wadd(off, sec);
    }
  }
  __syncthreads();

  for (int s = 0; s < ns; ++s) {
    const int u = used[s];
    const int off = sec_off[s];
    const int w = p.widths[s];
    uint32_t* dst = p.out[s] + (long long)b * w;
    if (mode[s] != MODE_NIBBLE) {
      for (int kw = threadIdx.x; kw < w; kw += NT)
        dst[kw] = kw < u ? row[iclamp(wadd(off, kw), 0, cap - 1)] : 0u;
      continue;
    }
    const int eoff = wadd(off, floordiv(wadd(u, 1), 2));
    const int nbytes = wmul(4, u);
    const uint8_t* dk = dict + s * 16;
    int carry = 0;  // escapes ranked so far in this section
    for (int base = 0; base < w; base += NT) {
      const int kw = base + threadIdx.x;
      int nib[4];
      int n_esc = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kb = 4 * kw + j;
        nib[j] = (int)((row[iclamp(wadd(off, kb >> 3), 0, cap - 1)] >> (4 * (kb & 7))) & 15u);
        if (kw < w && kb < nbytes && nib[j] == ESCAPE) ++n_esc;
      }
      int total;
      int rank = carry + cta_exclusive_scan<NT, Sum>(n_esc, sh, &total);
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kb = 4 * kw + j;
        if (kb >= nbytes) continue;
        uint32_t byte;
        if (nib[j] == ESCAPE) {
          byte = (row[iclamp(wadd(eoff, rank >> 2), 0, cap - 1)] >> (8 * (rank & 3))) & 255u;
          ++rank;
        } else {
          byte = dk[nib[j]];
        }
        word |= byte << (8 * j);
      }
      if (kw < w) dst[kw] = word;
      carry += total;
    }
  }
}

}  // namespace

extern "C" int sage_unpack_smem_bytes(int cap, int ns) {
  return cap * 4 + (32 + 3 * MAX_STREAMS) * 4 + ns * 16;
}

extern "C" int sage_unpack_launch(const UnpackParams* p, void* stream) {
  if (p->n == 0) return 0;
  const int smem = sage_unpack_smem_bytes(p->cap, p->ns);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sage_unpack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  sage_unpack_kernel<<<p->n, NT, smem, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" const char* sage_unpack_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
