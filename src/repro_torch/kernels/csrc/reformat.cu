// SAGe_Read output formats: k-mer LM token ids and one-hot bf16 planes.
//
// Replaces the TPU kernels `_kmer_kernel` / `_build_kmer_pack` /
// `kmer_pack_pallas` (row math `kmer_ids_row`) and `_onehot_kernel` /
// `_build_one_hot` / `one_hot_pallas` (row math `one_hot_row`) in
// src/repro/kernels/reformat.py.
//
// Bound on the H100: bytes (k-mer reads C int8 and writes 4*C/k bytes per
// block; one-hot reads C and writes 8*C bytes per block). On a 256-block
// bucket of C = 65558: k-mer (k = 4) ~33.6 MB, 10 us; one-hot ~151 MB, 45 us
// at 3.35 TB/s.
//
// k-mer design: a 2D grid of (row tile, block row), so no thread divides a
// flat index by the row length. A CTA owns KMER_TILE = 2048 ids of one row:
// it loads the tile's token bytes into shared memory as 16-byte vectors over
// the aligned superset of the tile (rows start at any byte, C = 65558 is 6
// mod 16), byte by byte only in the ragged head and tail chunk, every load
// of a thread issued before the first lands. Each thread then takes 8 ids
// at a stride of the CTA, reads each id's k bytes as 32-bit shared words
// joined by a funnel shift, finds 4s and clears bytes in [4, 127] a word at
// a time (SWAR), and folds the signed bytes by Horner in wrapping unsigned
// arithmetic (the plain version's int32 sum); a group holding a 4 maps to
// the pad id, or with per-block n_tokens to the N-block id when it lies
// inside the read. Stores are coalesced 4-byte writes. k is a template
// parameter (1..15), so the fold is unrolled. The tile size, the batched
// loads and the SWAR masks were each chosen by timing on the card
// (PERF.md).
//
// One-hot: elementwise, grid-stride; one thread per token writes its four
// bf16 lanes as one 8-byte store of bit patterns (0x3F80 = 1.0, 0 = 0.0).
#include "sage_common.cuh"

namespace {

constexpr int NT = 256;
constexpr int KMER_IDS = 8;                  // ids a thread
constexpr int KMER_TILE = NT * KMER_IDS;     // ids a CTA
constexpr int MAX_K = 15;

constexpr int kmer_smem_bytes(int k) { return KMER_TILE * k + 32; }

// Id of one k-mer whose K bytes start at byte `sh / 8` of shared words
// wd[0..]: 4 bytes at a time, a word's 4s found and its bytes in [4, 127]
// cleared with SWAR masks, then the signed bytes folded by Horner.
template <int K>
SAGE_DEV int kmer_fold(const uint32_t* wd, int sh, bool& has4) {
  unsigned id = 0;
  bool h4 = false;
#pragma unroll
  for (int q = 0; q < (K + 3) / 4; ++q) {
    const uint32_t al = __funnelshift_r(wd[q], wd[q + 1], sh);
    const int nbq = K - 4 * q < 4 ? K - 4 * q : 4;  // bytes of this word in the k-mer
    const uint32_t keep = nbq == 4 ? 0xFFFFFFFFu : ((1u << (8 * nbq)) - 1u);
    const uint32_t y = (al ^ 0x04040404u) | ~keep;  // a zero byte where a kept byte is 4
    h4 |= ((y - 0x01010101u) & ~y & 0x80808080u) != 0u;
    // bit 7 of each byte in [4, 127]: bits 2..6 not all clear, sign clear
    const uint32_t big = (((al & 0x7C7C7C7Cu) + 0x7C7C7C7Cu) & ~al) & 0x80808080u;
    const uint32_t c = al & ~((big >> 7) * 0xFFu);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < nbq) id = id * 4u + (unsigned)(int)(int8_t)(c >> (8 * i));
  }
  has4 = h4;
  return (int)id;
}

template <int K>
__global__ void __launch_bounds__(NT) kmer_kernel(const int8_t* tok, const int32_t* ntok,
                                                  int32_t* out, int nb, int C) {
  SAGE_SMEM(uint32_t, sw);
  constexpr int CH = (KMER_TILE * K + 30) / 16 / NT + 1;  // 16-byte chunks a thread loads
  constexpr int NW = (K + 3) / 4 + 1;  // shared words an id's K bytes can touch
  constexpr int PAD = 1 << (2 * K);    // 4**k, then bos, then nblk
  constexpr int NBLK = PAD + 2;
  const int G = C / K;
  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    const int8_t* rowp = tok + (long long)b * C;
    const int nt = ntok ? ntok[b] : 0;
    int32_t* orow = out + (long long)b * G;
    for (int g0 = blockIdx.x * KMER_TILE; g0 < G; g0 += gridDim.x * KMER_TILE) {
      const int nid = G - g0 < KMER_TILE ? G - g0 : KMER_TILE;
      const uintptr_t a0 = (uintptr_t)(rowp + (long long)g0 * K);
      const uintptr_t a1 = a0 + (uintptr_t)nid * K;  // one past the tile's last byte
      const uintptr_t A = a0 & ~(uintptr_t)15;
      const int nchunks = (int)((a1 - A + 15) >> 4);
      // every chunk's load is issued before the first is stored
      uint4 v[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int idx = threadIdx.x + c * NT;
        if (idx >= nchunks) break;
        const uintptr_t ca = A + 16 * (uintptr_t)idx;
        if (ca >= a0 && ca + 16 <= a1) {
          v[c] = *reinterpret_cast<const uint4*>(ca);
        } else {  // ragged head or tail: only the tile's own bytes
          uint32_t wv[4] = {0u, 0u, 0u, 0u};
          for (int i = 0; i < 16; ++i)
            if (ca + i >= a0 && ca + i < a1)
              wv[i >> 2] |= (uint32_t)*reinterpret_cast<const uint8_t*>(ca + i) << (8 * (i & 3));
          v[c] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
        }
      }
      __syncthreads();  // the previous tile's readers are done
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int idx = threadIdx.x + c * NT;
        if (idx < nchunks) reinterpret_cast<uint4*>(sw)[idx] = v[c];
      }
      __syncthreads();
      const int h = (int)(a0 - A);
#pragma unroll
      for (int r = 0; r < KMER_IDS; ++r) {
        const int j = threadIdx.x + r * NT;
        if (j >= nid) break;
        const int o = h + j * K;
        uint32_t wd[NW];
#pragma unroll
        for (int i = 0; i < NW; ++i) wd[i] = sw[(o >> 2) + i];
        bool has4;
        int res = kmer_fold<K>(wd, 8 * (o & 3), has4);
        const int gi = g0 + j;
        if (has4) res = (ntok && (gi + 1) * K <= nt) ? NBLK : PAD;
        orow[gi] = res;
      }
    }
  }
}

template <int K>
int launch_kmer(const void* tok, const void* ntok, void* out, int nb, int C, dim3 grid,
                cudaStream_t stream) {
  kmer_kernel<K><<<grid, NT, kmer_smem_bytes(K), stream>>>(
      (const int8_t*)tok, (const int32_t*)ntok, (int32_t*)out, nb, C);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(NT) onehot_kernel(const int8_t* tok, unsigned long long* out,
                                                    long long n) {
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += (long long)gridDim.x * NT) {
    const int t = tok[i];
    out[i] = (t >= 0 && t < 4) ? (0x3F80ull << (16 * t)) : 0ull;
  }
}

int grid_for(long long n) {
  long long g = (n + NT - 1) / NT;
  const long long cap = 132LL * 32;  // enough CTAs to fill the card; the loop strides the rest
  return (int)(g < 1 ? 1 : (g > cap ? cap : g));
}

}  // namespace

// Launch shape of the k-mer kernel: out = {grid x (row tiles), grid y (rows),
// threads, shared memory bytes, ids a CTA}.
extern "C" void kmer_pack_plan(int nb, int C, int k, int* out) {
  const int tiles = (C / k + KMER_TILE - 1) / KMER_TILE;
  out[0] = tiles < 1 ? 1 : tiles;
  out[1] = nb < 1 ? 1 : (nb > 65535 ? 65535 : nb);  // rows past it: the y loop
  out[2] = NT;
  out[3] = kmer_smem_bytes(k);
  out[4] = KMER_TILE;
}

extern "C" int kmer_pack_launch(const void* tok, const void* ntok, void* out, int nb, int C,
                                int k, void* stream) {
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  if (nb == 0 || C / k == 0) return 0;
  int plan[5];
  kmer_pack_plan(nb, C, k, plan);
  const dim3 grid(plan[0], plan[1]);
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    case 1: return launch_kmer<1>(tok, ntok, out, nb, C, grid, st);
    case 2: return launch_kmer<2>(tok, ntok, out, nb, C, grid, st);
    case 3: return launch_kmer<3>(tok, ntok, out, nb, C, grid, st);
    case 4: return launch_kmer<4>(tok, ntok, out, nb, C, grid, st);
    case 5: return launch_kmer<5>(tok, ntok, out, nb, C, grid, st);
    case 6: return launch_kmer<6>(tok, ntok, out, nb, C, grid, st);
    case 7: return launch_kmer<7>(tok, ntok, out, nb, C, grid, st);
    case 8: return launch_kmer<8>(tok, ntok, out, nb, C, grid, st);
    case 9: return launch_kmer<9>(tok, ntok, out, nb, C, grid, st);
    case 10: return launch_kmer<10>(tok, ntok, out, nb, C, grid, st);
    case 11: return launch_kmer<11>(tok, ntok, out, nb, C, grid, st);
    case 12: return launch_kmer<12>(tok, ntok, out, nb, C, grid, st);
    case 13: return launch_kmer<13>(tok, ntok, out, nb, C, grid, st);
    case 14: return launch_kmer<14>(tok, ntok, out, nb, C, grid, st);
    default: return launch_kmer<15>(tok, ntok, out, nb, C, grid, st);
  }
}

extern "C" int one_hot_launch(const void* tok, void* out, long long n, void* stream) {
  if (n == 0) return 0;
  onehot_kernel<<<grid_for(n), NT, 0, (cudaStream_t)stream>>>(
      (const int8_t*)tok, (unsigned long long*)out, n);
  return (int)cudaGetLastError();
}

extern "C" const char* reformat_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
