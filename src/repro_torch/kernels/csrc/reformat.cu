// SAGe_Read output formats: k-mer LM token ids and one-hot bf16 planes.
//
// Replaces the TPU kernels `_kmer_kernel` / `_build_kmer_pack` /
// `kmer_pack_pallas` (row math `kmer_ids_row`) and `_onehot_kernel` /
// `_build_one_hot` / `one_hot_pallas` (row math `one_hot_row`) in
// src/repro/kernels/reformat.py.
//
// Design: elementwise, grid-stride. k-mer: one thread per output id reads
// its k int8 tokens and folds them by Horner (4-containing groups map to the
// pad id, or with per-block n_tokens to the N-block id inside the read).
// One-hot: one thread per token writes its four bf16 lanes as one 8-byte
// store of bit patterns (0x3F80 = 1.0, 0 = 0.0).
//
// Bound on the H100: bytes (k-mer reads C int8 and writes 4*C/k bytes per
// block; one-hot reads C and writes 8*C bytes per block). On a 256-block
// bucket of C = 65558: k-mer (k = 4) ~33.6 MB, 10 us; one-hot ~151 MB, 45 us
// at 3.35 TB/s.
#include "sage_common.cuh"

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT) kmer_kernel(const int8_t* tok, const int32_t* ntok,
                                                  int32_t* out, int nb, int C, int k) {
  const int G = C / k;
  const long long total = (long long)nb * G;
  const int pad = 1 << (2 * k);  // 4**k, then bos, then nblk
  const int nblk = pad + 2;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < total;
       i += (long long)gridDim.x * NT) {
    const int b = (int)(i / G);
    const int gi = (int)(i - (long long)b * G);
    const int8_t* g = tok + (long long)b * C + (long long)gi * k;
    unsigned id = 0;
    bool has4 = false;
    for (int j = 0; j < k; ++j) {
      const int v = g[j];
      has4 |= v == 4;
      id = id * 4u + (unsigned)(v > 3 ? 0 : v);
    }
    int r = (int)id;
    if (has4) r = (ntok && (gi + 1) * k <= ntok[b]) ? nblk : pad;
    out[i] = r;
  }
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

extern "C" int kmer_pack_launch(const void* tok, const void* ntok, void* out, int nb, int C,
                                int k, void* stream) {
  const long long total = (long long)nb * (C / k);
  if (total == 0) return 0;
  kmer_kernel<<<grid_for(total), NT, 0, (cudaStream_t)stream>>>(
      (const int8_t*)tok, (const int32_t*)ntok, (int32_t*)out, nb, C, k);
  return (int)cudaGetLastError();
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
