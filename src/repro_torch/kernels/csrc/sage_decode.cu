// SAGe block decode (B2) and fused gather + decode + format (B5): 14 packed
// stream rows + consensus window -> base tokens and per-read metadata, one
// SAGe block per CTA at a time. Both kernels run the same per-block body
// (sage_decode_body.cuh).
//
// B2 replaces the TPU kernel `_kernel` / `_build_pallas_decode` /
// `sage_decode_arrays` (src/repro/kernels/sage_decode.py): lane b decodes
// row b of arrays the caller has already gathered.
//
// B5 replaces `_fused_kernel` / `_build_fused_gather_decode` /
// `_build_pallas_fused` (same file): lane b decodes row ids[b] of the
// resident arrays, so the gather of 16 arrays that precedes B2 disappears,
// and a format epilogue templated on the format writes the k-mer ids
// (Horner over k tokens, as reformat.cu's kmer kernel) or the one-hot bf16
// planes (one 8-byte store a token, as reformat.cu's one-hot kernel) from the
// lane's finished token row, plus the lane's n_reads / n_tokens. Bit for bit
// the same as B2 followed by B3 or B4.
//
// Design: a bounded persistent grid (a few CTAs per SM) walks the lanes,
// `for (b = blockIdx.x; b < nb; b += gridDim.x)`, each CTA owning one slot of
// global scratch (~3 MB at C = 65558), so scratch is grid x slot, never
// lanes x slot.
//
// Bound on the H100: bytes. Per block the kernels must read its stream rows,
// consensus window and directory row and write C int8 tokens plus 5*R int32
// read planes: ~81 KB per Illumina block at token_target 65536, so a
// 256-block bucket needs ~20.7 MB, 6.2 us at 3.35 TB/s; B5 adds its format's
// plane (kmer k=4: 16.8 MB; onehot: 134 MB). Everything else is scratch
// traffic (the slots of all resident CTAs together exceed the 50 MB L2, so it
// reaches HBM) that a faster version would keep on chip.
#include "sage_decode_body.cuh"

namespace {

using sage_decode::NT;

enum Fmt { FMT_2BIT = 0, FMT_KMER = 1, FMT_ONEHOT = 2 };

__global__ void __launch_bounds__(NT) sage_decode_kernel(DecodeParams p) {
  SAGE_SMEM(int, sh);  // NT/32 ints of scan scratch
  const sage_decode::Slot S(p.scratch + (long long)blockIdx.x * p.slot_ints, p.R, p.M, p.C);
  for (int b = blockIdx.x; b < p.nb; b += gridDim.x) {
    sage_decode::decode_block(p, S, b, b, p.valid ? p.valid[b] : 1, sh);
    __syncthreads();  // the next block reuses this CTA's scratch slot
  }
}

template <int FMT>
__global__ void __launch_bounds__(NT) sage_fused_kernel(DecodeParams p) {
  using namespace sage;
  SAGE_SMEM(int, sh);
  const sage_decode::Slot S(p.scratch + (long long)blockIdx.x * p.slot_ints, p.R, p.M, p.C);
  const int C = p.C;
  for (int b = blockIdx.x; b < p.nb; b += gridDim.x) {
    const int src = p.ids[b];
    const int valid = p.valid[b];
    sage_decode::decode_block(p, S, src, b, valid, sh);
    // the epilogue rereads the token row other threads of the CTA wrote
    __syncthreads();
    const int32_t* row = p.dir + (long long)src * p.ndir;
    const int n_tok = wmul(row[p.d_n_tokens], valid);
    if (threadIdx.x == 0) {
      p.n_reads[b] = wmul(row[p.d_n_reads], valid);
      p.n_tokens[b] = n_tok;
    }
    const int8_t* tok = p.tokens + (long long)b * C;
    if (FMT == FMT_KMER) {
      const int k = p.kmer_k;
      const int G = C / k;  // a ragged tail of C % k tokens is dropped
      const int pad = 1 << (2 * k);  // 4**k, then bos, then nblk
      const int nblk = pad + 2;
      int32_t* out = p.kmer + (long long)b * G;
      for (int g = threadIdx.x; g < G; g += NT) {
        const int8_t* q = tok + (long long)g * k;
        unsigned id = 0;
        bool has4 = false;
        for (int j = 0; j < k; ++j) {
          const int v = q[j];
          has4 |= v == 4;
          id = id * 4u + (unsigned)(v > 3 ? 0 : v);
        }
        out[g] = has4 ? ((g + 1) * k <= n_tok ? nblk : pad) : (int)id;
      }
    } else if (FMT == FMT_ONEHOT) {
      unsigned long long* out = p.onehot + (long long)b * C;
      for (int t = threadIdx.x; t < C; t += NT) {
        const int v = tok[t];
        out[t] = (v >= 0 && v < 4) ? (0x3F80ull << (16 * v)) : 0ull;
      }
    }
    __syncthreads();  // the next block reuses this CTA's scratch slot
  }
}

}  // namespace

extern "C" long long sage_decode_slot_ints(int R, int M, int C) {
  return sage_decode::slot_ints(R, M, C);
}

extern "C" int sage_decode_cta_threads() { return NT; }

extern "C" int sage_decode_launch(const DecodeParams* p, int grid, void* stream) {
  if (p->nb == 0) return 0;
  sage_decode_kernel<<<grid, NT, (NT / 32) * sizeof(int), (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

// fmt: 0 = 2bit (decode planes and counts only), 1 = kmer, 2 = onehot
extern "C" int sage_fused_launch(const DecodeParams* p, int grid, int fmt, void* stream) {
  if (p->nb == 0) return 0;
  const size_t smem = (NT / 32) * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  switch (fmt) {
    case FMT_2BIT: sage_fused_kernel<FMT_2BIT><<<grid, NT, smem, s>>>(*p); break;
    case FMT_KMER: sage_fused_kernel<FMT_KMER><<<grid, NT, smem, s>>>(*p); break;
    case FMT_ONEHOT: sage_fused_kernel<FMT_ONEHOT><<<grid, NT, smem, s>>>(*p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sage_decode_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
