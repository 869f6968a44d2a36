// SAGe block decode (B2) and fused gather + decode + format (B5): 14 packed
// stream rows + consensus window -> base tokens and per-read metadata, one
// SAGe block per CTA at a time. One kernel, templated on the format, runs
// both: the per-block body of sage_decode_body.cuh (the per-segment and
// per-mismatch phases, the mismatches sorted into token-position events with
// their carries, and a walk over the token axis that writes the
// pre-complement row as int8 in shared memory), then a second walk that
// gathers the reverse complement out of that row and writes the output.
//
// B2 replaces the TPU kernel `_kernel` / `_build_pallas_decode` /
// `sage_decode_arrays` (src/repro/kernels/sage_decode.py): the 2bit kernel
// with no lane ids, so lane b decodes row b of arrays the caller has already
// gathered.
//
// B5 replaces `_fused_kernel` / `_build_fused_gather_decode` /
// `_build_pallas_fused` (same file): lane b decodes row ids[b] of the
// resident arrays, so the gather of 16 arrays that precedes B2 disappears,
// and the second walk also writes the k-mer ids (Horner over the k final
// tokens a thread owns; its runs hold whole k-mers) or the one-hot bf16
// planes (one 8-byte store a token, transposed through warp shuffles so a
// warp's stores are contiguous), plus the lane's n_reads / n_tokens. Bit for
// bit the same as B2 followed by B3 or B4.
//
// Grid: a persistent loop over lanes, `for (b = blockIdx.x; b < nb; b +=
// gridDim.x)`, with as many CTAs as the occupancy query lets the card hold
// at once for the plan's shared memory (two an SM at the Illumina caps, so a
// 256-lane bucket is one wave). Scratch is zero when a block's arrays fit in
// shared memory, else one slot per CTA (Plan in sage_decode_body.cuh).
//
// Bound on the H100: bytes. Per block the kernels must read its stream rows,
// consensus window and directory row and write C int8 tokens plus 5*R int32
// read planes: ~81 KB per Illumina block at token_target 65536, so a
// 256-block bucket needs ~20.7 MB, 6.2 us at 3.35 TB/s; B5 adds its format's
// plane (kmer k=4: 16.8 MB; onehot: 134 MB). What holds the kernels above it
// is a block's serial chain in one CTA: the per-segment and per-mismatch
// phases end in CTA barriers, and each step of the two walks is a chain of
// dependent shared-memory loads; memory traffic is not the limit.
#include <atomic>

#include "sage_decode_body.cuh"

namespace {

using namespace sage_decode;

enum Fmt { FMT_2BIT = 0, FMT_KMER = 1, FMT_ONEHOT = 2 };
constexpr int MAX_DEV = 64;

SAGE_DEV unsigned long long onehot_of(int v) {
  return (v >= 0 && v < 4) ? (0x3F80ull << (16 * v)) : 0ull;  // bf16 1.0 in plane v
}

// One-hot planes of a warp step's 32 * RUN tokens, lane l holding tokens
// [8l, 8l + 8) of the step packed in pk: token 32*i + l of the step sits in
// lane 4*i + l/8, byte l%8, so each store of the warp is contiguous.
SAGE_DEV void onehot_step(const DecodeParams& p, int b, int s, int lane, const uint32_t* pk) {
  unsigned long long* oh = p.onehot + (long long)b * p.C + (long long)s * 32 * RUN;
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    const int owner = 4 * i + (lane >> 3), byte = lane & 7;
    const uint32_t lo = __shfl_sync(0xffffffffu, pk[0], owner);
    const uint32_t hi = __shfl_sync(0xffffffffu, pk[1], owner);
    const int v = (int8_t)(((byte < 4 ? lo : hi) >> (8 * (byte & 3))) & 0xFF);
    if (s * 32 * RUN + 32 * i + lane < p.C) oh[32 * i + lane] = onehot_of(v);
  }
}

// reverse the 8 bytes and complement each base (x < 4 -> 3 - x)
SAGE_DEV unsigned long long revcomp8(unsigned long long u) {
  const uint32_t lo = __byte_perm((uint32_t)(u >> 32), 0, 0x0123);
  const uint32_t hi = __byte_perm((uint32_t)u, 0, 0x0123);
  return ((unsigned long long)(hi ^ (__vcmpltu4(hi, 0x04040404u) & 0x03030303u)) << 32) |
         (lo ^ (__vcmpltu4(lo, 0x04040404u) & 0x03030303u));
}

// The lane's output tokens (the reverse complement gathered from S.row, PAD
// past n_tok) and, by format, its k-mer ids or one-hot planes. Each warp
// walks a contiguous span in steps of 32 runs, a run a thread: 8 tokens, or
// whole k-mers when k does not divide 8. A run of 8 is built as pieces split
// at segment ends, each one row load: forward, or reversed and complemented
// as a word; a run wholly past n_tok is PAD. A run whose sources clip, or
// any run when k does not divide 8, goes token by token.
template <int FMT>
SAGE_DEV void emit(const DecodeParams& p, const Work& S, const Scalars& sc, int b, int n_tok) {
  using namespace sage;
  const int C = p.C, R = p.R;
  const int km = FMT == FMT_KMER ? p.kmer_k : 1;
  const int rl = FMT == FMT_KMER ? km * ((RUN + km - 1) / km) : RUN;  // whole k-mers a run
  const int span = 32 * rl;
  const int steps = (C + span - 1) / span;
  const int per_warp = (steps + NW - 1) / NW;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s0 = w * per_warp, s1 = imin(steps, s0 + per_warp);
  int8_t* out = p.tokens + (long long)b * C;
  SegCursor seg(S.sE, R, sc.mono, imin(s0 * span + lane * rl, C));
  int cur = -1, rev = 0, rs = 0, rlen = 0;
  auto read_of = [&](int sg) {
    if (sg != cur) {
      cur = sg;
      const int rid = S.sRID[sg];
      rev = S.rd_rev[rid] == 1;
      rs = S.rd_start[rid];
      rlen = S.rd_len[rid];
    }
  };
  // k-mer ids, Horner over each group of k output tokens (a run starts a
  // group; a ragged tail of C % k tokens has no k-mer): pad = 4**k, then
  // bos, then nblk
  const int G = C / km, pad = 1 << (2 * km), nblk = pad + 2;
  unsigned id = 0;
  bool has4 = false;
  int g = 0, in_g = 0;  // group of the next token, tokens of it seen
  auto put_kmer = [&](int o) {
    has4 |= o == 4;
    id = id * 4u + (unsigned)(o > 3 ? 0 : o);
    if (++in_g == km) {
      if (g < G) p.kmer[(long long)b * G + g] = has4 ? ((g + 1) * km <= n_tok ? nblk : pad) : (int)id;
      ++g;
      in_g = 0;
      id = 0;
      has4 = false;
    }
  };
  // a run's 8 tokens go out as one 8-byte store where the lane's row is
  // 8-byte aligned (every row when 8 divides C), else byte by byte
  const bool aligned = (((long long)b * C) & 7) == 0;
  for (int s = s0; s < s1; ++s) {  // uniform over the warp (one-hot shuffles)
    const int a = s * span + lane * rl;
    const int last = a + rl - 1;
    uint32_t pk[2] = {0u, 0u};
    bool done = false;
    if (FMT == FMT_KMER) g = a / km;
    if (rl == RUN && last < C && (a >= n_tok || (sc.mono && last < n_tok))) {
      unsigned long long v = 0x0404040404040404ull;
      done = true;
      if (a < n_tok) {
        v = 0;
        for (int t1 = a; t1 <= last;) {
          read_of(seg.at(t1));
          const int t2 = imin(last, seg.next - 1), len = t2 - t1 + 1;
          unsigned long long u;
          if (!rev) {
            u = load8(S.row, t1);
          } else {
            const long long k0 = wadd(wadd(rs, wsub(rlen, 1)), rs);  // source of t: k0 - t
            const long long hi = k0 - t1, lo = k0 - t2;
            if (lo < 0 || hi > C - 1 || hi < 7) {
              done = false;
              break;
            }
            u = revcomp8(load8(S.row, (int)(hi - 7)));
          }
          const unsigned long long m = len >= 8 ? ~0ull : (1ull << (8 * len)) - 1;
          v |= (u & m) << (8 * (t1 - a));
          t1 = t2 + 1;
        }
      }
      if (done) {
        pk[0] = (uint32_t)v;
        pk[1] = (uint32_t)(v >> 32);
        if (aligned) {
          *reinterpret_cast<unsigned long long*>(out + a) = v;
        } else {
#pragma unroll
          for (int i = 0; i < RUN; ++i) out[a + i] = (int8_t)(v >> (8 * i));
        }
        if (FMT == FMT_KMER) {
#pragma unroll
          for (int i = 0; i < RUN; ++i) put_kmer((int)((pk[i >> 2] >> (8 * (i & 3))) & 0xFF));
        }
      } else {
        seg = SegCursor(S.sE, R, sc.mono, a);  // the pieces moved it past a
      }
    }
    if (!done) {
      for (int i = 0; i < rl; ++i) {
        const int t = a + i;
        int o = 4;  // PAD_BASE
        if (t < n_tok && t < C) {
          read_of(seg.at(t));
          const int src = rev ? wadd(rs, wsub(wsub(rlen, 1), wsub(t, rs))) : t;
          o = S.row[iclamp(src, 0, C - 1)];
          if (rev && o < 4) o = 3 - o;
        }
        if (t < C) out[t] = (int8_t)o;
        if (FMT == FMT_KMER) put_kmer(o);
        if (rl == RUN) pk[i >> 2] |= (uint32_t)(o & 0xFF) << (8 * (i & 3));
      }
    }
    if (FMT == FMT_ONEHOT) onehot_step(p, b, s, lane, pk);
  }
}

// B2 and B5: lane b decodes resident row ids[b] (B5) or row b (B2, ids null)
template <int FMT>
__global__ void __launch_bounds__(NT, 2) decode_kernel(DecodeParams p) {
  using namespace sage;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sh[NW];  // scan scratch
  __shared__ Scalars sc;
  const Plan pl = make_plan(p.R, p.M, p.C, p.cons_w);
  const Work S(smem, p.scratch ? p.scratch + (long long)blockIdx.x * p.slot_bytes : nullptr, pl,
               p.R, p.M, p.C);
  for (int b = blockIdx.x; b < p.nb; b += gridDim.x) {
    const int src = p.ids ? p.ids[b] : b;
    const int valid = p.valid ? p.valid[b] : 1;
    const int32_t* row = p.dir + (long long)src * p.ndir;
    const int n_tok = wmul(row[p.d_n_tokens], valid);
    const int n_reads = wmul(row[p.d_n_reads], valid);
    const uint32_t* cw = p.cons + (long long)src * p.cons_w;
    if (S.cons) {  // first read after decode_prefix's opening barrier
      for (int i = threadIdx.x; i < p.cons_w; i += NT) S.cons[i] = cw[i];
      cw = S.cons;
    }
    decode_prefix(p, S, sc, src, valid, cw, sh);
    decode_row(p, S, sc, src, n_tok, cw, sh);
    emit<FMT>(p, S, sc, b, n_tok);
    const long long ro = (long long)b * p.R;
    for (int r = threadIdx.x; r < p.R; r += NT) {
      const bool m = r < n_reads;
      const int pos = S.rd_pos[r];
      p.read_pos[ro + r] = m ? wadd(pos, pos >= 0 ? row[p.d_cons_start] : 0) : -1;
      p.read_rev[ro + r] = m ? S.rd_rev[r] : 0;
      p.read_start[ro + r] = m ? S.rd_start[r] : 0;
      p.read_len[ro + r] = m ? S.rd_len[r] : 0;
      p.read_corner[ro + r] = m ? S.rd_corner[r] : 0;
    }
    if (p.n_reads && threadIdx.x == 0) {
      p.n_reads[b] = n_reads;
      p.n_tokens[b] = n_tok;
    }
    __syncthreads();  // the next lane reuses the CTA's arrays
  }
}

const void* kernel_of(int fmt) {
  switch (fmt) {
    case FMT_2BIT: return (const void*)decode_kernel<FMT_2BIT>;
    case FMT_KMER: return (const void*)decode_kernel<FMT_KMER>;
    case FMT_ONEHOT: return (const void*)decode_kernel<FMT_ONEHOT>;
    default: return nullptr;
  }
}

// Lift each kernel's dynamic shared-memory cap to SMEM_LIMIT once per
// device, not on every launch.
int prepare(int fmt) {
  static std::atomic<unsigned long long> done[3];
  const void* k = kernel_of(fmt);
  if (!k) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEV) return (int)cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << dev;
  if (done[fmt].load(std::memory_order_acquire) & bit) return 0;
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_LIMIT);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  done[fmt].fetch_or(bit, std::memory_order_acq_rel);
  return 0;
}

int launch(const DecodeParams* p, int fmt, int grid, cudaStream_t stream) {
  if (p->nb == 0) return 0;
  const Plan pl = make_plan(p->R, p->M, p->C, p->cons_w);
  if (pl.smem > SMEM_LIMIT || (pl.slot > 0 && (!p->scratch || p->slot_bytes < pl.slot)))
    return (int)cudaErrorInvalidValue;
  const int rc = prepare(fmt);
  if (rc != 0) return rc;
  const size_t smem = (size_t)pl.smem;
  switch (fmt) {
    case FMT_2BIT: decode_kernel<FMT_2BIT><<<grid, NT, smem, stream>>>(*p); break;
    case FMT_KMER: decode_kernel<FMT_KMER><<<grid, NT, smem, stream>>>(*p); break;
    case FMT_ONEHOT: decode_kernel<FMT_ONEHOT><<<grid, NT, smem, stream>>>(*p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launch plan of the kernel of format fmt (0 = 2bit, as B2 runs; 1 = kmer;
// 2 = onehot) for nb lanes at these caps: out = {grid, dynamic shared bytes,
// slot bytes per CTA, CTAs an SM}. The grid is what the card holds at once
// (occupancy query), capped at nb.
extern "C" int sage_decode_plan(int R, int M, int C, int cons_w, int nb, int fmt, long long* out) {
  const Plan pl = make_plan(R, M, C, cons_w);
  if (pl.smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  int rc = prepare(fmt);
  if (rc != 0) return rc;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(fmt), NT,
                                                                (size_t)pl.smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long cap = (long long)per_sm * sms;
  out[0] = nb < cap ? nb : cap;
  out[1] = pl.smem;
  out[2] = pl.slot;
  out[3] = per_sm;
  return 0;
}

extern "C" int sage_decode_launch(const DecodeParams* p, int grid, void* stream) {
  return launch(p, FMT_2BIT, grid, (cudaStream_t)stream);
}

// fmt: 0 = 2bit (decode planes and counts only), 1 = kmer, 2 = onehot
extern "C" int sage_fused_launch(const DecodeParams* p, int grid, int fmt, void* stream) {
  return launch(p, fmt, grid, (cudaStream_t)stream);
}

extern "C" const char* sage_decode_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
