// The per-block body of the SAGe block decode, shared by the block-decode
// kernel (B2) and the fused gather+decode+format kernel (B5) in
// sage_decode.cu, as the JAX package shares `decode_block_arrays` between
// `_kernel` and `_fused_kernel` (src/repro/kernels/sage_decode.py). It
// computes exactly what `decode_block_arrays` (src/repro/core/decode_jax.py)
// computes, in int32 with the same clipping.
//
// The reference builds ~11 int32 arrays over the token axis (C ~ 65 Ki):
// scatter targets of the mismatches, three scans over them, the segment of
// every token and the token row. None of them is stored here. Every
// token-axis quantity is a step function of at most M events (the block's
// mismatches), so the body sorts the mismatches by token position once
// (a counting sort into tiles of ceil(C / NBK) tokens, then a rank inside
// each tile's bucket) and keeps, per sorted event, the running carries the
// scans would have produced:
//   ev_dp[j]  deletion shift of the events before j (the scan of del_at),
//   marks     one per token position holding an insertion, max-reduced as
//             the scatter-max does (the positions where cummax(ins_start)
//             steps), with the insertion's end and the count of covered
//             tokens before it (mk_ic, the carry of the `consumes` scan).
// A token's consumed count, deletion shift and insertion state are then
// closed forms of the last event and the last mark at or before it, and the
// segment-start prefixes that `_seg_cumsum` subtracts are the same closed
// forms at the segment's first token, computed per segment wherever that
// token lies: nothing relies on segments or mismatches being in order.
//
// The pre-complement row is written as int8 by a walk over runs of RUN = 8
// tokens, a run a thread (a warp owns a contiguous span), with cursors into
// the sorted events, the marks and the segments' ends carried from run to
// run. A run inside one consensus-copied stretch of a segment is 8
// consecutive 2-bit consensus codes, one 8-byte store. The runs holding an
// event, a mark, a segment end or a corner segment (~7% of an Illumina
// block's) are set aside in a bit mask and decoded token by token after the
// walk, dealt round-robin to the CTA's threads: left in the walk, one such
// lane stalled its whole warp on most steps. A second walk gathers the
// reverse complement from the row and writes the output tokens and, in B5,
// the format (sage_decode.cu). The row, the consensus window and the
// per-segment and per-mismatch arrays live in shared memory when they fit
// (the Illumina caps: ~104 KB, two CTAs an SM); otherwise everything but the
// consensus window goes to a per-CTA slot of global scratch, which L2 holds.
#pragma once

#include "sage_common.cuh"

static constexpr int NSTREAMS = 14;
static constexpr int MAXCLS = 8;

// Parameter block, filled by the ctypes wrapper (same field order).
struct DecodeParams {
  const uint32_t* streams[NSTREAMS];  // (rows, widths[s]) resident rows
  int widths[NSTREAMS];
  const uint32_t* cons;  // (rows, cons_w)
  const int32_t* dir;    // (rows, ndir) block-local directory rows
  const int32_t* valid;  // (nb,) lane mask, or null
  int cons_w;
  int ndir;
  int nb;  // lanes to decode
  int R, M, I, U, C;  // caps: segs, max(mism,1), max(indel,1), max(multi,1), tokens
  int window, insb, escb;
  int fixed_len;
  int ncls[4];
  int cls_w[4][MAXCLS];
  // directory columns
  int d_n_segs, d_n_reads, d_n_mism, d_n_tokens, d_cons_start, d_base_pos;
  int8_t* tokens;  // (nb, C)
  int32_t* read_pos;  // (nb, R) each
  int32_t* read_rev;
  int32_t* read_start;
  int32_t* read_len;
  int32_t* read_corner;
  unsigned char* scratch;  // (grid, slot_bytes), or null when everything fits on chip
  long long slot_bytes;
  // fused kernel only (null / 0 for the block-decode kernel)
  const int32_t* ids;  // (nb,) resident row decoded into each lane
  int32_t* n_reads;    // (nb,)
  int32_t* n_tokens;   // (nb,)
  int32_t* kmer;       // (nb, C / kmer_k)
  unsigned long long* onehot;  // (nb, C) four bf16 lanes per token
  int kmer_k;
};

namespace sage_decode {

constexpr int NT = 384;  // threads of a CTA (two CTAs an SM: <= 85 registers a thread)
constexpr int NW = NT / 32;
constexpr int K = 4;     // items a thread takes per scan tile
constexpr int NBK = 256;  // tiles of the counting sort of the mismatches
constexpr int RUN = 8;   // consecutive tokens a thread decodes per step
// dynamic shared memory a CTA may take: the H100's 227 KB per block less the
// static `Scalars` and scan scratch
constexpr long long SMEM_LIMIT = 232448 - 1024;

// stream order of repro_torch.core.format.STREAMS
enum { MAPG, MAPA, LENG, LENA, CNTG, CNTA, MPG, MPA, MBB, IDG, IDL, IBS, RFL, ESC };
// adaptive kinds
enum { K_MAP, K_LEN, K_CNT, K_MP };

#define SAGE_HD __host__ __device__ __forceinline__

SAGE_HD long long round16(long long b) { return (b + 15) & ~15LL; }
// words of a bit mask over the runs of RUN tokens
SAGE_HD long long run_words(int C) { return ((long long)C + 32LL * RUN - 1) / (32LL * RUN); }
// ints the token walks read: 13 per segment, 8 per mismatch (+2), the mask
// of deferred runs and its prefix
SAGE_HD long long keep_ints(int R, int M, int C) {
  return 13LL * R + 8LL * M + 2 + 2 * run_words(C) + 1;
}
// ints only the phases before the token walk use
SAGE_HD long long temp_ints(int R, int M) {
  return (long long)(R > M ? R : M) + 7LL * R + 19LL * M + 2LL * NBK + 1;
}

// Where a block's arrays live. `keep` and `temp` are ints; `temp` and the
// int8 row share one region (the row is written after the last use of
// `temp`). All in shared memory when it fits, else in the CTA's slot.
struct Plan {
  long long keep_bytes, union_bytes, cons_bytes;
  int on_chip;       // keep / temp / row in shared memory (else in the slot)
  int cons_on_chip;  // consensus window staged in shared memory
  long long smem;    // dynamic shared bytes
  long long slot;    // global scratch bytes per CTA
};

SAGE_HD Plan make_plan(int R, int M, int C, int cons_w) {
  Plan p;
  p.keep_bytes = round16(4 * keep_ints(R, M, C));
  const long long tb = round16(4 * temp_ints(R, M)), rb = round16((long long)C + 8);  // + 8: load8 reads a word past the row
  p.union_bytes = tb > rb ? tb : rb;
  p.cons_bytes = round16(4LL * cons_w);
  const long long work = p.keep_bytes + p.union_bytes;
  p.on_chip = work + p.cons_bytes <= SMEM_LIMIT;
  p.cons_on_chip = p.on_chip || p.cons_bytes <= SMEM_LIMIT;
  p.smem = (p.on_chip ? work : 0) + (p.cons_on_chip ? p.cons_bytes : 0);
  p.slot = p.on_chip ? 0 : work;
  return p;
}

// A block's arrays (see the header comment and decode_prefix for each).
struct Work {
  // keep: per segment
  int *sE, *sS, *sP, *sK, *sES, *sRID, *sFD, *sFC;
  int *rd_rev, *rd_pos, *rd_start, *rd_len, *rd_corner;
  // keep: sorted mismatch events and insertion marks
  int *ev_pos, *ev_dp, *ev_sub, *mk_q, *mk_v, *mk_e, *mk_o, *mk_ic;
  // keep: runs the row walk left to the CTA (bits), and the exclusive
  // prefix of their popcounts
  uint32_t* dmask;
  int* dpre;
  // temp: per segment and per mismatch
  int *zpos, *r_map, *r_len, *r_cnt, *r_rev, *r_cont, *r_cntend, *r_cntstart;
  int *m_mp, *m_gcmp, *m_seg, *m_mbb, *m_isind, *m_indrank, *m_isins, *m_inslen, *m_dellen,
      *m_ibsoff, *m_gcsh, *m_tm, *m_sb, *m_tclip, *m_order, *m_bmem, *m_hv, *m_hl, *m_ho;
  int *bkt, *bcur;  // (NBK + 1), (NBK)
  int8_t* row;  // (C) pre-complement token row, over temp
  uint32_t* cons;  // (cons_w) staged window, or null

  SAGE_DEV Work(unsigned char* smem, unsigned char* slot, const Plan& pl, int R, int M, int C) {
    unsigned char* base = pl.on_chip ? smem : slot;
    int* s = reinterpret_cast<int*>(base);
    int** keep_r[] = {&sE, &sS, &sP, &sK, &sES, &sRID, &sFD, &sFC,
                      &rd_rev, &rd_pos, &rd_start, &rd_len, &rd_corner};
    for (int** q : keep_r) { *q = s; s += R; }
    ev_pos = s; s += M;
    ev_dp = s; s += M + 1;
    ev_sub = s; s += M;
    int** keep_m[] = {&mk_q, &mk_v, &mk_e, &mk_o};
    for (int** q : keep_m) { *q = s; s += M; }
    mk_ic = s; s += M + 1;
    const int nw = (int)run_words(C);
    dmask = reinterpret_cast<uint32_t*>(s); s += nw;
    dpre = s;
    unsigned char* u = base + pl.keep_bytes;
    row = reinterpret_cast<int8_t*>(u);
    s = reinterpret_cast<int*>(u);
    zpos = s; s += R > M ? R : M;
    int** temp_r[] = {&r_map, &r_len, &r_cnt, &r_rev, &r_cont, &r_cntend, &r_cntstart};
    for (int** q : temp_r) { *q = s; s += R; }
    int** temp_m[] = {&m_mp, &m_gcmp, &m_seg, &m_mbb, &m_isind, &m_indrank, &m_isins,
                      &m_inslen, &m_dellen, &m_ibsoff, &m_gcsh, &m_tm, &m_sb, &m_tclip,
                      &m_order, &m_bmem, &m_hv, &m_hl, &m_ho};
    for (int** q : temp_m) { *q = s; s += M; }
    bkt = s; s += NBK + 1;
    bcur = s;
    cons = pl.cons_on_chip
               ? reinterpret_cast<uint32_t*>((pl.on_chip ? smem + pl.keep_bytes + pl.union_bytes
                                                         : smem))
               : nullptr;
  }
};

// Per-block scalars every thread reads (static shared memory).
struct Scalars {
  int n_ev, n_mk, mono, cons_total;
};

// extract_fields: little-endian field of `width` (<= 32) bits at bit `start`
// through a 64-bit window over two adjacent words; word index clipped to W-2.
SAGE_DEV int extract(const uint32_t* w, int W, int start, int width) {
  const int idx = sage::iclamp(start >> 5, 0, W - 2);
  const unsigned sh = (unsigned)(start & 31);
  const uint32_t lo = w[idx] >> sh;
  const uint32_t hi = sh == 0 ? 0u : (w[idx + 1] << (32u - sh));
  const uint32_t mask = width <= 0 ? 0u : (0xFFFFFFFFu >> sage::iclamp(32 - width, 0, 31));
  return (int)((lo | hi) & mask);
}

// stream_bits: bit i of a packed row, word index clipped to W-1
SAGE_DEV int stream_bit(const uint32_t* w, int W, int i) {
  return (int)((w[sage::imin(i >> 5, W - 1)] >> (i & 31)) & 1u);
}

// resident row `src` of stream k
SAGE_DEV const uint32_t* srow(const DecodeParams& p, int src, int k) {
  return p.streams[k] + (long long)src * p.widths[k];
}

SAGE_DEV int cons_at(const uint32_t* cw, int window, int idx) {
  idx = sage::iclamp(idx, 0, window - 1);
  return (int)((cw[idx >> 4] >> (2 * (idx & 15))) & 3u);
}

// number of entries of arr[0..n) that are <= x, by binary search
// (jnp.searchsorted(arr, x, side="right") when arr is non-decreasing)
SAGE_DEV int upper_bound(const int* arr, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (arr[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// number of entries of the non-decreasing arr[0..n) that are < x
SAGE_DEV int lower_bound(const int* arr, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (arr[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// decode_adaptive: n (<= cap) values whose width class is a unary guide code
// in g and whose fields are packed in a. vals[k] = 0 for k >= n.
SAGE_DEV void decode_adaptive(const uint32_t* g, int Wg, const uint32_t* a, int Wa, int n,
                              const int* cw, int ncls, int cap, int* zpos, int* vals, int* sh) {
  using namespace sage;
  const int need = imin(imax(n, 0), cap);
  for (int k = threadIdx.x; k < need; k += NT) zpos[k] = 0;
  __syncthreads();
  // zpos[r] = bit position of the (r+1)-th zero of the guide bits; only the
  // first `need` zeros are ever read, so the walk stops once they are placed
  const int gb = cap * ncls + 1;
  int carry = 0;
  for (int base = 0; base < gb && carry < need; base += NT * K) {
    const int i0 = base + threadIdx.x * K;
    int z[K];
    int acc = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = i0 + k;
      z[k] = i < gb ? 1 - stream_bit(g, Wg, i) : 0;
      acc += z[k];
    }
    int total;
    int r = carry + cta_exclusive_scan<NT, Sum>(acc, sh, &total);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (z[k]) {
        if (r < need) zpos[r] = i0 + k;
        ++r;
      }
    }
    carry += total;
  }
  __syncthreads();
  auto width_of = [&](int k) {
    if (k >= n) return 0;
    const int prev = k ? zpos[k - 1] : -1;
    return cw[iclamp(zpos[k] - prev - 1, 0, ncls - 1)];
  };
  cta_scan<NT, K, Sum>(
      cap, width_of,
      [&](int k, int incl) {
        const int wd = width_of(k);
        vals[k] = k < n ? extract(a, Wa, incl - wd, wd) : 0;
      },
      sh);
  __syncthreads();
}

// _seg_cumsum(vals, first)[i] given gc = inclusive cumsum(vals):
// gc[i] - (gc[f] - vals[f]) with f = clip(first, 0, n-1)
SAGE_DEV int seg_cumsum_at(const int* gc, const int* vals, int n, int i, int first) {
  const int f = sage::iclamp(first, 0, n - 1);
  return sage::wsub(gc[i], sage::wsub(gc[f], vals[f]));
}

// Tokens before x (x in [0, C]) that consume a consensus base: those below
// n_tok not covered by an insertion. The last mark j before X covers
// [q_j, min(e_j, X)); the marks before it cover mk_ic[j] tokens.
SAGE_DEV int excl_cons(const Work& S, int n_mk, int n_tok, int x) {
  const int X = sage::imax(0, sage::imin(x, n_tok));
  const int j = lower_bound(S.mk_q, n_mk, X) - 1;
  if (j < 0) return X;
  return X - (S.mk_ic[j] + sage::imax(0, sage::imin(X, S.mk_e[j]) - S.mk_q[j]));
}

// Segment cursor of a thread's walk: the segment of token t is
// clip(upper_bound(cumlen, t), 0, R - 1). With a non-decreasing cumlen
// (every decoded length >= 0, which the encoder's lengths are) the walk
// advances a cursor; otherwise it searches for every token.
struct SegCursor {
  const int* E;
  int R, mono, su, next;
  SAGE_DEV SegCursor(const int* e, int r, int m, int t0) : E(e), R(r), mono(m) {
    su = mono ? upper_bound(E, R, t0) : 0;
    next = su < R ? E[su] : INT_MAX;
  }
  SAGE_DEV int at(int t) {
    if (!mono) return sage::imin(upper_bound(E, R, t), R - 1);
    while (t >= next) {
      ++su;
      next = su < R ? E[su] : INT_MAX;
    }
    return sage::imin(su, R - 1);
  }
};

// Phases before the token walk: decode the block's per-segment and
// per-mismatch streams, place its reads and build the sorted events and
// marks. Ends with a barrier.
SAGE_DEV void decode_prefix(const DecodeParams& p, const Work& S, Scalars& sc, int src, int valid,
                            const uint32_t* cw, int* sh) {
  using namespace sage;
  const int R = p.R, M = p.M, C = p.C;
  const int32_t* row = p.dir + (long long)src * p.ndir;
  const int n_segs = wmul(row[p.d_n_segs], valid);
  const int n_mism = wmul(row[p.d_n_mism], valid);
  const int n_tok = wmul(row[p.d_n_tokens], valid);
  const int base_local = row[p.d_base_pos];
  const int* W = p.widths;
  auto st = [&](int k) { return srow(p, src, k); };

  // ---- per-segment streams --------------------------------------------
  decode_adaptive(st(MAPG), W[MAPG], st(MAPA), W[MAPA], n_segs, p.cls_w[K_MAP],
                  p.ncls[K_MAP], R, S.zpos, S.r_map, sh);
  if (!p.fixed_len)
    decode_adaptive(st(LENG), W[LENG], st(LENA), W[LENA], n_segs, p.cls_w[K_LEN],
                    p.ncls[K_LEN], R, S.zpos, S.r_len, sh);
  decode_adaptive(st(CNTG), W[CNTG], st(CNTA), W[CNTA], n_segs, p.cls_w[K_CNT],
                  p.ncls[K_CNT], R, S.zpos, S.r_cnt, sh);
  decode_adaptive(st(MPG), W[MPG], st(MPA), W[MPA], n_mism, p.cls_w[K_MP],
                  p.ncls[K_MP], M, S.zpos, S.m_mp, sh);
  for (int r = threadIdx.x; r < R; r += NT) {
    const int m = r < n_segs;
    const int rfl = extract(st(RFL), W[RFL], 3 * r, 3);
    S.r_rev[r] = (rfl & 1) & m;
    S.r_cont[r] = ((rfl >> 1) & 1) & m;
    S.sK[r] = ((rfl >> 2) & 1) & m;
    S.r_len[r] = m ? (p.fixed_len ? p.fixed_len : S.r_len[r]) : 0;
    S.r_cnt[r] = m ? S.r_cnt[r] : 0;
    S.rd_rev[r] = 0;
    S.rd_pos[r] = -1;
    S.rd_start[r] = 0;
    S.rd_len[r] = 0;
    S.rd_corner[r] = 0;
  }
  for (int b = threadIdx.x; b <= NBK; b += NT) S.bkt[b] = 0;
  if (threadIdx.x == 0) sc.mono = 1;
  __syncthreads();

  // ---- segment positions and token layout (scans over R) ---------------
  auto is_chain = [&](int r) { return r < n_segs && S.r_cont[r] == 0 && S.sK[r] == 0; };
  cta_scan<NT, K, Sum>(
      R, [&](int r) { return is_chain(r) ? S.r_map[r] : 0; },
      [&](int r, int incl) {
        const int acc = wadd(base_local, incl);
        const int v = S.r_map[r];
        const int unzig = (v >> 1) ^ -(v & 1);
        S.sP[r] = S.r_cont[r] == 1 ? wadd(acc, unzig) : acc;
      },
      sh);
  cta_scan<NT, K, Sum>(
      R, [&](int r) { return S.r_len[r]; },
      [&](int r, int incl) { S.sE[r] = incl; S.sS[r] = wsub(incl, S.r_len[r]); }, sh);
  cta_scan<NT, K, Sum>(
      R, [&](int r) { return S.r_cnt[r]; },
      [&](int r, int incl) { S.r_cntend[r] = incl; S.r_cntstart[r] = wsub(incl, S.r_cnt[r]); },
      sh);
  cta_scan<NT, K, Sum>(
      R, [&](int r) { return S.sK[r] == 1 ? S.r_len[r] : 0; },
      [&](int r, int incl) { S.sES[r] = wsub(incl, S.sK[r] == 1 ? S.r_len[r] : 0); }, sh);
  auto read_first = [&](int r) { return (r < n_segs && S.r_cont[r] == 0) ? 1 : 0; };
  cta_scan<NT, K, Sum>(
      R, read_first, [&](int r, int incl) { S.sRID[r] = incl - read_first(r); }, sh);
  __syncthreads();

  // ---- per-read grouping (scatter-max / scatter-add over read ids) -----
  for (int r = threadIdx.x; r < R; r += NT) {
    const int rid = S.sRID[r];
    if (read_first(r)) {
      atomicMax(S.rd_rev + rid, S.r_rev[r]);
      atomicMax(S.rd_pos + rid, S.sK[r] == 1 ? -1 : S.sP[r]);
      atomicMax(S.rd_start + rid, S.sS[r]);
      atomicMax(S.rd_corner + rid, S.sK[r]);
    }
    if (r < n_segs) atomicAdd(S.rd_len + rid, S.r_len[r]);
    if (r > 0 && S.sE[r] < S.sE[r - 1]) sc.mono = 0;
  }

  // ---- mismatch -> segment mapping, indel decode (scans over M) --------
  for (int m = threadIdx.x; m < M; m += NT) {
    S.m_seg[m] = iclamp(upper_bound(S.r_cntend, R, m), 0, R - 1);
    const int mbb = m < n_mism ? extract(st(MBB), W[MBB], 2 * m, 2) : 0;
    S.m_mbb[m] = mbb;
    S.m_isind[m] = (m < n_mism && mbb == 3) ? 1 : 0;
  }
  __syncthreads();
  cta_scan<NT, K, Sum>(
      M, [&](int m) { return S.m_mp[m]; }, [&](int m, int incl) { S.m_gcmp[m] = incl; }, sh);
  cta_scan<NT, K, Sum>(
      M, [&](int m) { return S.m_isind[m]; },
      [&](int m, int incl) { S.m_indrank[m] = incl - S.m_isind[m]; }, sh);
  __syncthreads();
  auto idg_of = [&](int m) {
    return extract(st(IDG), W[IDG], 2 * iclamp(S.m_indrank[m], 0, p.I - 1), 2);
  };
  auto is_multi = [&](int m) { return S.m_isind[m] * ((idg_of(m) >> 1) & 1); };
  cta_scan<NT, K, Sum>(
      M, is_multi,
      [&](int m, int incl) {
        const int mul = is_multi(m);
        const int mul_rank = incl - mul;
        const int is_ind = S.m_isind[m];
        const int is_ins = is_ind * (idg_of(m) & 1);
        const int ilen = (mul == 1 ? extract(st(IDL), W[IDL], 8 * iclamp(mul_rank, 0, p.U - 1), 8)
                                   : 1) * is_ind;
        S.m_isins[m] = is_ins;
        S.m_inslen[m] = is_ins == 1 ? ilen : 0;
        S.m_dellen[m] = (is_ind == 1 && is_ins == 0) ? ilen : 0;
      },
      sh);
  __syncthreads();
  cta_scan<NT, K, Sum>(
      M, [&](int m) { return S.m_inslen[m]; },
      [&](int m, int incl) { S.m_ibsoff[m] = wsub(incl, S.m_inslen[m]); }, sh);
  auto dshift = [&](int m) { return wsub(S.m_dellen[m], S.m_inslen[m]); };
  cta_scan<NT, K, Sum>(
      M, dshift, [&](int m, int incl) { S.m_gcsh[m] = incl; }, sh);
  __syncthreads();

  // ---- each mismatch's token, substituted base and tile -----------------
  const int n_ev = iclamp(n_mism, 0, M);
  const int tile = (C + NBK - 1) / NBK;
  for (int m = threadIdx.x; m < M; m += NT) {
    const int seg = S.m_seg[m];
    const int first = S.r_cntstart[seg];
    const int p_m = seg_cumsum_at(S.m_gcmp, S.m_mp, M, m, first);
    const int f = iclamp(first, 0, M - 1);
    const int shift = wsub(wsub(S.m_gcsh[m], wsub(S.m_gcsh[f], dshift(f))), dshift(m));
    const int cursor = wadd(wadd(S.sP[seg], p_m), shift);
    const int mbb = S.m_mbb[m];
    S.m_sb[m] = mbb + (mbb >= cons_at(cw, p.window, cursor) ? 1 : 0);
    const int t_m = wadd(S.sS[seg], p_m);
    const int tc = iclamp(t_m, 0, C - 1);
    S.m_tm[m] = t_m;
    S.m_tclip[m] = tc;
    if (m < n_ev) atomicAdd(S.bkt + tc / tile, 1);
  }
  __syncthreads();

  // ---- counting sort of the events by (token, m) -----------------------
  cta_scan<NT, K, Sum>(
      NBK, [&](int b) { return S.bkt[b]; },
      [&](int b, int incl) { S.bcur[b] = wsub(incl, S.bkt[b]); }, sh);
  __syncthreads();
  for (int b = threadIdx.x; b < NBK; b += NT) S.bkt[b] = S.bcur[b];  // tile starts
  if (threadIdx.x == 0) S.bkt[NBK] = n_ev;
  __syncthreads();
  for (int m = threadIdx.x; m < n_ev; m += NT)
    S.m_bmem[atomicAdd(S.bcur + S.m_tclip[m] / tile, 1)] = m;
  __syncthreads();
  for (int m = threadIdx.x; m < n_ev; m += NT) {
    const int tc = S.m_tclip[m], b = tc / tile;
    int j = S.bkt[b];
    for (int i = S.bkt[b]; i < S.bkt[b + 1]; ++i) {  // rank inside the tile's bucket
      const int o = S.m_bmem[i], to = S.m_tclip[o];
      j += (to < tc || (to == tc && o < m)) ? 1 : 0;
    }
    S.m_order[j] = m;
    S.ev_pos[j] = tc;
    S.ev_sub[j] = S.m_mbb[m] < 3 ? S.m_sb[m] : -1;
  }
  __syncthreads();

  // ---- carries: deletion shift before each event; insertion marks -------
  // an insertion event heads its token's group unless one precedes it
  // there; the group max-reduces t_m, the length and the offset
  cta_scan<NT, K, Sum>(
      n_ev, [&](int j) { return S.m_dellen[S.m_order[j]]; },
      [&](int j, int incl) { S.ev_dp[j + 1] = incl; }, sh);
  if (threadIdx.x == 0) S.ev_dp[0] = 0;
  for (int j = threadIdx.x; j < n_ev; j += NT) {
    const int m = S.m_order[j], q = S.ev_pos[j];
    int head = S.m_isins[m] == 1;
    for (int i = j - 1; head && i >= 0 && S.ev_pos[i] == q; --i) head = S.m_isins[S.m_order[i]] != 1;
    int v = -1, l = 0, o = 0;
    if (head) {
      for (int i = j; i < n_ev && S.ev_pos[i] == q; ++i) {
        const int mi = S.m_order[i];
        if (S.m_isins[mi] == 1) {
          v = imax(v, S.m_tm[mi]);
          l = imax(l, S.m_inslen[mi]);
          o = imax(o, S.m_ibsoff[mi]);
        }
      }
    }
    S.m_hv[j] = v;  // a mark where v >= 0: cummax(ins_start) steps there
    S.m_hl[j] = l;
    S.m_ho[j] = o;
  }
  __syncthreads();
  const int n_mk = cta_scan<NT, K, Sum>(
      n_ev, [&](int j) { return S.m_hv[j] >= 0 ? 1 : 0; },
      [&](int j, int incl) {
        const int v = S.m_hv[j];
        if (v >= 0) {
          const int k = incl - 1;
          S.mk_q[k] = S.ev_pos[j];
          S.mk_v[k] = v;
          // the insertion covers t with t - v < len, t < v + len (saturated)
          const long long e = (long long)v + S.m_hl[j];
          S.mk_e[k] = e > INT_MAX ? INT_MAX : (int)e;
          S.mk_o[k] = S.m_ho[j];
        }
      },
      sh);
  __syncthreads();
  // tokens each mark covers before the next mark: the `consumes` carry
  cta_scan<NT, K, Sum>(
      n_mk,
      [&](int k) {
        const int nq = k + 1 < n_mk ? S.mk_q[k + 1] : INT_MAX;
        return imax(0, imin(nq, S.mk_e[k]) - S.mk_q[k]);
      },
      [&](int k, int incl) { S.mk_ic[k + 1] = incl; }, sh);
  if (threadIdx.x == 0) {
    S.mk_ic[0] = 0;
    sc.n_ev = n_ev;
    sc.n_mk = n_mk;
  }
  __syncthreads();

  // ---- segment-start prefixes, wherever the segment's first token lies --
  for (int r = threadIdx.x; r < R; r += NT) {
    const int f = iclamp(S.sS[r], 0, C - 1);
    S.sFD[r] = S.ev_dp[lower_bound(S.ev_pos, n_ev, f)];
    S.sFC[r] = excl_cons(S, n_mk, n_tok, f);
  }
  for (int w = threadIdx.x; w < (int)run_words(C); w += NT) S.dmask[w] = 0;
  if (threadIdx.x == 0) sc.cons_total = excl_cons(S, n_mk, n_tok, n_tok);
  __syncthreads();
}

// bytes row[x .. x + 8) (x >= 0) from two aligned 8-byte loads
SAGE_DEV unsigned long long load8(const int8_t* row, int x) {
  const unsigned long long* w = reinterpret_cast<const unsigned long long*>(row + (x & ~7));
  const unsigned sh = 8u * (unsigned)(x & 7);
  return sh ? (w[0] >> sh) | (w[1] << (64u - sh)) : w[0];
}

// the 2-bit codes of 8 consecutive consensus positions from idx (idx >= 0,
// idx + 8 <= window), one a byte
SAGE_DEV unsigned long long cons8(const uint32_t* cw, int idx) {
  const unsigned sh = 2u * (unsigned)(idx & 15);
  uint32_t bits = cw[idx >> 4] >> sh;
  if (sh > 16) bits |= cw[(idx >> 4) + 1] << (32u - sh);
  auto spread = [](uint32_t x) {  // 4 two-bit fields -> 4 bytes
    return (x & 3u) | ((x & 0xCu) << 6) | ((x & 0x30u) << 12) | ((x & 0xC0u) << 18);
  };
  return (unsigned long long)spread(bits & 0xFFu) |
         ((unsigned long long)spread((bits >> 8) & 0xFFu) << 32);
}

// Runs a walk left to the CTA: bit r of `mask` is run r (tokens
// [r * len, r * len + len)). The runs are ranked by a scan of the mask's
// popcounts and dealt round-robin to the threads, so a stretch of irregular
// runs spreads over the CTA instead of stalling one warp. Ends without a
// barrier.
template <class F>
SAGE_DEV void for_deferred(const uint32_t* mask, int* pre, int nw, int* sh, F run) {
  const int n = sage::cta_scan<NT, K, sage::Sum>(
      nw, [&](int w) { return __popc(mask[w]); },
      [&](int w, int incl) { pre[w] = incl - __popc(mask[w]); }, sh);
  __syncthreads();
  for (int r = threadIdx.x; r < n; r += NT) {
    const int w = upper_bound(pre, nw, r) - 1;
    run(w * 32 + (int)__fns(mask[w], 0, r - pre[w] + 1));
  }
}

// The pre-complement tokens of one run [a, a + RUN) into S.row, token by
// token with cursors found at a: escape bases in corner segments, then
// inserted bases, substitutions, consensus bases. The cursors' values stay
// in registers between tokens: the runs a CTA's threads take here lie far
// apart, so every shared-memory load of a warp spreads over the banks.
SAGE_DEV void row_run(const DecodeParams& p, const Work& S, const Scalars& sc, int src, int n_tok,
                      const uint32_t* cw, int a) {
  using namespace sage;
  const int C = p.C;
  const int n_ev = sc.n_ev, n_mk = sc.n_mk;
  SegCursor seg(S.sE, p.R, sc.mono, a);
  int c = lower_bound(S.ev_pos, n_ev, a);  // events before t
  int k = lower_bound(S.mk_q, n_mk, a);    // marks at or before t
  int next_ev = c < n_ev ? S.ev_pos[c] : INT_MAX;
  int next_mk = k < n_mk ? S.mk_q[k] : INT_MAX;
  int dp = S.ev_dp[c];
  int kq = -1, ke = 0, kic = 0;  // the last mark at or before t
  if (k > 0) { kq = S.mk_q[k - 1]; ke = S.mk_e[k - 1]; kic = S.mk_ic[k - 1]; }
  int cur = -1, sS = 0, sP = 0, sK = 0, sES = 0, sFD = 0, sFC = 0;
  uint32_t pk[2] = {0u, 0u};
  for (int i = 0; i < RUN; ++i) {
    const int t = a + i;
    if (t >= C) break;
    const int sg = seg.at(t);
    if (sg != cur) {
      cur = sg;
      sS = S.sS[sg]; sP = S.sP[sg]; sK = S.sK[sg]; sES = S.sES[sg];
      sFD = S.sFD[sg]; sFC = S.sFC[sg];
    }
    int sub = -1;
    if (t >= next_ev) {
      for (; c < n_ev && S.ev_pos[c] <= t; ++c)
        if (S.ev_pos[c] == t && S.ev_sub[c] >= 0) sub = S.ev_sub[c];  // the highest m wins
      next_ev = c < n_ev ? S.ev_pos[c] : INT_MAX;
      dp = S.ev_dp[c];
    }
    if (t >= next_mk) {
      while (k < n_mk && S.mk_q[k] <= t) ++k;
      next_mk = k < n_mk ? S.mk_q[k] : INT_MAX;
      kq = S.mk_q[k - 1]; ke = S.mk_e[k - 1]; kic = S.mk_ic[k - 1];
    }
    int tok;
    if (sK == 1) {
      const int esc_idx = wadd(sES, wsub(t, sS));
      tok = extract(srow(p, src, ESC), p.widths[ESC], 3 * iclamp(esc_idx, 0, p.escb), 3);
    } else if (t < n_tok && kq >= 0 && t < ke) {  // inside an insertion
      const int ibs_idx = wadd(S.mk_o[k - 1], wsub(t, S.mk_v[k - 1]));
      tok = extract(srow(p, src, IBS), p.widths[IBS], 2 * iclamp(ibs_idx, 0, p.insb), 2);
    } else if (sub >= 0) {
      tok = sub;
    } else {
      int ec = sc.cons_total;  // consensus bases consumed before t
      if (t < n_tok) {
        if (kq < 0) {
          ec = t;
        } else if (kq < t) {
          ec = t - (kic + imax(0, imin(t, ke) - kq));
        } else {  // a mark at t: the one before it counts
          const int j = k - 2;
          ec = j < 0 ? t : t - (S.mk_ic[j] + imax(0, imin(t, S.mk_e[j]) - S.mk_q[j]));
        }
      }
      tok = cons_at(cw, p.window, wadd(wadd(sP, wsub(ec, sFC)), wsub(dp, sFD)));
    }
    pk[i >> 2] |= (uint32_t)(tok & 0xFF) << (8 * (i & 3));
  }
  if (a + RUN <= C) {
    *reinterpret_cast<uint2*>(S.row + a) = make_uint2(pk[0], pk[1]);
  } else {
    for (int i = 0; a + i < C; ++i) S.row[a + i] = (int8_t)(pk[i >> 2] >> (8 * (i & 3)));
  }
}

// The pre-complement row S.row. Each warp walks a contiguous span in steps
// of 32 runs of RUN tokens, a run a thread, with cursors carried from run to
// run. A run inside one consensus-copied stretch of a segment (no event,
// mark, insertion, corner segment, segment end or n_tok inside it) is 8
// consecutive consensus codes, or 8 copies of one past n_tok; the other runs
// (~7% of an Illumina block's) go to row_run after the walk. Ends with a
// barrier.
SAGE_DEV void decode_row(const DecodeParams& p, const Work& S, const Scalars& sc, int src,
                         int n_tok, const uint32_t* cw, int* sh) {
  using namespace sage;
  const int C = p.C, R = p.R;
  const int n_ev = sc.n_ev, n_mk = sc.n_mk;
  const int steps = (C + 32 * RUN - 1) / (32 * RUN);
  const int per_warp = (steps + NW - 1) / NW;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s0 = w * per_warp, s1 = imin(steps, s0 + per_warp);
  const int t0 = imin(s0 * 32 * RUN + lane * RUN, C);
  SegCursor seg(S.sE, R, sc.mono, t0);
  int c = lower_bound(S.ev_pos, n_ev, t0);  // events before the run
  int k = lower_bound(S.mk_q, n_mk, t0);    // marks before the run
  int next_ev = c < n_ev ? S.ev_pos[c] : INT_MAX;
  int next_mk = k < n_mk ? S.mk_q[k] : INT_MAX;
  int kq = -1, ke = 0, kic = 0;  // the last mark before the run
  if (k > 0) { kq = S.mk_q[k - 1]; ke = S.mk_e[k - 1]; kic = S.mk_ic[k - 1]; }
  int cur = -1, sP = 0, sK = 0, sFD = 0, sFC = 0;
  for (int s = s0; s < s1; ++s) {
    const int a = s * 32 * RUN + lane * RUN;
    if (a >= C) break;
    if (next_ev < a) {
      while (c < n_ev && S.ev_pos[c] < a) ++c;
      next_ev = c < n_ev ? S.ev_pos[c] : INT_MAX;
    }
    if (next_mk < a) {
      while (k < n_mk && S.mk_q[k] < a) ++k;
      next_mk = k < n_mk ? S.mk_q[k] : INT_MAX;
      kq = S.mk_q[k - 1]; ke = S.mk_e[k - 1]; kic = S.mk_ic[k - 1];
    }
    const int last = a + RUN - 1;
    bool done = false;
    if (sc.mono && last < C && last < next_ev && last < next_mk && (kq < 0 || ke <= a)) {
      const int sg = seg.at(a);
      if (sg != cur) {
        cur = sg;
        sP = S.sP[sg]; sK = S.sK[sg]; sFD = S.sFD[sg]; sFC = S.sFC[sg];
      }
      if (sK == 0 && last < seg.next && (last < n_tok || a >= n_tok)) {
        const int ec = a >= n_tok ? sc.cons_total
                     : kq < 0    ? a
                                 : a - (kic + imax(0, imin(a, ke) - kq));
        const int idx = wadd(wadd(sP, wsub(ec, sFC)), wsub(S.ev_dp[c], sFD));
        if (a >= n_tok) {
          *reinterpret_cast<unsigned long long*>(S.row + a) =
              0x0101010101010101ull * (unsigned)cons_at(cw, p.window, idx);
          done = true;
        } else if (idx >= 0 && idx <= p.window - RUN) {
          *reinterpret_cast<unsigned long long*>(S.row + a) = cons8(cw, idx);
          done = true;
        }
      }
    }
    if (!done) atomicOr(S.dmask + (a / RUN >> 5), 1u << ((a / RUN) & 31));
  }
  __syncthreads();
  for_deferred(S.dmask, S.dpre, (int)run_words(C), sh,
               [&](int r) { row_run(p, S, sc, src, n_tok, cw, r * RUN); });
  __syncthreads();
}

}  // namespace sage_decode
