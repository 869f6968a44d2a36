// The per-block body of the SAGe block decode, shared by the block-decode
// kernel (B2) and the fused gather+decode+format kernel (B5) in
// sage_decode.cu, as the JAX package shares `decode_block_arrays` between
// `_kernel` and `_fused_kernel` (src/repro/kernels/sage_decode.py). Every
// phase mirrors `decode_block_arrays` (src/repro/core/decode_jax.py) line for
// line, in int32 with the same clipping.
//
// A block's temporaries are ~11 int32 arrays over the token axis (C ~ 65 Ki)
// plus ~11 over mismatches and ~18 over segments: megabytes, far beyond
// shared memory, so each CTA owns one slot of global scratch (`Slot`,
// allocated by the wrapper, one slot per CTA, not per block). Phases are
// separated by __syncthreads(); scans over R, M and C are tile loops with a
// running carry (sage_common.cuh); scatter-max / scatter-add land in scratch
// with atomics. The reverse-complement gather reads the finished token row,
// so it runs in its own phase after the row is complete.
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
  int32_t* scratch;  // (grid, slot_ints)
  long long slot_ints;
  // fused kernel only (null / 0 for the block-decode kernel)
  const int32_t* ids;  // (nb,) resident row decoded into each lane
  int32_t* n_reads;    // (nb,)
  int32_t* n_tokens;   // (nb,)
  int32_t* kmer;       // (nb, C / kmer_k)
  unsigned long long* onehot;  // (nb, C) four bf16 lanes per token
  int kmer_k;
};

namespace sage_decode {

constexpr int NT = 512;
constexpr int K = 4;

// stream order of repro_torch.core.format.STREAMS
enum { MAPG, MAPA, LENG, LENA, CNTG, CNTA, MPG, MPA, MBB, IDG, IDL, IBS, RFL, ESC };
// adaptive kinds
enum { K_MAP, K_LEN, K_CNT, K_MP };

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

SAGE_DEV int cons_at(const uint32_t* cw, int window, int idx) {
  idx = sage::iclamp(idx, 0, window - 1);
  return (int)((cw[idx >> 4] >> (2 * (idx & 15))) & 3u);
}

// number of entries of the non-decreasing arr[0..n) that are <= x
// (jnp.searchsorted(arr, x, side="right"))
SAGE_DEV int upper_bound(const int* arr, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (arr[mid] <= x) lo = mid + 1; else hi = mid;
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

// One CTA's scratch slot: the block's temporaries over R, M and C.
struct Slot {
  int* zpos;
  // per segment
  int *r_map, *r_len, *r_cnt, *r_rev, *r_cont, *r_corner, *r_pos, *r_start, *r_cumlen,
      *r_cntend, *r_cntstart, *r_escstart, *r_rid, *rd_rev, *rd_pos, *rd_start, *rd_len,
      *rd_corner;
  // per mismatch
  int *m_mp, *m_gcmp, *m_seg, *m_mbb, *m_isind, *m_indrank, *m_isins, *m_inslen, *m_dellen,
      *m_ibsoff, *m_gcsh;
  // per token
  int *c_seg, *c_sub, *c_delat, *c_insmark, *c_inslen0, *c_insoff0, *c_gcdel, *c_lastins,
      *c_cons, *c_gccons, *c_tok;

  SAGE_DEV Slot(int* s, int R, int M, int C) {
    zpos = s; s += sage::imax(R, M);
    int** seg[] = {&r_map, &r_len, &r_cnt, &r_rev, &r_cont, &r_corner, &r_pos, &r_start,
                   &r_cumlen, &r_cntend, &r_cntstart, &r_escstart, &r_rid, &rd_rev, &rd_pos,
                   &rd_start, &rd_len, &rd_corner};
    for (int** q : seg) { *q = s; s += R; }
    int** mis[] = {&m_mp, &m_gcmp, &m_seg, &m_mbb, &m_isind, &m_indrank, &m_isins, &m_inslen,
                   &m_dellen, &m_ibsoff, &m_gcsh};
    for (int** q : mis) { *q = s; s += M; }
    int** tok[] = {&c_seg, &c_sub, &c_delat, &c_insmark, &c_inslen0, &c_insoff0, &c_gcdel,
                   &c_lastins, &c_cons, &c_gccons, &c_tok};
    for (int** q : tok) { *q = s; s += C; }
  }
};

// ints of one Slot (keep in step with the constructor above)
inline long long slot_ints(int R, int M, int C) {
  return (long long)(R > M ? R : M) + 18LL * R + 11LL * M + 11LL * C;
}

// Decode resident row `src` into output lane `lane` (masked by `valid`):
// the lane's token row and its five read planes. Ends without a barrier: the
// caller runs __syncthreads() before the slot is reused or the row reread.
SAGE_DEV void decode_block(const DecodeParams& p, const Slot& S, int src, int lane, int valid,
                           int* sh) {
  using namespace sage;
  const int R = p.R, M = p.M, C = p.C;
  const int32_t* row = p.dir + (long long)src * p.ndir;
  const int n_segs = wmul(row[p.d_n_segs], valid);
  const int n_mism = wmul(row[p.d_n_mism], valid);
  const int n_tok = wmul(row[p.d_n_tokens], valid);
  const int n_reads = wmul(row[p.d_n_reads], valid);
  const int base_local = row[p.d_base_pos];
  const int cons_start = row[p.d_cons_start];
  const uint32_t* st[NSTREAMS];
#pragma unroll
  for (int k = 0; k < NSTREAMS; ++k) st[k] = p.streams[k] + (long long)src * p.widths[k];
  const int* W = p.widths;
  const uint32_t* cw = p.cons + (long long)src * p.cons_w;

  // ---- per-segment streams --------------------------------------------
  decode_adaptive(st[MAPG], W[MAPG], st[MAPA], W[MAPA], n_segs, p.cls_w[K_MAP],
                  p.ncls[K_MAP], R, S.zpos, S.r_map, sh);
  if (!p.fixed_len)
    decode_adaptive(st[LENG], W[LENG], st[LENA], W[LENA], n_segs, p.cls_w[K_LEN],
                    p.ncls[K_LEN], R, S.zpos, S.r_len, sh);
  decode_adaptive(st[CNTG], W[CNTG], st[CNTA], W[CNTA], n_segs, p.cls_w[K_CNT],
                  p.ncls[K_CNT], R, S.zpos, S.r_cnt, sh);
  decode_adaptive(st[MPG], W[MPG], st[MPA], W[MPA], n_mism, p.cls_w[K_MP],
                  p.ncls[K_MP], M, S.zpos, S.m_mp, sh);
  for (int r = threadIdx.x; r < R; r += NT) {
    const int m = r < n_segs;
    const int rfl = extract(st[RFL], W[RFL], 3 * r, 3);
    S.r_rev[r] = (rfl & 1) & m;
    S.r_cont[r] = ((rfl >> 1) & 1) & m;
    S.r_corner[r] = ((rfl >> 2) & 1) & m;
    S.r_len[r] = m ? (p.fixed_len ? p.fixed_len : S.r_len[r]) : 0;
    S.r_cnt[r] = m ? S.r_cnt[r] : 0;
  }
  // token-axis scatter targets start clean for this block
  for (int t = threadIdx.x; t < C; t += NT) {
    S.c_sub[t] = -1;
    S.c_delat[t] = 0;
    S.c_insmark[t] = -1;
    S.c_inslen0[t] = 0;
    S.c_insoff0[t] = 0;
  }
  for (int r = threadIdx.x; r < R; r += NT) {
    S.rd_rev[r] = 0;
    S.rd_pos[r] = -1;
    S.rd_start[r] = 0;
    S.rd_len[r] = 0;
    S.rd_corner[r] = 0;
  }
  __syncthreads();

  // ---- segment positions and token layout (scans over R) ---------------
  auto is_chain = [&](int r) { return r < n_segs && S.r_cont[r] == 0 && S.r_corner[r] == 0; };
  cta_scan<NT, K, Sum>(
      R, [&](int r) { return is_chain(r) ? S.r_map[r] : 0; },
      [&](int r, int incl) {
        const int acc = wadd(base_local, incl);
        const int v = S.r_map[r];
        const int unzig = (v >> 1) ^ -(v & 1);
        S.r_pos[r] = S.r_cont[r] == 1 ? wadd(acc, unzig) : acc;
      },
      sh);
  cta_scan<NT, K, Sum>(
      R, [&](int r) { return S.r_len[r]; },
      [&](int r, int incl) { S.r_cumlen[r] = incl; S.r_start[r] = wsub(incl, S.r_len[r]); }, sh);
  cta_scan<NT, K, Sum>(
      R, [&](int r) { return S.r_cnt[r]; },
      [&](int r, int incl) { S.r_cntend[r] = incl; S.r_cntstart[r] = wsub(incl, S.r_cnt[r]); },
      sh);
  cta_scan<NT, K, Sum>(
      R, [&](int r) { return S.r_corner[r] == 1 ? S.r_len[r] : 0; },
      [&](int r, int incl) {
        S.r_escstart[r] = wsub(incl, S.r_corner[r] == 1 ? S.r_len[r] : 0);
      },
      sh);
  auto read_first = [&](int r) { return (r < n_segs && S.r_cont[r] == 0) ? 1 : 0; };
  cta_scan<NT, K, Sum>(
      R, read_first, [&](int r, int incl) { S.r_rid[r] = incl - read_first(r); }, sh);
  __syncthreads();

  // ---- per-read grouping (scatter-max / scatter-add over read ids) -----
  for (int r = threadIdx.x; r < R; r += NT) {
    const int rid = S.r_rid[r];
    if (read_first(r)) {
      atomicMax(S.rd_rev + rid, S.r_rev[r]);
      atomicMax(S.rd_pos + rid, S.r_corner[r] == 1 ? -1 : S.r_pos[r]);
      atomicMax(S.rd_start + rid, S.r_start[r]);
      atomicMax(S.rd_corner + rid, S.r_corner[r]);
    }
    if (r < n_segs) atomicAdd(S.rd_len + rid, S.r_len[r]);
  }

  // ---- mismatch -> segment mapping, indel decode (scans over M) --------
  for (int m = threadIdx.x; m < M; m += NT) {
    S.m_seg[m] = iclamp(upper_bound(S.r_cntend, R, m), 0, R - 1);
    const int mbb = m < n_mism ? extract(st[MBB], W[MBB], 2 * m, 2) : 0;
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
    return extract(st[IDG], W[IDG], 2 * iclamp(S.m_indrank[m], 0, p.I - 1), 2);
  };
  auto is_multi = [&](int m) { return S.m_isind[m] * ((idg_of(m) >> 1) & 1); };
  cta_scan<NT, K, Sum>(
      M, is_multi,
      [&](int m, int incl) {
        const int mul = is_multi(m);
        const int mul_rank = incl - mul;
        const int is_ind = S.m_isind[m];
        const int is_ins = is_ind * (idg_of(m) & 1);
        const int ilen = (mul == 1 ? extract(st[IDL], W[IDL], 8 * iclamp(mul_rank, 0, p.U - 1), 8)
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

  // ---- scatter mismatches onto the token axis --------------------------
  for (int m = threadIdx.x; m < M; m += NT) {
    const int seg = S.m_seg[m];
    const int first = S.r_cntstart[seg];
    const int p_m = seg_cumsum_at(S.m_gcmp, S.m_mp, M, m, first);
    const int f = iclamp(first, 0, M - 1);
    const int shift = wsub(wsub(S.m_gcsh[m], wsub(S.m_gcsh[f], dshift(f))), dshift(m));
    const int cursor = wadd(wadd(S.r_pos[seg], p_m), shift);
    const int mbb = S.m_mbb[m];
    const int sub_base = mbb + (mbb >= cons_at(cw, p.window, cursor) ? 1 : 0);
    const int t_m = wadd(S.r_start[seg], p_m);
    if (m < n_mism) {
      const int t = iclamp(t_m, 0, C - 1);
      if (mbb < 3) S.c_sub[t] = sub_base;
      if (S.m_dellen[m]) atomicAdd(S.c_delat + t, S.m_dellen[m]);
      if (S.m_isins[m] == 1) {
        atomicMax(S.c_insmark + t, t_m);
        atomicMax(S.c_inslen0 + t, S.m_inslen[m]);
        atomicMax(S.c_insoff0 + t, S.m_ibsoff[m]);
      }
    }
  }
  for (int t = threadIdx.x; t < C; t += NT)
    S.c_seg[t] = iclamp(upper_bound(S.r_cumlen, R, t), 0, R - 1);
  __syncthreads();

  // ---- deletion shift and insertion coverage (scans over C) ------------
  cta_scan<NT, K, Sum>(
      C, [&](int t) { return S.c_delat[t]; }, [&](int t, int incl) { S.c_gcdel[t] = incl; }, sh);
  cta_scan<NT, K, Max>(
      C, [&](int t) { return S.c_insmark[t]; }, [&](int t, int incl) { S.c_lastins[t] = incl; },
      sh);
  __syncthreads();
  auto consumes = [&](int t) {
    const int lis_raw = S.c_lastins[t];
    const int lis = iclamp(lis_raw, 0, C - 1);
    const bool tok = t < n_tok;
    const bool inside = lis_raw >= 0 && wsub(t, lis_raw) < S.c_inslen0[lis] && tok;
    return (tok && !inside) ? 1 : 0;
  };
  cta_scan<NT, K, Sum>(
      C, consumes, [&](int t, int incl) { S.c_gccons[t] = incl; S.c_cons[t] = consumes(t); }, sh);
  __syncthreads();

  // ---- consensus-derived, inserted, substituted and escape tokens ------
  for (int t = threadIdx.x; t < C; t += NT) {
    const int seg = S.c_seg[t];
    const int sst = S.r_start[seg];
    int tok;
    if (S.r_corner[seg] == 1) {
      const int esc_idx = wadd(S.r_escstart[seg], wsub(t, sst));
      tok = extract(st[ESC], W[ESC], 3 * iclamp(esc_idx, 0, p.escb), 3);
    } else if (t < n_tok && !S.c_cons[t]) {  // inside an insertion
      const int lis_raw = S.c_lastins[t];
      const int lis = iclamp(lis_raw, 0, C - 1);
      const int ibs_idx = wadd(S.c_insoff0[lis], wsub(t, lis_raw));
      tok = extract(st[IBS], W[IBS], 2 * iclamp(ibs_idx, 0, p.insb), 2);
    } else if (S.c_sub[t] >= 0) {
      tok = S.c_sub[t];
    } else {
      const int del_shift = seg_cumsum_at(S.c_gcdel, S.c_delat, C, t, sst);
      const int cc = wsub(seg_cumsum_at(S.c_gccons, S.c_cons, C, t, sst), S.c_cons[t]);
      tok = cons_at(cw, p.window, wadd(wadd(S.r_pos[seg], cc), del_shift));
    }
    S.c_tok[t] = tok;
  }
  __syncthreads();

  // ---- reverse complement over the finished row, masked output ---------
  int8_t* out = p.tokens + (long long)lane * C;
  for (int t = threadIdx.x; t < C; t += NT) {
    int o = 4;  // PAD_BASE
    if (t < n_tok) {
      const int rid = S.r_rid[S.c_seg[t]];
      const bool rev = S.rd_rev[rid] == 1;
      const int rs = S.rd_start[rid];
      const int src_t = rev ? wadd(rs, wsub(wsub(S.rd_len[rid], 1), wsub(t, rs))) : t;
      o = S.c_tok[iclamp(src_t, 0, C - 1)];
      if (rev && o < 4) o = 3 - o;
    }
    out[t] = (int8_t)o;
  }
  const long long ro = (long long)lane * R;
  for (int r = threadIdx.x; r < R; r += NT) {
    const bool m = r < n_reads;
    const int pos = S.rd_pos[r];
    p.read_pos[ro + r] = m ? wadd(pos, pos >= 0 ? cons_start : 0) : -1;
    p.read_rev[ro + r] = m ? S.rd_rev[r] : 0;
    p.read_start[ro + r] = m ? S.rd_start[r] : 0;
    p.read_len[ro + r] = m ? S.rd_len[r] : 0;
    p.read_corner[ro + r] = m ? S.rd_corner[r] : 0;
  }
}

}  // namespace sage_decode
