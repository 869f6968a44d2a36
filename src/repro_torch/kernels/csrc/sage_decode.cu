// SAGe block decode: 14 packed stream rows + consensus window -> base tokens
// and per-read metadata, one SAGe block per CTA.
//
// Replaces the TPU kernel `_kernel` / `_build_pallas_decode` /
// `sage_decode_arrays` (src/repro/kernels/sage_decode.py), whose body is
// `decode_block_arrays` (src/repro/core/decode_jax.py). Every phase below
// mirrors that function line for line, in int32 with the same clipping.
//
// Design: a bounded persistent grid (a few CTAs per SM) walks the blocks,
// `for (b = blockIdx.x; b < nb; b += gridDim.x)`. A block's temporaries are
// ~11 int32 arrays over the token axis (C ~ 65 Ki) plus ~11 over mismatches
// and ~18 over segments: megabytes, far beyond shared memory, so each CTA
// owns one slot of global scratch (allocated by the wrapper, one slot per
// CTA, not per block: ~3 MB at C = 65558). Phases are separated by
// __syncthreads(); scans over R, M and C are tile loops with a running carry
// (sage_common.cuh); scatter-max / scatter-add land in scratch with atomics.
// The reverse-complement gather reads the finished token row, so it runs in
// its own phase after the row is complete.
//
// Bound on the H100: bytes. Per block the kernel must read its stream rows,
// consensus window and directory row and write C int8 tokens plus 5*R int32
// read planes: ~81 KB per Illumina block at token_target 65536, so a
// 256-block bucket needs ~20.7 MB, 6.2 us at 3.35 TB/s. Everything else is
// scratch traffic (the slots of all resident CTAs together exceed the 50 MB
// L2, so it reaches HBM) that a faster version would keep on chip.
#include "sage_common.cuh"

static constexpr int NSTREAMS = 14;
static constexpr int MAXCLS = 8;

// Parameter block, filled by the ctypes wrapper (same field order).
struct DecodeParams {
  const uint32_t* streams[NSTREAMS];  // (nb, widths[s]) rows
  int widths[NSTREAMS];
  const uint32_t* cons;  // (nb, cons_w)
  const int32_t* dir;    // (nb, ndir) block-local directory rows
  const int32_t* valid;  // (nb,) lane mask, or null
  int cons_w;
  int ndir;
  int nb;
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
};

namespace {

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

__global__ void __launch_bounds__(NT) sage_decode_kernel(DecodeParams p) {
  using namespace sage;
  SAGE_SMEM(int, sh);  // NT/32 ints of scan scratch
  const int R = p.R, M = p.M, C = p.C;
  int* s = p.scratch + (long long)blockIdx.x * p.slot_ints;
  int* zpos = s; s += imax(R, M);
  // per segment
  int* r_map = s; s += R;
  int* r_len = s; s += R;
  int* r_cnt = s; s += R;
  int* r_rev = s; s += R;
  int* r_cont = s; s += R;
  int* r_corner = s; s += R;
  int* r_pos = s; s += R;
  int* r_start = s; s += R;
  int* r_cumlen = s; s += R;
  int* r_cntend = s; s += R;
  int* r_cntstart = s; s += R;
  int* r_escstart = s; s += R;
  int* r_rid = s; s += R;
  int* rd_rev = s; s += R;
  int* rd_pos = s; s += R;
  int* rd_start = s; s += R;
  int* rd_len = s; s += R;
  int* rd_corner = s; s += R;
  // per mismatch
  int* m_mp = s; s += M;
  int* m_gcmp = s; s += M;
  int* m_seg = s; s += M;
  int* m_mbb = s; s += M;
  int* m_isind = s; s += M;
  int* m_indrank = s; s += M;
  int* m_isins = s; s += M;
  int* m_inslen = s; s += M;
  int* m_dellen = s; s += M;
  int* m_ibsoff = s; s += M;
  int* m_gcsh = s; s += M;
  // per token
  int* c_seg = s; s += C;
  int* c_sub = s; s += C;
  int* c_delat = s; s += C;
  int* c_insmark = s; s += C;
  int* c_inslen0 = s; s += C;
  int* c_insoff0 = s; s += C;
  int* c_gcdel = s; s += C;
  int* c_lastins = s; s += C;
  int* c_cons = s; s += C;
  int* c_gccons = s; s += C;
  int* c_tok = s; s += C;

  for (int b = blockIdx.x; b < p.nb; b += gridDim.x) {
    const int32_t* row = p.dir + (long long)b * p.ndir;
    const int valid = p.valid ? p.valid[b] : 1;
    const int n_segs = wmul(row[p.d_n_segs], valid);
    const int n_mism = wmul(row[p.d_n_mism], valid);
    const int n_tok = wmul(row[p.d_n_tokens], valid);
    const int n_reads = wmul(row[p.d_n_reads], valid);
    const int base_local = row[p.d_base_pos];
    const int cons_start = row[p.d_cons_start];
    const uint32_t* st[NSTREAMS];
#pragma unroll
    for (int k = 0; k < NSTREAMS; ++k) st[k] = p.streams[k] + (long long)b * p.widths[k];
    const int* W = p.widths;
    const uint32_t* cw = p.cons + (long long)b * p.cons_w;

    // ---- per-segment streams --------------------------------------------
    decode_adaptive(st[MAPG], W[MAPG], st[MAPA], W[MAPA], n_segs, p.cls_w[K_MAP],
                    p.ncls[K_MAP], R, zpos, r_map, sh);
    if (!p.fixed_len)
      decode_adaptive(st[LENG], W[LENG], st[LENA], W[LENA], n_segs, p.cls_w[K_LEN],
                      p.ncls[K_LEN], R, zpos, r_len, sh);
    decode_adaptive(st[CNTG], W[CNTG], st[CNTA], W[CNTA], n_segs, p.cls_w[K_CNT],
                    p.ncls[K_CNT], R, zpos, r_cnt, sh);
    decode_adaptive(st[MPG], W[MPG], st[MPA], W[MPA], n_mism, p.cls_w[K_MP],
                    p.ncls[K_MP], M, zpos, m_mp, sh);
    for (int r = threadIdx.x; r < R; r += NT) {
      const int m = r < n_segs;
      const int rfl = extract(st[RFL], W[RFL], 3 * r, 3);
      r_rev[r] = (rfl & 1) & m;
      r_cont[r] = ((rfl >> 1) & 1) & m;
      r_corner[r] = ((rfl >> 2) & 1) & m;
      r_len[r] = m ? (p.fixed_len ? p.fixed_len : r_len[r]) : 0;
      r_cnt[r] = m ? r_cnt[r] : 0;
    }
    // token-axis scatter targets start clean for this block
    for (int t = threadIdx.x; t < C; t += NT) {
      c_sub[t] = -1;
      c_delat[t] = 0;
      c_insmark[t] = -1;
      c_inslen0[t] = 0;
      c_insoff0[t] = 0;
    }
    for (int r = threadIdx.x; r < R; r += NT) {
      rd_rev[r] = 0;
      rd_pos[r] = -1;
      rd_start[r] = 0;
      rd_len[r] = 0;
      rd_corner[r] = 0;
    }
    __syncthreads();

    // ---- segment positions and token layout (scans over R) ---------------
    auto is_chain = [&](int r) { return r < n_segs && r_cont[r] == 0 && r_corner[r] == 0; };
    cta_scan<NT, K, Sum>(
        R, [&](int r) { return is_chain(r) ? r_map[r] : 0; },
        [&](int r, int incl) {
          const int acc = wadd(base_local, incl);
          const int v = r_map[r];
          const int unzig = (v >> 1) ^ -(v & 1);
          r_pos[r] = r_cont[r] == 1 ? wadd(acc, unzig) : acc;
        },
        sh);
    cta_scan<NT, K, Sum>(
        R, [&](int r) { return r_len[r]; },
        [&](int r, int incl) { r_cumlen[r] = incl; r_start[r] = wsub(incl, r_len[r]); }, sh);
    cta_scan<NT, K, Sum>(
        R, [&](int r) { return r_cnt[r]; },
        [&](int r, int incl) { r_cntend[r] = incl; r_cntstart[r] = wsub(incl, r_cnt[r]); }, sh);
    cta_scan<NT, K, Sum>(
        R, [&](int r) { return r_corner[r] == 1 ? r_len[r] : 0; },
        [&](int r, int incl) { r_escstart[r] = wsub(incl, r_corner[r] == 1 ? r_len[r] : 0); }, sh);
    auto read_first = [&](int r) { return (r < n_segs && r_cont[r] == 0) ? 1 : 0; };
    cta_scan<NT, K, Sum>(
        R, read_first, [&](int r, int incl) { r_rid[r] = incl - read_first(r); }, sh);
    __syncthreads();

    // ---- per-read grouping (scatter-max / scatter-add over read ids) -----
    for (int r = threadIdx.x; r < R; r += NT) {
      const int rid = r_rid[r];
      if (read_first(r)) {
        atomicMax(rd_rev + rid, r_rev[r]);
        atomicMax(rd_pos + rid, r_corner[r] == 1 ? -1 : r_pos[r]);
        atomicMax(rd_start + rid, r_start[r]);
        atomicMax(rd_corner + rid, r_corner[r]);
      }
      if (r < n_segs) atomicAdd(rd_len + rid, r_len[r]);
    }

    // ---- mismatch -> segment mapping, indel decode (scans over M) --------
    for (int m = threadIdx.x; m < M; m += NT) {
      m_seg[m] = iclamp(upper_bound(r_cntend, R, m), 0, R - 1);
      const int mbb = m < n_mism ? extract(st[MBB], W[MBB], 2 * m, 2) : 0;
      m_mbb[m] = mbb;
      m_isind[m] = (m < n_mism && mbb == 3) ? 1 : 0;
    }
    __syncthreads();
    cta_scan<NT, K, Sum>(
        M, [&](int m) { return m_mp[m]; }, [&](int m, int incl) { m_gcmp[m] = incl; }, sh);
    cta_scan<NT, K, Sum>(
        M, [&](int m) { return m_isind[m]; },
        [&](int m, int incl) { m_indrank[m] = incl - m_isind[m]; }, sh);
    __syncthreads();
    auto idg_of = [&](int m) {
      return extract(st[IDG], W[IDG], 2 * iclamp(m_indrank[m], 0, p.I - 1), 2);
    };
    auto is_multi = [&](int m) { return m_isind[m] * ((idg_of(m) >> 1) & 1); };
    cta_scan<NT, K, Sum>(
        M, is_multi,
        [&](int m, int incl) {
          const int mul = is_multi(m);
          const int mul_rank = incl - mul;
          const int is_ind = m_isind[m];
          const int is_ins = is_ind * (idg_of(m) & 1);
          const int ilen = (mul == 1 ? extract(st[IDL], W[IDL], 8 * iclamp(mul_rank, 0, p.U - 1), 8)
                                     : 1) * is_ind;
          m_isins[m] = is_ins;
          m_inslen[m] = is_ins == 1 ? ilen : 0;
          m_dellen[m] = (is_ind == 1 && is_ins == 0) ? ilen : 0;
        },
        sh);
    __syncthreads();
    cta_scan<NT, K, Sum>(
        M, [&](int m) { return m_inslen[m]; },
        [&](int m, int incl) { m_ibsoff[m] = wsub(incl, m_inslen[m]); }, sh);
    auto dshift = [&](int m) { return wsub(m_dellen[m], m_inslen[m]); };
    cta_scan<NT, K, Sum>(
        M, dshift, [&](int m, int incl) { m_gcsh[m] = incl; }, sh);
    __syncthreads();

    // ---- scatter mismatches onto the token axis --------------------------
    for (int m = threadIdx.x; m < M; m += NT) {
      const int seg = m_seg[m];
      const int first = r_cntstart[seg];
      const int p_m = seg_cumsum_at(m_gcmp, m_mp, M, m, first);
      const int f = iclamp(first, 0, M - 1);
      const int shift = wsub(wsub(m_gcsh[m], wsub(m_gcsh[f], dshift(f))), dshift(m));
      const int cursor = wadd(wadd(r_pos[seg], p_m), shift);
      const int mbb = m_mbb[m];
      const int sub_base = mbb + (mbb >= cons_at(cw, p.window, cursor) ? 1 : 0);
      const int t_m = wadd(r_start[seg], p_m);
      if (m < n_mism) {
        const int t = iclamp(t_m, 0, C - 1);
        if (mbb < 3) c_sub[t] = sub_base;
        if (m_dellen[m]) atomicAdd(c_delat + t, m_dellen[m]);
        if (m_isins[m] == 1) {
          atomicMax(c_insmark + t, t_m);
          atomicMax(c_inslen0 + t, m_inslen[m]);
          atomicMax(c_insoff0 + t, m_ibsoff[m]);
        }
      }
    }
    for (int t = threadIdx.x; t < C; t += NT)
      c_seg[t] = iclamp(upper_bound(r_cumlen, R, t), 0, R - 1);
    __syncthreads();

    // ---- deletion shift and insertion coverage (scans over C) ------------
    cta_scan<NT, K, Sum>(
        C, [&](int t) { return c_delat[t]; }, [&](int t, int incl) { c_gcdel[t] = incl; }, sh);
    cta_scan<NT, K, Max>(
        C, [&](int t) { return c_insmark[t]; }, [&](int t, int incl) { c_lastins[t] = incl; }, sh);
    __syncthreads();
    auto consumes = [&](int t) {
      const int lis_raw = c_lastins[t];
      const int lis = iclamp(lis_raw, 0, C - 1);
      const bool tok = t < n_tok;
      const bool inside = lis_raw >= 0 && wsub(t, lis_raw) < c_inslen0[lis] && tok;
      return (tok && !inside) ? 1 : 0;
    };
    cta_scan<NT, K, Sum>(
        C, consumes, [&](int t, int incl) { c_gccons[t] = incl; c_cons[t] = consumes(t); }, sh);
    __syncthreads();

    // ---- consensus-derived, inserted, substituted and escape tokens ------
    for (int t = threadIdx.x; t < C; t += NT) {
      const int seg = c_seg[t];
      const int sst = r_start[seg];
      int tok;
      if (r_corner[seg] == 1) {
        const int esc_idx = wadd(r_escstart[seg], wsub(t, sst));
        tok = extract(st[ESC], W[ESC], 3 * iclamp(esc_idx, 0, p.escb), 3);
      } else if (t < n_tok && !c_cons[t]) {  // inside an insertion
        const int lis_raw = c_lastins[t];
        const int lis = iclamp(lis_raw, 0, C - 1);
        const int ibs_idx = wadd(c_insoff0[lis], wsub(t, lis_raw));
        tok = extract(st[IBS], W[IBS], 2 * iclamp(ibs_idx, 0, p.insb), 2);
      } else if (c_sub[t] >= 0) {
        tok = c_sub[t];
      } else {
        const int del_shift = seg_cumsum_at(c_gcdel, c_delat, C, t, sst);
        const int cc = wsub(seg_cumsum_at(c_gccons, c_cons, C, t, sst), c_cons[t]);
        tok = cons_at(cw, p.window, wadd(wadd(r_pos[seg], cc), del_shift));
      }
      c_tok[t] = tok;
    }
    __syncthreads();

    // ---- reverse complement over the finished row, masked output ---------
    int8_t* out = p.tokens + (long long)b * C;
    for (int t = threadIdx.x; t < C; t += NT) {
      int o = 4;  // PAD_BASE
      if (t < n_tok) {
        const int rid = r_rid[c_seg[t]];
        const bool rev = rd_rev[rid] == 1;
        const int rs = rd_start[rid];
        const int src = rev ? wadd(rs, wsub(wsub(rd_len[rid], 1), wsub(t, rs))) : t;
        o = c_tok[iclamp(src, 0, C - 1)];
        if (rev && o < 4) o = 3 - o;
      }
      out[t] = (int8_t)o;
    }
    const long long ro = (long long)b * R;
    for (int r = threadIdx.x; r < R; r += NT) {
      const bool m = r < n_reads;
      const int pos = rd_pos[r];
      p.read_pos[ro + r] = m ? wadd(pos, pos >= 0 ? cons_start : 0) : -1;
      p.read_rev[ro + r] = m ? rd_rev[r] : 0;
      p.read_start[ro + r] = m ? rd_start[r] : 0;
      p.read_len[ro + r] = m ? rd_len[r] : 0;
      p.read_corner[ro + r] = m ? rd_corner[r] : 0;
    }
    __syncthreads();  // the next block reuses this CTA's scratch slot
  }
}

}  // namespace

extern "C" long long sage_decode_slot_ints(int R, int M, int C) {
  return (long long)(R > M ? R : M) + 18LL * R + 11LL * M + 11LL * C;
}

extern "C" int sage_decode_cta_threads() { return NT; }

extern "C" int sage_decode_launch(const DecodeParams* p, int grid, void* stream) {
  if (p->nb == 0) return 0;
  sage_decode_kernel<<<grid, NT, (NT / 32) * sizeof(int), (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" const char* sage_decode_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
