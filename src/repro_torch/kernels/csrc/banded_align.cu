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
//            match = valid && r[i-1] < 4 && win[min(j, wmax-1)] == r[i-1]
//   up     = prev[c+1] + 1 (INF + 1 past the band)
//   cur    = min(diag, up); mv = up < diag ? 1 : 0
//   lft    = inclusive prefix-min over c' <= c of
//            (c' < b_lo - 1 ? INF : cur[c'] - c') + c,
//            kept only for b_lo <= c <= b_hi (b_lo = 1 - i - js0,
//            b_hi = wlen - i - js0, i.e. valid cells), else cur
//   mv     = lft < cur ? 2 : mv; cur = min(lft, cur)
// Outputs: moves (B, L, width) u8 and the last row (B, width) i32.
//
// Per cell the prefix-min is the recurrence cur[c] = min(cur0[c], cur[c-1] + 1,
// T[c]) on valid cells, with mv = 2 iff min(cur[c-1] + 1, T[c]) < cur0[c]: min
// distributes over "+ 1", and the recursion starts at c = b_lo - 1, where the
// prefix starts. T[c] = INF + c is the prefix's term for the cells
// c' < b_lo - 1; as T[c] = T[c-1] + 1 it needs adding only at the window's
// first column (j = 0), for c >= 2. It can win only where a cell just left
// of the window holds more than INF + c, i.e. where that cell's chain of up
// steps meets the band's right edge before row 0: only for js0 <= -width.
// A warp with such a lane runs the cell with the cap (two more ops a cell).
//
// Bound on the H100: operations. One Illumina chunk (1024 lanes, L 150,
// band 24: 7.53 M cells) needs 13 int32 operations a cell (named in
// chip_smoke.py, DP_OPS_PER_CELL) at 64 a clock an SM (CUDA C Programming
// Guide, compute capability 9.0) x 132 SMs x 1.98 GHz = 16.7e12 a second:
// 5.85 us, against 2.7 us for its 9.2 MB of moves, last rows, reads and
// windows at 3.35 TB/s.
//
// Design: an anti-diagonal wavefront, so no cell waits on a scan of its row.
// A lane's band is held by G threads of one warp (one to 32 lanes a warp),
// CPT consecutive positions each (CPT even, a template parameter: 2 at band
// 24, one lane a warp, two warps a scheduler); position p is band column
// c = p - v, the v = G*CPT - width virtual positions sitting in front of
// column 0. In double step d position p holds row i = d - p/2: each thread
// first computes its even positions, then its odd ones, so cell (i, p) runs
// at step 2i + p and reads its diagonal from step 2i + p - 2 and its up and
// left from step 2i + p - 1 -- all held in the thread's registers but for one
// value from the thread below (its last position, at the start of the double
// step) and one from the thread above (its first position, between the
// halves): two shuffles a double step. A lane takes L + G*CPT/2 - 1 double
// steps. The thread starting a lane sends INF up, so column width-1 sees
// up = INF + 1; column 0's left is gated by a floor of INT_MAX; rows outside
// 1..L keep their value (row 0 is zeros) and store nothing. The window
// columns and read codes are staged in shared memory, one int array a field
// (no bank conflicts), a window of double steps at a time, and each double
// step's are loaded one step ahead; double steps run in segments, two a
// trip, between the events (a flush, a restaging, the gated first and last
// lag steps), so the hot loop holds no test of them.
//
// Moves: a row is complete only when column width-1 has run, G*CPT/2 - 1
// double steps after column 0. Route "ring": rows go to a shared-memory ring
// of NR rows (a multiple of 16, at least that lag plus F), flushed every F
// double steps as 16-byte vectors (the ring keeps the destination's address
// mod 16; virtual positions store to a dummy byte). Route "direct", for bands
// whose ring does not fit in shared memory (width > ~650): each thread keeps
// its last H rows' segments in a strip of shared memory, and after every
// double step the warp stores each thread's completed segment straight to
// device memory, one byte a lane, so each store covers consecutive bytes.
#include <algorithm>

#include "sage_common.cuh"

namespace {

constexpr int INF = 1 << 20;
constexpr int NO_BASE = 5;                // staged read code of a base >= 4: matches no window code
constexpr int OFF_WINDOW = 6;             // staged window code off the window: matches no read code
constexpr int LEFT_OFF = (1 << 30) + 1;   // left step of a cell off the window: never the minimum
constexpr int MAX_WIDTH = 1024;
constexpr int MAX_ROWS = 1 << 29;         // keeps every value + LEFT_OFF below 2^31
constexpr int SMEM_CAP = 232448;          // shared memory a CTA may use on the H100
constexpr int MAX_WARPS = 4;
constexpr int MIN_FLUSH = 8;              // double steps between ring flushes, at least
constexpr int RING_SLACK = 16;            // rows of the ring past the lag, if they fit
constexpr int WINDOW_BYTES = 16384;       // a lane's staged read and window columns, at most
constexpr int MIN_WINDOW = 16;            // double steps a staging window, at least
constexpr int NUM_SMS = 132;
constexpr unsigned FULL = 0xffffffffu;
constexpr int CPT_CHOICES[] = {2, 4, 8, 12, 16, 24, 32};  // cells a thread: the fewest that fit a warp

// A lane's staging in shared memory, one int a field (consecutive threads
// read consecutive words): per window column (cell index i - 1 + c) its code
// (the window value, 4 for >= 4, OFF_WINDOW off the window), its left offset
// (1, LEFT_OFF off the window; the mismatch penalty is lft >> 10: 0 or INF)
// and its cap (INT_MIN at the window's first column, which opens the INF + c
// cap, else INT_MAX); per row its read code.
struct Staging {
  int* code;
  int* lft;
  int* cap;
  int* read;
};

struct Plan {
  int grid, threads, smem, cpt, G, lanes_per_warp, lanes_per_cta, lane_smem;
  int route;  // 1 ring, 0 direct, -1 not taken
  int nr, f, fw, dend;
  int P, v, lag, rwn, ewn, ring_bytes;
};

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

Plan make_plan(int B, int L, int band, int wmax) {
  Plan p{};
  p.route = -1;
  const int W = 2 * band + 1;
  if (band < 0 || W > MAX_WIDTH || L < 0 || L > MAX_ROWS || wmax < 1) return p;
  for (int c : CPT_CHOICES) {
    if ((W + c - 1) / c <= 32) {
      p.cpt = c;
      break;
    }
  }
  p.G = (W + p.cpt - 1) / p.cpt;
  p.P = p.G * p.cpt;
  p.v = p.P - W;
  p.lag = p.P / 2 - 1;
  p.dend = L + p.lag;
  p.lanes_per_warp = 32 / p.G;
  // staging: 16 bytes a window column and row (read, code, lft, cap); the
  // segments load up to two steps past a window
  auto staged = [&p](int fw) { return 3 * round16(4 * (p.P / 2 + fw + 3)) + round16(4 * (p.P / 2 + fw + 2)); };
  // ring: NR rows, a multiple of 16, at least lag + MIN_FLUSH, up to lag + RING_SLACK
  p.nr = (p.lag + RING_SLACK + 15) & ~15;
  while (p.nr - p.lag >= MIN_FLUSH && staged(MIN_WINDOW) + p.nr * W + 32 > SMEM_CAP) p.nr -= 16;
  const bool ring = p.nr - p.lag >= MIN_FLUSH && p.cpt <= 24;
  p.route = ring ? 1 : 0;
  p.f = ring ? p.nr - p.lag : 0;
  if (!ring) p.nr = p.cpt / 2;  // direct: each thread's strip of H rows
  // the ring, 16 bytes of address slack, a dummy byte; or the strips and one for idle threads
  p.ring_bytes = ring ? p.nr * W + 32 : (p.G + 1) * p.nr * p.cpt;
  // the window: as many double steps as WINDOW_BYTES (or what the ring leaves) stage
  p.fw = std::min(WINDOW_BYTES, SMEM_CAP - p.ring_bytes) / 16 - p.P / 2 - 4;
  p.fw = std::min(std::max(p.fw, MIN_WINDOW), std::max(p.dend, 1));
  p.rwn = p.P / 2 + p.fw + 2;
  p.ewn = p.P / 2 + p.fw + 3;
  p.lane_smem = staged(p.fw) + p.ring_bytes;
  if (!ring) p.lanes_per_warp = 1;  // the strips' stores take the whole warp
  if (p.lane_smem > SMEM_CAP) {
    p.route = -1;
    return p;
  }
  int warps = (B + p.lanes_per_warp * NUM_SMS - 1) / (p.lanes_per_warp * NUM_SMS);
  if (warps < 1) warps = 1;
  if (warps > MAX_WARPS) warps = MAX_WARPS;
  int lpw = p.lanes_per_warp;
  while (warps > 1 && warps * lpw * p.lane_smem > SMEM_CAP) --warps;
  while (lpw > 1 && lpw * p.lane_smem > SMEM_CAP) --lpw;
  p.lanes_per_warp = lpw;
  p.lanes_per_cta = warps * lpw;
  p.threads = warps * 32;
  p.smem = p.lanes_per_cta * p.lane_smem;
  p.grid = B > 0 ? (B + p.lanes_per_cta - 1) / p.lanes_per_cta : 0;
  return p;
}

// Stage the read codes and window columns of double steps [d0, d0 + fw):
// read[x] is row d0 - P/2 + x + 1's base, code/lft/cap[x] the column of cell
// index (i - 1 + c) = d0 - 1 - v + x. The group's G threads share the work.
SAGE_DEV void stage(const Staging& sg, const int32_t* rd, const int32_t* wsrc, const Plan& p, int d0,
                    int L, int js0, int wl, int wmax, int k) {
  const int n = sage::imax(p.rwn, p.ewn);
#pragma unroll 8
  for (int x = k; x < n; x += p.G) {
    const int r = d0 - p.P / 2 + x;
    const int j = sage::wadd(js0, d0 - 1 - p.v + x);
    const bool ok = j >= 0 && j < wl;
    const int base = r >= 0 && r < L ? rd[r] : NO_BASE;
    const int w = ok ? wsrc[j < wmax ? j : wmax - 1] : 0;
    if (x < p.rwn) sg.read[x] = base < 4 ? base : NO_BASE;
    if (x < p.ewn) {
      sg.code[x] = ok ? (w < 4 ? w : 4) : OFF_WINDOW;
      sg.lft[x] = ok ? 1 : LEFT_OFF;
      sg.cap[x] = ok && j == 0 ? INT_MIN : INT_MAX;
    }
  }
}

// Copy the lane's move bytes [g0, g1) from the ring, where byte g sits at
// ring[mis + g % rb] (rb a multiple of 16, mis the destination's address mod
// 16), to dst: the 16-byte aligned groups as vectors, the rest byte by byte.
SAGE_DEV void flush(const uint8_t* ring, int mis, int rb, uint8_t* dst, long long g0,
                    long long g1, int k, int G) {
  if (g1 <= g0) return;
  const int n = (int)(g1 - g0);
  const int head = sage::imin(n, (16 - (int)((mis + g0) & 15)) & 15);
  const int o0 = (int)(g0 % rb);
  uint8_t* d = dst + g0;
  for (int x = k; x < head; x += G) {
    const int o = o0 + x;
    d[x] = ring[mis + (o >= rb ? o - rb : o)];
  }
  const int nv = (n - head) >> 4;
  for (int u = k; u < nv; u += G) {
    int o = o0 + head + 16 * u;
    o = o >= rb ? o - rb : o;
    uint8_t* t = d + head + 16 * u;
    if (o + 16 <= rb) {
      *reinterpret_cast<uint4*>(t) = *reinterpret_cast<const uint4*>(ring + mis + o);
    } else {
      for (int s = 0; s < 16; ++s) t[s] = ring[mis + (o + s >= rb ? o + s - rb : o + s)];
    }
  }
  for (int x = head + 16 * nv + k; x < n; x += G) {
    const int o = o0 + x;
    d[x] = ring[mis + (o >= rb ? o - rb : o)];
  }
}

// A thread's state: the value of each of its positions (the row it last
// computed), column 0's floor, each position's store multiplier and offset
// in the ring (0 and a dummy byte for the virtual positions), each pair's slot.
template <int CPT, bool RING>
struct Thread {
  int val[CPT], fl[CPT], wq[RING ? CPT : 1], cq[RING ? CPT : 1], slot[CPT / 2];
};

// What the cells of one double step read from the staging: each pair's read
// code and the H + 1 window columns of the thread's positions.
template <int CPT, bool CAP>
struct Inputs {
  int r[CPT / 2], code[CPT / 2 + 1], lft[CPT / 2 + 1], cap[CAP ? CPT / 2 + 1 : 1];
};

template <int CPT, bool CAP>
SAGE_DEV void load_inputs(Inputs<CPT, CAP>& in, const Staging& sg, int ri, int ei) {
#pragma unroll
  for (int m = 0; m < CPT / 2; ++m) in.r[m] = sg.read[ri - m];
#pragma unroll
  for (int t = 0; t <= CPT / 2; ++t) {
    in.code[t] = sg.code[ei + t];
    in.lft[t] = sg.lft[ei + t];
    if constexpr (CAP) in.cap[t] = sg.cap[ei + t];
  }
}

struct Lane {  // what a cell needs of its lane
  uint8_t* ring;  // the ring (route ring) or the thread's strip (route direct)
  uint8_t* mrow;
  int L, W, c0;
  bool live;
};

// Cell (row D - m, position q): diag from the position's own value, up and
// left as given; the move goes to the ring (or the strip) if row in 1..L.
template <int CPT, bool RING, bool CAP>
SAGE_DEV void cell(Thread<CPT, RING>& th, const Lane& ln, const Inputs<CPT, CAP>& in, int q, int m, int t,
                   int up_in, int left_in, bool ok) {
  const int pen = (int)__umulhi((unsigned)in.lft[t], 1u << 22);  // lft >> 10 on the multiplier
  const int diag = th.val[q] + (int)umin((unsigned)(in.r[m] ^ in.code[t]), 1u) + pen;
  bool p1, p2;
  const int cur0 = __vibmin_s32(diag, up_in + 1, &p1);
  int lf = __viaddmax_s32(left_in, in.lft[t], th.fl[q]);
  if constexpr (CAP) lf = sage::imin(lf, sage::imax(ln.c0 + q >= 2 ? INF + ln.c0 + q : INT_MAX, in.cap[t]));
  const int cur = __vibmin_s32(cur0, lf, &p2);
  const uint8_t mv = p2 ? (p1 ? 0 : 1) : 2;
  if (ok) {
    th.val[q] = cur;
    if constexpr (RING) {
      ln.ring[th.slot[m] * th.wq[q] + th.cq[q]] = mv;
    } else {
      ln.ring[th.slot[m] * CPT + q] = mv;
    }
  }
}

// One double step: even positions, then odd ones. GATED: rows outside 1..L
// keep their value and store nothing (the first and last lag double steps).
// CAP: the left step is capped by INF + c at the window's first column.
template <int CPT, bool RING, bool GATED, bool CAP>
SAGE_DEV void double_step(Thread<CPT, RING>& th, const Lane& ln, const Inputs<CPT, CAP>& in, int D,
                          bool send_inf, int lane) {
  constexpr int H = CPT / 2;
  bool ok[H];
#pragma unroll
  for (int m = 0; m < H; ++m) ok[m] = !GATED || (unsigned)(D - m - 1) < (unsigned)ln.L;
  const int left = __shfl_sync(FULL, th.val[CPT - 1], (lane + 31) & 31);
#pragma unroll
  for (int m = 0; m < H; ++m)
    cell<CPT, RING, CAP>(th, ln, in, 2 * m, m, m, th.val[2 * m + 1], m == 0 ? left : th.val[2 * m - 1], ok[m]);
  const int nb = __shfl_sync(FULL, send_inf ? INF : th.val[0], (lane + 1) & 31);
#pragma unroll
  for (int m = 0; m < H; ++m)
    cell<CPT, RING, CAP>(th, ln, in, 2 * m + 1, m, m + 1, m == H - 1 ? nb : th.val[2 * m + 2], th.val[2 * m],
                         ok[m]);
}

// Everything of a lane that is not a cell: its staging and where it reads.
struct Sched {
  Staging sg;
  const int32_t* rd;
  const int32_t* wsrc;
  int d0;  // first double step of the staged window
  int js0, wl, wmax, mis, rb, k;
  bool idle;
};

template <int CPT, bool CAP>
SAGE_DEV void load_step(Inputs<CPT, CAP>& in, const Sched& sc, const Plan& p, int d) {
  constexpr int H = CPT / 2;
  load_inputs<CPT, CAP>(in, sc.sg, (d - sc.d0) + p.P / 2 - sc.k * H - 1, (d - sc.d0) + sc.k * H);
}

template <int CPT, bool RING>
SAGE_DEV void next_slot(Thread<CPT, RING>& th, int nr) {
#pragma unroll
  for (int m = 0; m < CPT / 2; ++m)
    th.slot[m] = (int)__viaddmin_u32((unsigned)th.slot[m], 1u, (unsigned)(th.slot[m] + 1 - nr));
}

// Direct route, after double step d: thread t's strip holds its whole
// segment (CPT columns) of row d - t*H - H + 1, in slot d mod H. The warp
// stores every thread's segment in turn, one byte a lane, so each store
// covers consecutive bytes of one row.
template <int CPT>
SAGE_DEV void store_segments(const Lane& ln, const Plan& p, uint8_t* strips, int d, int lane) {
  constexpr int H = CPT / 2;
  __syncwarp();
  if (lane < CPT) {  // the direct route holds one lane a warp, live past the kernel's early return
    int r = d - H + 1;
    const uint8_t* src = strips + (d % H) * CPT + lane;
    long long dst = (long long)(r - 1) * ln.W - p.v + lane;
#pragma unroll 8
    for (int t = 0; t < p.G; ++t, r -= H, src += H * CPT, dst += CPT - (long long)H * ln.W)
      if (r >= 1 && r <= ln.L && (t > 0 || lane >= p.v)) ln.mrow[dst] = *src;
  }
  __syncwarp();
}

// Double steps d..stop, none of them at an event: two a trip, each loading
// the next one's inputs into the other buffer. `a` holds step d's inputs
// on entry and step stop + 1's on exit.
template <int CPT, bool RING, bool GATED, bool CAP>
SAGE_DEV void segment(Thread<CPT, RING>& th, const Lane& ln, const Sched& sc, const Plan& p,
                      Inputs<CPT, CAP>& a, int& d, int stop, uint8_t* strips, bool send_inf, int lane) {
  constexpr int H = CPT / 2;
  Inputs<CPT, CAP> b;
  for (; d < stop; d += 2) {
    load_step<CPT, CAP>(b, sc, p, d + 1);
    double_step<CPT, RING, GATED, CAP>(th, ln, a, d - sc.k * H, send_inf, lane);
    next_slot<CPT, RING>(th, p.nr);
    if constexpr (!RING) store_segments<CPT>(ln, p, strips, d, lane);
    load_step<CPT, CAP>(a, sc, p, d + 2);
    double_step<CPT, RING, GATED, CAP>(th, ln, b, d + 1 - sc.k * H, send_inf, lane);
    next_slot<CPT, RING>(th, p.nr);
    if constexpr (!RING) store_segments<CPT>(ln, p, strips, d + 1, lane);
  }
  if (d == stop) {
    load_step<CPT, CAP>(b, sc, p, d + 1);
    double_step<CPT, RING, GATED, CAP>(th, ln, a, d - sc.k * H, send_inf, lane);
    next_slot<CPT, RING>(th, p.nr);
    if constexpr (!RING) store_segments<CPT>(ln, p, strips, d, lane);
    a = b;
    ++d;
  }
}

// Every double step of the lane, in segments that end at the next event:
// the end of the first lag steps (rows below 1) or of step L (rows past L
// follow), a ring flush every F steps, a restaging every window.
template <int CPT, bool RING, bool CAP>
SAGE_DEV void sweep_all(Thread<CPT, RING>& th, const Lane& ln, Sched& sc, const Plan& p, uint8_t* strips,
                        bool send_inf, int lane) {
  const int lag = p.lag, L = ln.L, dend = p.dend, f = p.f, fw = p.fw;
  int next_flush = RING ? f : INT_MAX, next_fill = 1 + fw, done = 0;
  Inputs<CPT, CAP> a;
  load_step<CPT, CAP>(a, sc, p, 1);
  int d = 1;
  while (d <= dend) {
    const bool gated = d <= lag || d > L;
    int stop = sage::imin(sage::imin(dend, next_flush), next_fill - 1);
    if (d <= lag) stop = sage::imin(stop, lag);
    else if (d <= L) stop = sage::imin(stop, L);
    if (gated) {
      segment<CPT, RING, true, CAP>(th, ln, sc, p, a, d, stop, strips, send_inf, lane);
    } else {
      segment<CPT, RING, false, CAP>(th, ln, sc, p, a, d, stop, strips, send_inf, lane);
    }
    if (RING && (stop == next_flush || stop == dend)) {  // rows up to stop - lag are complete
      const int top = sage::imin(stop - lag, L);
      __syncwarp();
      if (ln.live && top > done)
        flush(ln.ring, sc.mis, sc.rb, ln.mrow, (long long)done * ln.W, (long long)top * ln.W, sc.k, p.G);
      __syncwarp();
      done = sage::imax(done, top);
      if (stop == next_flush) next_flush += f;
    }
    if (stop + 1 == next_fill && stop < dend) {
      sc.d0 = stop + 1;
      next_fill += fw;
      __syncwarp();
      if (!sc.idle) stage(sc.sg, sc.rd, sc.wsrc, p, sc.d0, L, sc.js0, sc.wl, sc.wmax, sc.k);
      __syncwarp();
      load_step<CPT, CAP>(a, sc, p, d);
    }
  }
}

template <int CPT, bool RING>
__global__ void __launch_bounds__(MAX_WARPS * 32)
align_scan_kernel(const int32_t* __restrict__ reads, const int32_t* __restrict__ wins,
                  const int32_t* __restrict__ off0, const int32_t* __restrict__ wlen,
                  uint8_t* __restrict__ moves, int32_t* __restrict__ last,
                  int B, int L, int band, int wmax, const __grid_constant__ Plan p) {
  constexpr int H = CPT / 2;
  SAGE_SMEM(uint8_t, sm);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (blockIdx.x * p.lanes_per_cta + warp * p.lanes_per_warp >= B) return;  // a whole warp
  const int W = 2 * band + 1;
  const int grp = lane / p.G, k = lane - grp * p.G;
  const bool idle = grp >= p.lanes_per_warp;  // lanes past the warp's groups compute on group 0's staging
  const int slot_lane = warp * p.lanes_per_warp + (idle ? 0 : grp);
  const int b = blockIdx.x * p.lanes_per_cta + slot_lane;
  const int bl = b < B ? b : B - 1;
  uint8_t* lsm = sm + (size_t)slot_lane * p.lane_smem;
  const int ecols = round16(4 * p.ewn);

  Sched sc;
  sc.sg.code = reinterpret_cast<int*>(lsm);
  sc.sg.lft = reinterpret_cast<int*>(lsm + ecols);
  sc.sg.cap = reinterpret_cast<int*>(lsm + 2 * ecols);
  sc.sg.read = reinterpret_cast<int*>(lsm + 3 * ecols);
  sc.rd = reads + (long long)bl * L;
  sc.wsrc = wins + (long long)bl * wmax;
  sc.js0 = sage::wsub(off0[bl], band);
  sc.wl = wlen[bl];
  sc.wmax = wmax;
  sc.k = k;
  sc.idle = idle;
  uint8_t* ring = lsm + 3 * ecols + round16(4 * p.rwn);
  Lane ln;
  ln.mrow = moves + (long long)bl * L * W;
  ln.L = L;
  ln.W = W;
  ln.c0 = k * CPT - p.v;  // band column of the thread's first position
  ln.live = !idle && b < B;
  sc.mis = (int)((uintptr_t)ln.mrow & 15);
  sc.rb = p.nr * W;
  // the ring; or this thread's strip (idle threads write past the strips)
  ln.ring = RING ? ring : ring + (idle ? p.G : k) * p.nr * CPT;

  Thread<CPT, RING> th;
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    th.val[q] = 0;
    th.fl[q] = ln.c0 + q == 0 ? INT_MAX : INT_MIN;
    if constexpr (RING) {  // byte g of the lane's moves at ring[mis + g % (nr * W)]
      const bool real = !idle && ln.c0 + q >= 0;  // virtual positions store to a dummy byte
      th.wq[q] = real ? W : 0;
      th.cq[q] = real ? sc.mis + ln.c0 + q : sc.rb + 16;
    }
  }
#pragma unroll
  for (int m = 0; m < H; ++m) {  // slot of row D - m at d = 1
    const int r = -(k * H + m);
    th.slot[m] = ((r % p.nr) + p.nr) % p.nr;
  }
  const bool send_inf = k == 0 || idle;

  sc.d0 = 1;
  if (!idle) stage(sc.sg, sc.rd, sc.wsrc, p, 1, L, sc.js0, sc.wl, wmax, k);
  __syncwarp();
  // a warp holding a lane whose anchor lies a band or more left of its
  // window start runs the cell with the INF + c cap
  if (__any_sync(FULL, !idle && sc.js0 <= -W)) {
    sweep_all<CPT, RING, true>(th, ln, sc, p, ring, send_inf, lane);
  } else {
    sweep_all<CPT, RING, false>(th, ln, sc, p, ring, send_inf, lane);
  }
  if (ln.live) {
    int32_t* lrow = last + (long long)b * W;
#pragma unroll
    for (int q = 0; q < CPT; ++q)
      if (ln.c0 + q >= 0) lrow[ln.c0 + q] = th.val[q];
  }
}

template <int CPT, bool RING>
int launch(const int32_t* reads, const int32_t* wins, const int32_t* off0, const int32_t* wlen,
           uint8_t* moves, int32_t* last, int B, int L, int band, int wmax, const Plan& p,
           cudaStream_t stream) {
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        align_scan_kernel<CPT, RING>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  align_scan_kernel<CPT, RING><<<p.grid, p.threads, p.smem, stream>>>(
      reads, wins, off0, wlen, moves, last, B, L, band, wmax, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch shape: out = {grid, threads, dynamic shared memory bytes, cells a
// thread, threads a lane, lanes a warp, lanes a CTA, shared bytes a lane,
// route (1 ring, 0 direct, -1 not taken), ring rows, double steps between
// flushes, double steps a staging window, double steps}. The kernel does not
// take a width past MAX_WIDTH, L past MAX_ROWS or an empty window (route -1).
extern "C" void align_scan_plan(int B, int L, int band, int wmax, int* out) {
  const Plan p = make_plan(B, L, band, wmax);
  const int v[] = {p.grid, p.threads, p.smem, p.cpt, p.G, p.lanes_per_warp, p.lanes_per_cta,
                   p.lane_smem, p.route, p.nr, p.f, p.fw, p.dend};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
}

extern "C" int align_scan_launch(const void* reads, const void* wins, const void* off0,
                                 const void* wlen, void* moves, void* last, int B, int L,
                                 int band, int wmax, void* stream) {
  const Plan p = make_plan(B, L, band, wmax);
  if (p.route < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int32_t* r = (const int32_t*)reads;
  const int32_t* w = (const int32_t*)wins;
  const int32_t* o = (const int32_t*)off0;
  const int32_t* wl = (const int32_t*)wlen;
  uint8_t* mv = (uint8_t*)moves;
  int32_t* ls = (int32_t*)last;
  cudaStream_t st = (cudaStream_t)stream;
  if (p.route == 1) {
    switch (p.cpt) {
      case 2: return launch<2, true>(r, w, o, wl, mv, ls, B, L, band, wmax, p, st);
      case 4: return launch<4, true>(r, w, o, wl, mv, ls, B, L, band, wmax, p, st);
      case 8: return launch<8, true>(r, w, o, wl, mv, ls, B, L, band, wmax, p, st);
      case 12: return launch<12, true>(r, w, o, wl, mv, ls, B, L, band, wmax, p, st);
      case 16: return launch<16, true>(r, w, o, wl, mv, ls, B, L, band, wmax, p, st);
      case 24: return launch<24, true>(r, w, o, wl, mv, ls, B, L, band, wmax, p, st);
    }
  } else {
    switch (p.cpt) {
      case 24: return launch<24, false>(r, w, o, wl, mv, ls, B, L, band, wmax, p, st);
      case 32: return launch<32, false>(r, w, o, wl, mv, ls, B, L, band, wmax, p, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* align_scan_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
