// Banded affine-gap extension (AffineGapVectorized computeScore) for
// Hopper (sm_90a).
//
// Replaces: snap_tpu/ops/affine_pallas.py affine_extend_pallas (the
// Pallas kernel _kernel, lines 51-258); the global-vs-local epilogue
// (finish_extend) stays torch code, as in snap_tpu. Plain PyTorch
// version: snap_tpu_torch/ops/affine.py affine_extend_core_plain.
//
// Work: per candidate row, a Gotoh DP over tlen text rows and plen
// pattern columns: H floored at 0 against score_init, E (deletion) per
// column, F (insertion) as an in-row max-plus prefix whose ties prefer
// the later run start. Each text row updates the best global score
// (column plen-1; ties to the latest row) and the best local score (ties
// to the earliest row, then the largest column), each with its row,
// column, log-probability and packed (mismatch, insertion, deletion)
// counts.
//
// What bounds it on this card: operations. A row reads 5L+T bytes and
// writes 36, but its plen * tlen cells each take 44 integer (compare,
// select, add) and 7 float operations of the plain recurrence, in a
// row-to-row dependent chain.
//
// What held the first design back (one warp per row, every lane on the
// same text row): (a) it sized the columns per lane from L, so every row
// computed all L = 128 columns for every text row although plen <= 76 on
// the main path (2-4x the live cells); (b) the F prefix was a 5-step
// warp scan over four values, about 40 shuffles per text row in all;
// (c) both readouts were warp reductions on every text row.
//
// This design:
// - Work follows plen x tlen, planned on the device (no host read). A
//   plan kernel takes windows of 32 rows, one warp each: it sorts them by
//   (plen, tlen) with a warp bitonic sort and cuts them into passes; a
//   pass puts 32/G rows of similar size in one warp, G lanes each
//   (G = 8, 16 or 32), with C = ceil(max plen / G) <= 5 columns per lane
//   (<= 8 past 160 columns; a template instance per (G, C)), so a lane
//   computes only columns that a row of its pass has. Persistent single-warp blocks of a second
//   kernel then take passes one at a time from a shared counter, so a
//   short pass never holds a block of long ones back.
// - Rows of more than 256 columns (long reads, L <= 512): one row per
//   pass on 32 lanes of 10, 12, 14 or 16 columns (C rounded up to even:
//   four instances, not eight; a lane's columns past plen are dead, as
//   in any pass). Ten registers a column put such a lane past the 128
//   that 16 resident warps per SM leave, so these passes go to a list
//   of their own, which a third kernel built for 8 resident warps takes
//   before the others (ptxas: 255 registers, 188 bytes spilled). The
//   local readout's column key keeps 4 bits (C <= 16), and the counts
//   pack as in the plain version.
// - No scan. Within a row's G lanes the DP runs as an anti-diagonal
//   wavefront: lane k owns columns [kC, kC + C) and works on text row
//   s - k at step s, so the F carry (value, log-prob, counts, run start)
//   and the left column's H arrive from lane k - 1 by one shuffle each,
//   seven per step. Lane 0 computes the column -1 boundary itself.
// - Readouts are kept per lane over its own cells and reduced once per
//   row at the end: global at the lane holding column plen-1 (>= over
//   rows), local by (larger value, earlier row, larger column).
// - Rows of more than 512 columns (reads past 512 bp): a fourth kernel,
//   one block of rows::kThreads threads per row (persistent blocks taking
//   the plan's big rows), each thread a run of consecutive columns whose
//   nine state planes live in the block's scratch in device memory, any
//   width. Per text row: the threads publish their last column's H (the
//   next thread's diagonal input), walk their columns for M, block-scan
//   the F keys (csrc/block_rows.cuh, the plain version's cummax), walk
//   again for F, H and E, and block-reduce the local readout. A simple
//   kernel, not a fast one.
// Float arithmetic is __fadd_rn/__fmul_rn in the plain version's order
// (and -fmad=false); the F log-prob is fadd(rlp, fmul(j - rj - 1,
// log_ext)) from the carried run start, so the log-probabilities match
// the plain version bit for bit.

#include <cuda_runtime.h>

#include <climits>

#include "block_rows.cuh"

namespace {

constexpr int kNegI = -(1 << 29);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWindow = 32;  // rows sorted and planned together
constexpr int kPlanWarps = 4;
constexpr int kPassWarpsPerSM = 16;  // resident at <= 128 registers
constexpr int kXlWarpsPerSM = 8;     // resident at <= 255 registers
constexpr int kMaxCols = 512;        // 32 lanes of 16 columns; longer: big
constexpr int kXlCols = 256;         // longer rows take the xl passes
constexpr int kHeader = 8;           // ints before the pass records

// out_i holds the N x 7 outputs, then (at a 16-byte boundary) the plan:
// an 8-int header (long passes planned, short passes planned, passes
// taken, xl rows planned, xl rows taken, big rows planned, big rows
// taken), N slots of pass records, 8 ints each: the rows of its
// segments (-1: none) and (G << 8) | C, and N ints of xl rows (from the
// front) and big rows (from the back). Long passes fill the slots from
// the front, short ones from the back; there are never more passes than
// rows.
// ops/affine_cuda.py allocates it (plan_ints there).
__host__ __device__ inline long plan_offset(int N) {
  return ((long)N * 7 + 3) & ~3L;
}

struct Args {
  const unsigned char* pat;
  const float* logq;
  const int* plen;
  const unsigned char* text;
  const int* tlen;
  const int* sinit;
  int* out_i;
  float* out_f;
  int* plan;
  int slots;  // warps the pass kernel keeps resident
  int N, L, T, MATCH, SUB, OPEN, EXT;
  float log_open, log_ext, neg_f;
};

__device__ __forceinline__ void write_row(const Args& a, int row, int bg,
                                          int bg_row, int bg_ct, float bg_lp,
                                          int bl, int bl_row, int bl_col,
                                          int bl_ct, float bl_lp) {
  int* oi = a.out_i + (long)row * 7;
  oi[0] = bg;
  oi[1] = bg_row;
  oi[2] = bg_ct;
  oi[3] = bl;
  oi[4] = bl_row;
  oi[5] = bl_col;
  oi[6] = bl_ct;
  a.out_f[(long)row * 2] = bg_lp;
  a.out_f[(long)row * 2 + 1] = bl_lp;
}

__device__ __forceinline__ int clamp_len(int v, int hi) {
  return min(max(v, 0), hi);
}

// One pass: the 32/G rows of a pass record, G lanes each, C columns per
// lane. A segment without a row (-1) idles.
template <int G, int C>
__device__ __forceinline__ void run_pass(const Args& a, const int* rec) {
  const int lane = threadIdx.x & 31;
  const int seg = lane / G, k = lane % G;
  const int rid = rec[seg];
  const bool has_row = rid >= 0;
  int row = 0, pl = 0, tl = 0;
  if (has_row) {
    row = rid;
    pl = clamp_len(a.plen[row], a.L);
    tl = clamp_len(a.tlen[row], a.T);
  }
  const int nl = (pl + C - 1) / C;  // lanes with columns in this row
  const bool active = k < nl;
  const int base = k * C;
  const int OPEN = a.OPEN, EXT = a.EXT;
  const float log_open = a.log_open, log_ext = a.log_ext;
  const int si = active ? a.sinit[row] : 0;
  const long prow = (long)row * a.L;

  int pc[C], sx[C], kb[C], h[C], hc[C], e[C], ec[C];
  float lq[C], hl[C], el[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = base + c;
    const bool live = active && j < pl;
    pc[c] = live ? (int)a.pat[prow + j] : 0;
    lq[c] = live ? a.logq[prow + j] : 0.0f;
    sx[c] = pc[c] >= 4 ? -1 : -a.SUB;  // mismatch score (N pattern: -1)
    kb[c] = live ? c : -(1 << 30);     // local-readout key; dead never wins
    // row -1: leading pattern insertions charged from score_init
    h[c] = live ? max(0, si - OPEN - j * EXT) : kNegI;
    hl[c] = __fadd_rn(__fmul_rn((float)j, log_ext), log_open);
    hc[c] = (j + 1) << 10;
    e[c] = 0;
    el[c] = a.neg_f;
    ec[c] = 0;
  }
  // diagonal input of column `base` at the current row: H(i-1, base-1);
  // column -1 at row -1 is score_init itself
  int dh, dc;
  float dl;
  if (k == 0) {
    dh = si;
    dl = 0.0f;
    dc = 0;
  } else {
    dh = max(0, si - OPEN - (base - 1) * EXT);
    dl = __fadd_rn(__fmul_rn((float)(base - 1), log_ext), log_open);
    dc = base << 10;
  }
  // what this lane hands lane k+1: H of its last column and the F carry
  // after it, for the row it just finished
  int oh = 0, ohc = 0, orv = kNegI, orct = 0;
  float ohl = 0.0f, orlp = 0.0f, orj = 0.0f;

  const int cstar = active ? pl - 1 - base : -1;  // global column's slot
  int bg = -1, bg_row = 0, bg_ct = 0;
  float bg_lp = a.neg_f;
  int bl = -1, bl_row = 0, bl_col = 0, bl_ct = 0;
  float bl_lp = a.neg_f;

  const int baseE = base * EXT;
  const int baseS = base << 10;
  const float basef = (float)base;
  const int steps = __reduce_max_sync(kFull, active ? tl + nl - 1 : 0);
  const unsigned char* trow = a.text + (long)row * a.T;

  for (int s = 0; s < steps; ++s) {
    int ih = __shfl_up_sync(kFull, oh, 1, G);
    float ihl = __shfl_up_sync(kFull, ohl, 1, G);
    int ihc = __shfl_up_sync(kFull, ohc, 1, G);
    int rv = __shfl_up_sync(kFull, orv, 1, G);
    float rlp = __shfl_up_sync(kFull, orlp, 1, G);
    int rct = __shfl_up_sync(kFull, orct, 1, G);
    const float rjf = __shfl_up_sync(kFull, orj, 1, G);
    const int i = s - k;
    if (k == 0) {
      // column -1 at row i (the next row's h_init): i + 1 deletions
      ih = max(0, si - OPEN - i * EXT);
      ihl = __fadd_rn(log_open, __fmul_rn((float)i, log_ext));
      ihc = i + 1;
      rv = kNegI;  // no insertion run enters column 0
    }
    if (!(active && i >= 0 && i < tl)) continue;
    const int tb = trow[i];
    const bool tbn = tb >= 4;
    // carry: rv = best max(M - OPEN, 0) + l * EXT over columns l < j,
    // rlp its open log-prob, rct its counts less (l << 10), rj = l - base
    float rj = __fsub_rn(rjf, basef);
    int hd = dh, hdc = dc;
    float hdl = dl;
    int rk = -1, rkc = 0, gv = 0, gc = 0;
    float rkl = 0.0f, gl = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const bool eq = tb == pc[c];
      int sc = eq ? a.MATCH : sx[c];
      sc = tbn ? -1 : sc;
      const int m = hd > 0 ? hd + sc : 0;
      const float mlp = __fadd_rn(hdl, eq ? 0.0f : lq[c]);
      const int mct = hdc + (eq ? 0 : (1 << 20));
      const int t = max(m - OPEN, 0);
      const int adj = t + baseE + c * EXT;
      const float slp = __fadd_rn(mlp, log_open);
      // F at j = base + c from the run start carried over columns < j
      const int f = rv - baseE - (c - 1) * EXT;
      const float flp = __fadd_rn(
          rlp, __fmul_rn(__fsub_rn((float)(c - 1), rj), log_ext));
      const int fct = rct + baseS + (c << 10);
      if (adj >= rv) {  // ties: the later run start
        rv = adj;
        rlp = slp;
        rct = mct - baseS - (c << 10);
        rj = (float)c;
      }
      // H = max(M, E, F): E wins only if > M, F only if > max(M, E)
      const bool te = e[c] > m;
      int hh = te ? e[c] : m;
      float hhl = te ? el[c] : mlp;
      int hhc = te ? ec[c] : mct;
      if (f > hh) {
        hh = f;
        hhl = flp;
        hhc = fct;
      }
      // E for the next row: max(E - EXT, M - OPEN, 0); a tie opens
      const int e_ext = e[c] - EXT;
      const bool tx = e_ext > t;
      const float eln = tx ? __fadd_rn(el[c], log_ext) : slp;
      ec[c] = (tx ? ec[c] : mct) + 1;
      e[c] = tx ? e_ext : t;
      el[c] = eln;
      // the old H is the next column's diagonal input
      hd = h[c];
      hdl = hl[c];
      hdc = hc[c];
      h[c] = hh;
      hl[c] = hhl;
      hc[c] = hhc;
      // local: the row's best of this lane's columns, ties to the larger
      const int key = hh * 16 + kb[c];
      if (key > rk) {
        rk = key;
        rkl = hhl;
        rkc = hhc;
      }
      if (c == cstar) {
        gv = hh;
        gl = hhl;
        gc = hhc;
      }
    }
    oh = h[C - 1];
    ohl = hl[C - 1];
    ohc = hc[C - 1];
    orv = rv;
    orlp = rlp;
    orct = rct;
    orj = __fadd_rn(rj, basef);
    dh = ih;
    dl = ihl;
    dc = ihc;
    if (cstar >= 0 && cstar < C && gv >= bg) {  // ties: the later row
      bg = gv;
      bg_row = i;
      bg_lp = gl;
      bg_ct = gc;
    }
    if ((rk >> 4) > bl) {  // strictly greater: the earlier row keeps it
      bl = rk >> 4;
      bl_row = i;
      bl_col = base + (rk & 15);
      bl_lp = rkl;
      bl_ct = rkc;
    }
  }

  // global: from the lane that holds column plen-1
  const int src = seg * G + (pl > 0 ? (pl - 1) / C : 0);
  bg = __shfl_sync(kFull, bg, src);
  bg_row = __shfl_sync(kFull, bg_row, src);
  bg_ct = __shfl_sync(kFull, bg_ct, src);
  bg_lp = __shfl_sync(kFull, bg_lp, src);
  // local: larger value, then the earlier row, then the larger column
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(kFull, bl, off, G);
    const int orow = __shfl_xor_sync(kFull, bl_row, off, G);
    const int ocol = __shfl_xor_sync(kFull, bl_col, off, G);
    const int oct = __shfl_xor_sync(kFull, bl_ct, off, G);
    const float olp = __shfl_xor_sync(kFull, bl_lp, off, G);
    if (ov > bl ||
        (ov == bl && (orow < bl_row || (orow == bl_row && ocol > bl_col)))) {
      bl = ov;
      bl_row = orow;
      bl_col = ocol;
      bl_ct = oct;
      bl_lp = olp;
    }
  }
  if (k == 0 && has_row)
    write_row(a, row, bg, bg_row, bg_ct, bg_lp, bl, bl_row, bl_col, bl_ct,
              bl_lp);
}

// Lanes per row of a pass whose largest row has mp columns: the
// narrowest G with C = ceil(mp / G) <= 5, so that a lane's columns stay
// in registers at 16 warps per SM; 32 beyond 160 columns (C <= 8; past
// kXlCols an xl pass). With fewer than 4 rows per resident warp, every
// pass takes one row on 32 lanes, so that the few rows still occupy the
// card.
__device__ __forceinline__ int pass_width(int mp, bool wide) {
  return wide ? 32 : (mp <= 40 ? 8 : (mp <= 80 ? 16 : 32));
}

// Columns per lane of an xl pass over a row of pl > kXlCols columns
__device__ __forceinline__ int xl_cols(int pl) {
  return ((pl + 31) / 32 + 1) & ~1;
}

__device__ __forceinline__ void dispatch(const Args& a, const int* rec) {
  const int G = rec[4] >> 8, C = rec[4] & 0xff;
#define SNAP_AG_PASS(GG, CC)     \
  if (G == GG && C == CC) {      \
    run_pass<GG, CC>(a, rec);    \
    return;                      \
  }
  SNAP_AG_PASS(8, 1)
  SNAP_AG_PASS(8, 2)
  SNAP_AG_PASS(8, 3)
  SNAP_AG_PASS(8, 4)
  SNAP_AG_PASS(8, 5)
  SNAP_AG_PASS(16, 3)
  SNAP_AG_PASS(16, 4)
  SNAP_AG_PASS(16, 5)
  SNAP_AG_PASS(32, 1)
  SNAP_AG_PASS(32, 2)
  SNAP_AG_PASS(32, 3)
  SNAP_AG_PASS(32, 4)
  SNAP_AG_PASS(32, 5)
  SNAP_AG_PASS(32, 6)
  SNAP_AG_PASS(32, 7)
  SNAP_AG_PASS(32, 8)
#undef SNAP_AG_PASS
}

__device__ __forceinline__ void dispatch_xl(const Args& a, const int* rec) {
  const int C = rec[4] & 0xff;
#define SNAP_AG_PASS(CC)         \
  if (C == CC) {                 \
    run_pass<32, CC>(a, rec);    \
    return;                      \
  }
  SNAP_AG_PASS(10)
  SNAP_AG_PASS(12)
  SNAP_AG_PASS(14)
  SNAP_AG_PASS(16)
#undef SNAP_AG_PASS
}

// One warp per window of 32 rows: rows without a cell get the initial
// readouts; the others are sorted by (plen, tlen), largest first, and cut
// into passes: the next 32/G rows share a warp, G lanes each, with
// C = ceil(max plen / G) columns per lane (the first row of a pass is
// its largest). The passes go to the plan in out_i, those over rows of
// more than 40 columns to the long list, which is taken first, rows of
// more than kXlCols columns to the xl list and rows of more than
// kMaxCols to the big list.
__global__ void __launch_bounds__(kPlanWarps * 32) plan_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const long r0 =
      ((long)blockIdx.x * kPlanWarps + (threadIdx.x >> 5)) * kWindow;
  if (r0 >= a.N) return;  // uniform per warp
  const long row = r0 + lane;
  int pl = 0, tl = 0;
  if (row < a.N) {
    pl = clamp_len(a.plen[row], a.L);
    tl = clamp_len(a.tlen[row], a.T);
  }
  const bool live = pl > 0 && tl > 0;
  if (row < a.N && !live)
    write_row(a, (int)row, -1, 0, 0, a.neg_f, -1, 0, 0, 0, a.neg_f);
  // plen (capped at kMaxCols + 1: past it, a big row) in bits 15-24,
  // tlen (capped, it only orders) in 5-14
  int key = live ? (min(pl, kMaxCols + 1) << 15) | (min(tl, 1023) << 5) | lane
                 : lane;
#pragma unroll
  for (int kk = 2; kk <= 32; kk <<= 1) {
#pragma unroll
    for (int jj = kk >> 1; jj > 0; jj >>= 1) {
      const int other = __shfl_xor_sync(kFull, key, jj);
      const bool lower = (lane & jj) == 0;
      const bool desc = (lane & kk) == 0;
      key = (lower == desc) ? max(key, other) : min(key, other);
    }
  }
  // lane q now holds the q-th largest row
  const int nlive = __popc(__ballot_sync(kFull, live));
  const int srow = (int)r0 + (key & 31);
  const int spl = key >> 15;
  const bool wide = a.N < 4 * a.slots;
  int nlong = 0, nshort = 0, nxl = 0, nbig = 0;
  for (int q = 0; q < nlive;) {
    const int mp = __shfl_sync(kFull, spl, q);
    ++(mp > kMaxCols ? nbig
                     : (mp > kXlCols ? nxl : (mp > 40 ? nlong : nshort)));
    q += 32 / pass_width(mp, wide);
  }
  int blong = 0, bshort = 0, bxl = 0, bbig = 0;
  if (lane == 0) {
    if (nlong) blong = atomicAdd(&a.plan[0], nlong);
    if (nshort) bshort = atomicAdd(&a.plan[1], nshort);
    if (nxl) bxl = atomicAdd(&a.plan[3], nxl);
    if (nbig) bbig = atomicAdd(&a.plan[5], nbig);
  }
  blong = __shfl_sync(kFull, blong, 0);
  bshort = __shfl_sync(kFull, bshort, 0);
  bxl = __shfl_sync(kFull, bxl, 0);
  bbig = __shfl_sync(kFull, bbig, 0);
  for (int q = 0; q < nlive;) {
    const int mp = __shfl_sync(kFull, spl, q);
    const int G = pass_width(mp, wide);
    const int R = 32 / G;
    const int rr = __shfl_sync(kFull, srow, min(q + lane, 31));
    if (mp > kMaxCols) {  // one row, lane 0's
      if (lane == 0) a.plan[kHeader + 8L * a.N + a.N - 1 - bbig] = rr;
      ++bbig;
    } else if (mp > kXlCols) {  // G = 32: one row, lane 0's
      if (lane == 0) a.plan[kHeader + 8L * a.N + bxl] = rr;
      ++bxl;
    } else {
      const long slot = mp > 40 ? blong++ : a.N - 1 - bshort++;
      int* rec = a.plan + kHeader + 8 * slot;
      if (lane < 4) rec[lane] = (lane < R && q + lane < nlive) ? rr : -1;
      if (lane == 4) rec[4] = (G << 8) | ((mp + G - 1) / G);
    }
    q += R;
  }
}

// Persistent warps, each taking the next pass of the plan (the long
// ones first) until none is left.
__global__ void __launch_bounds__(32, kPassWarpsPerSM) pass_kernel(const Args a) {
  const int nlong = a.plan[0], total = nlong + a.plan[1];
  for (;;) {
    int t = 0;
    if (threadIdx.x == 0) t = atomicAdd(&a.plan[2], 1);
    t = __shfl_sync(kFull, t, 0);
    if (t >= total) return;
    const long slot = t < nlong ? t : a.N - 1 - (t - nlong);
    dispatch(a, a.plan + kHeader + 8 * slot);
  }
}

// Persistent warps of up to 255 registers, each taking the next xl row
// of the plan until none is left.
__global__ void __launch_bounds__(32, kXlWarpsPerSM) pass_xl_kernel(const Args a) {
  const int total = a.plan[3];
  const int* rows = a.plan + kHeader + 8L * a.N;
  for (;;) {
    int t = 0;
    if (threadIdx.x == 0) t = atomicAdd(&a.plan[4], 1);
    t = __shfl_sync(kFull, t, 0);
    if (t >= total) return;
    const int row = rows[t];
    const int rec[5] = {row, -1, -1, -1,
                        (32 << 8) | xl_cols(clamp_len(a.plen[row], a.L))};
    dispatch_xl(a, rec);
  }
}

// Persistent blocks, each taking the next big row of the plan (more than
// kMaxCols columns) until none is left; `scratch` holds 9 planes of L
// words per block.
__global__ void __launch_bounds__(rows::kThreads) pass_big_kernel(
    const Args a, int* __restrict__ scratch) {
  __shared__ long long tot[rows::kWarps];
  __shared__ int lh[rows::kThreads], lhc[rows::kThreads];
  __shared__ float lhl[rows::kThreads];
  __shared__ int next;
  const int t = threadIdx.x;
  const int L = a.L, OPEN = a.OPEN, EXT = a.EXT;
  const float log_open = a.log_open, log_ext = a.log_ext;
  int* h = scratch + (long)blockIdx.x * 9 * L;
  int* hc = h + L;
  int* e = hc + L;
  int* ec = e + L;
  int* m = ec + L;
  int* mc = m + L;
  float* hl = (float*)(mc + L);
  float* el = hl + L;
  float* ml = el + L;
  const int total = a.plan[5];
  const int* big = a.plan + kHeader + 8L * a.N + a.N - 1;  // big[-q]

  for (;;) {
    if (t == 0) next = atomicAdd(&a.plan[6], 1);
    __syncthreads();
    const int q = next;
    if (q >= total) return;  // the same for the whole block
    const int row = big[-q];
    const int pl = clamp_len(a.plen[row], L), tl = clamp_len(a.tlen[row], a.T);
    const int K = (pl + rows::kThreads - 1) / rows::kThreads;
    const int j0 = min(t * K, pl), j1 = min(j0 + K, pl);
    const int si = a.sinit[row];
    const long prow = (long)row * L;
    const unsigned char* trow = a.text + (long)row * a.T;
    // row -1: leading pattern insertions charged from score_init
    for (int j = j0; j < j1; ++j) {
      h[j] = max(0, si - OPEN - j * EXT);
      hl[j] = __fadd_rn(__fmul_rn((float)j, log_ext), log_open);
      hc[j] = (j + 1) << 10;
      e[j] = 0;
      el[j] = a.neg_f;
      ec[j] = 0;
    }
    // the global readout stays with the thread of column plen-1, the
    // local one with thread 0
    int bg = -1, bg_row = 0, bg_ct = 0;
    float bg_lp = a.neg_f;
    int bl = -1, bl_row = 0, bl_col = 0, bl_ct = 0;
    float bl_lp = a.neg_f;

    for (int i = 0; i < tl; ++i) {
      const int tb = trow[i];
      const bool tbn = tb >= 4;
      if (j1 > j0) {
        lh[t] = h[j1 - 1];
        lhl[t] = hl[j1 - 1];
        lhc[t] = hc[j1 - 1];
      }
      __syncthreads();
      // diagonal input of column j0: H(i-1, j0-1); column -1 is
      // score_init at row 0, then i deletions
      int hd = 0, hdc = 0;
      float hdl = 0.0f;
      if (t == 0) {
        if (i > 0) {
          hd = max(0, si - OPEN - (i - 1) * EXT);
          hdl = __fadd_rn(log_open, __fmul_rn((float)(i - 1), log_ext));
          hdc = i;
        } else {
          hd = si;
        }
      } else if (j1 > j0) {
        hd = lh[t - 1];
        hdl = lhl[t - 1];
        hdc = lhc[t - 1];
      }
      long long agg = LLONG_MIN;
      for (int j = j0; j < j1; ++j) {
        const int pc = a.pat[prow + j];
        const bool eq = tb == pc;
        const int sc = (tbn || pc >= 4) ? -1 : (eq ? a.MATCH : -a.SUB);
        const int mv = hd > 0 ? hd + sc : 0;
        m[j] = mv;
        ml[j] = __fadd_rn(hdl, eq ? 0.0f : a.logq[prow + j]);
        mc[j] = hdc + (eq ? 0 : (1 << 20));
        agg = max(agg, rows::key(max(mv - OPEN, 0) + j * EXT, j));
        hd = h[j];
        hdl = hl[j];
        hdc = hc[j];
      }
      // F[j] extends the run started at the argmax of
      // max(M - OPEN, 0)[l] + l * EXT over l < j, ties to the later start
      long long carry = rows::exclusive_scan<true>(agg, LLONG_MIN, tot);
      long long best = LLONG_MIN;
      for (int j = j0; j < j1; ++j) {
        const int mv = m[j], mcv = mc[j];
        const float mlv = ml[j];
        int f = kNegI, fct = 0;
        float flp = a.neg_f;
        if (j > 0) {
          const int rj = rows::key_col(carry);
          const int run_m1 = j - rj - 1;
          f = rows::key_value(carry) - (j - 1) * EXT;
          flp = __fadd_rn(__fadd_rn(ml[rj], log_open),
                          __fmul_rn((float)run_m1, log_ext));
          fct = mc[rj] + ((run_m1 + 1) << 10);
        }
        const int tv = max(mv - OPEN, 0);
        carry = max(carry, rows::key(tv + j * EXT, j));
        // H = max(M, E, F): E wins only if > M, F only if > max(M, E)
        const bool te = e[j] > mv;
        int hh = te ? e[j] : mv;
        float hhl = te ? el[j] : mlv;
        int hhc = te ? ec[j] : mcv;
        if (f > hh) {
          hh = f;
          hhl = flp;
          hhc = fct;
        }
        // E for the next row: max(E - EXT, M - OPEN, 0); a tie opens
        const int e_ext = e[j] - EXT;
        const bool tx = e_ext > tv;
        el[j] = tx ? __fadd_rn(el[j], log_ext) : __fadd_rn(mlv, log_open);
        ec[j] = (tx ? ec[j] : mcv) + 1;
        e[j] = tx ? e_ext : tv;
        h[j] = hh;
        hl[j] = hhl;
        hc[j] = hhc;
        best = max(best, rows::key(hh, j));  // local: ties to the larger column
        if (j == pl - 1 && hh >= bg) {       // global: ties to the later row
          bg = hh;
          bg_row = i;
          bg_lp = hhl;
          bg_ct = hhc;
        }
      }
      best = rows::all_reduce<true>(best, tot);
      if (t == 0 && rows::key_value(best) > bl) {  // the earlier row keeps ties
        bl = rows::key_value(best);
        bl_row = i;
        bl_col = rows::key_col(best);
        bl_lp = hl[bl_col];
        bl_ct = hc[bl_col];
      }
    }
    int* oi = a.out_i + (long)row * 7;
    if (j0 <= pl - 1 && pl - 1 < j1) {
      oi[0] = bg;
      oi[1] = bg_row;
      oi[2] = bg_ct;
      a.out_f[(long)row * 2] = bg_lp;
    }
    if (t == 0) {
      oi[3] = bl;
      oi[4] = bl_row;
      oi[5] = bl_col;
      oi[6] = bl_ct;
      a.out_f[(long)row * 2 + 1] = bl_lp;
    }
    __syncthreads();  // the next row's start overwrites the planes and `next`
  }
}

}  // namespace

extern "C" int affine_extend_launch(const void* pat, const void* logq,
                                    const void* plen, const void* text,
                                    const void* tlen, const void* sinit,
                                    void* out_i, void* out_f, int N, int L,
                                    int T, int MATCH, int SUB, int OPEN,
                                    int EXT, float log_open, float log_ext,
                                    float neg_f, void* scratch, int blocks,
                                    void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  // L > kMaxCols: `blocks` big-row blocks, each with 9 L words of scratch
  if (L > kMaxCols &&
      (scratch == nullptr || blocks <= 0 || L >= (1 << rows::kColBits)))
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int* plan = (int*)out_i + plan_offset(N);
  const int slots = sms * kPassWarpsPerSM;
  const Args a{(const unsigned char*)pat, (const float*)logq,
               (const int*)plen, (const unsigned char*)text,
               (const int*)tlen, (const int*)sinit, (int*)out_i,
               (float*)out_f, plan, slots, N, L, T, MATCH, SUB, OPEN, EXT,
               log_open, log_ext, neg_f};
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(plan, 0, kHeader * sizeof(int), s);
  const long windows = ((long)N + kWindow - 1) / kWindow;
  plan_kernel<<<(unsigned)((windows + kPlanWarps - 1) / kPlanWarps),
                kPlanWarps * 32, 0, s>>>(a);
  if (L > kMaxCols)  // no row is big otherwise
    pass_big_kernel<<<(unsigned)blocks, rows::kThreads, 0, s>>>(
        a, (int*)scratch);
  if (L > kXlCols)  // no row can take an xl pass otherwise
    pass_xl_kernel<<<(unsigned)min(N, sms * kXlWarpsPerSM), 32, 0, s>>>(a);
  pass_kernel<<<(unsigned)min(N, slots), 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}
