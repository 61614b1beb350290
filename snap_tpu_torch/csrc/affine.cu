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
//   (a template instance per (G, C)), so a lane computes only columns
//   that a row of its pass has. Persistent single-warp blocks of a
//   second kernel then take passes one at a time from a shared counter,
//   so a short pass never holds a block of long ones back.
// - Rows of more than kBlockCols = 128 columns (mid rows up to 256, xl
//   rows beyond: long reads) go to lists of their own, taken by the
//   block kernel below (see "mid rows" and "xl rows").
// - No scan. Within a row's G lanes the DP runs as an anti-diagonal
//   wavefront: lane k owns columns [kC, kC + C) and works on text row
//   s - k at step s, so the F carry (value, log-prob, counts, run start)
//   and the left column's H arrive from lane k - 1 by one shuffle each,
//   seven per step. Lane 0 computes the column -1 boundary itself.
// - Readouts are kept per lane over its own cells and reduced once per
//   row at the end: global at the lane holding column plen-1 (>= over
//   rows), local by (larger value, earlier row, larger column).
// - Rows of more than 512 columns (reads past 512 bp): the block kernel
//   below, pass_row_kernel, 256 threads a row.
//
// What held the first design of the big-row kernel back (one 256-thread
// block a row, every thread on the same text row): (a) its nine state
// planes lived in scratch in device memory, walked twice per text row;
// (b) each text row was a block-wide step with five barriers (the F
// block scan, a serial cross-warp walk, and a block all-reduce of the
// local readout on every row); (c) at most 4 blocks per SM. It ran at
// 68.6x its bound on the first 1500 bp batch (H100 80GB HBM3, 700.00 W).
//
// Its design now: the short passes' wavefront on a whole block. 256
// threads a row, 8 pattern columns a thread in registers; thread t works
// on text row s - t at step s, so H of the left column and the F carry
// arrive from thread t - 1 by shuffle inside a warp and through a
// two-slot shared ring across warps (one barrier a step); the readouts
// stay per thread and are reduced once per row. Patterns wider than 2048
// columns (20 kb reads) run strip by strip: the strip's last thread
// writes H and the carry of every text row to the block's scratch (8
// words a row, tlen rows), read back by the next strip's thread 0 one
// step ahead. Persistent blocks, 2 per SM (<= 128 registers), take the
// plan's big rows from its counter. ptxas (sm_90a): 128 registers, 6
// bytes spilled (8 loaded back), 612 bytes of shared memory.
//
// xl rows (257-512 columns: -rl 400's reads). What held their first
// design back (one row per pass of 32 lanes of 10-16 columns, a third
// kernel built for 8 resident warps, run before the short passes): (a)
// ten registers a column put a lane at 255 registers with 188 bytes
// spilled, so an SM held 8 such warps, whose serial F chains over 12-16
// columns, spill traffic and seven shuffles a step nothing hid; (b) the
// short passes, launched after it on the same stream, waited for the
// last xl row, so its tail left the card idle. It ran at 6.27x its bound
// on the first -rl 400 batch (H100 80GB HBM3, 700.00 W).
//
// This design (pass_xl_row_kernel): the big rows' wavefront, one strip,
// on kMidThreads = 64 threads of C = ceil(plen / 64) = 5-8 columns,
// chosen per row so that nearly every thread holds columns (plen 280
// fills 56 of 64 threads at C = 5, where 8 columns a thread would fill
// 35). kMidBlocksPerSM = 6 resident blocks (12 warps per SM, <= 168
// registers) keep every state plane in registers, as many as fit at
// once. The plan's xl list feeds it as the big list feeds the big rows,
// and it starts first; the short passes are its programmatic dependent
// launch (griddepcontrol), so their warps start as soon as every xl
// block has, on what the SMs have left, and take an SM over as its xl
// blocks finish; a pass warp leaves only once the xl kernel is done.
// Without that overlap the same launches take 1.55x as long (first -rl
// 400 batch, H100 80GB HBM3, 700.00 W). ptxas (sm_90a): 161 registers
// with the mid rows' instances (160 without), no spills, 156 bytes of
// shared memory.
//
// mid rows (129-256 columns: -rl 256's longest, -rl 400's middle). What
// held them back in the passes: in launches of fewer than 4 rows per
// resident warp (every -rl 256 and -rl 400 launch: 256-2,048 rows) a
// pass is one row on 32 lanes of C = 5-8 columns, a wavefront of
// tlen + 31 (~310) steps of ~8 x 51 operations on one warp, so a launch
// lasted its longest such row's chain; and the 16 (G, C) instances,
// inlined into one function held to 128 registers, spilled 240 bytes.
// They ran at 3.90x their bound on the first -rl 256 batch (H100 80GB
// HBM3, 700.00 W).
//
// This design: a row of more than kBlockCols columns leaves the passes
// at every launch size for the xl rows' block kernel, 64 threads of
// C = ceil(plen / 64) = 3-4 columns, so a step's chain is half as long
// and a row's lanes are all busy. Its rows go longest first: the xl
// rows, then the mid rows over kMidSplit = 192 columns, then the rest
// (the plan's mid list). The short passes are its programmatic dependent
// launch at every L past kBlockCols, so they run beside it. The passes
// keep their widths (G = 8 up to 40 columns, 16 up to 80, 32 beyond,
// at most 5 columns a lane); each (G, C) instance is a function of its
// own, with registers of its own: inlined together, the 13 left spilled
// 60 bytes; at most 4 columns a lane spilled nothing but made the L = 128
// step's passes 10% slower. Alternatives measured on the recorded
// launches of the first -rl 256 and -rl 400 batches, each against the
// parent in the same call (H100 80GB HBM3, 700.00 W): this design 1.55x
// and 1.13x faster; a kernel of its own for the mid rows (more resident
// blocks at fewer registers, 128 threads of 2 columns in launches of few
// rows) 1.47x and 0.93x, its blocks waiting for the xl kernel's; 128
// threads a mid row in every launch 1.20x at -rl 256. ptxas (sm_90a):
// pass_kernel 126 registers, pass_xl_row_kernel 161, no spills.
//
// Float arithmetic is __fadd_rn/__fmul_rn in the plain version's order
// (and -fmad=false); the F log-prob is fadd(rlp, fmul(j - rj - 1,
// log_ext)) from the carried run start, so the log-probabilities match
// the plain version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kNegI = -(1 << 29);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWindow = 32;  // rows sorted and planned together
constexpr int kPlanWarps = 4;
constexpr int kPassWarpsPerSM = 16;  // resident at <= 128 registers
// longer rows leave the passes for the block kernel
// (pass_xl_row_kernel, one strip): mid rows up to kXlCols columns,
// longer ones xl rows
constexpr int kBlockCols = 128;
constexpr int kXlCols = 256;
// mid rows of more columns are taken before the others
constexpr int kMidSplit = (kBlockCols + kXlCols) / 2;
constexpr int kHeader = 12;          // ints before the pass records
// the block kernel: threads a row, the most columns a thread, resident
// blocks per SM
constexpr int kMidThreads = 64;
constexpr int kMidC = 8;
constexpr int kMaxCols = kMidThreads * kMidC;  // longer: big rows
constexpr int kMidBlocksPerSM = 6;
// big rows (pass_row_kernel): threads a row, columns a thread, resident
// blocks per SM (ops/affine_cuda.py sizes the blocks and scratch from
// the same numbers)
constexpr int kRowThreads = 256;
constexpr int kRowC = 8;
constexpr int kRowCols = kRowThreads * kRowC;
constexpr int kRowBlocksPerSM = 2;
constexpr int kMaxWidth = 1 << 24;  // columns (as float, exact below)

// out_i holds the N x 7 outputs, then (at a 16-byte boundary) the plan:
// a kHeader-int header (long passes planned, short passes planned,
// passes taken, xl rows planned, block rows taken, big rows planned, big
// rows taken, mid rows planned over kMidSplit columns, the other mid
// rows planned), N slots of pass records, 8 ints each: the rows of its
// segments (-1: none) and (G << 8) | C, N ints of xl rows (from the
// front) and big rows (from the back), and N ints of mid rows (over
// kMidSplit columns from the front, the others from the back). Long
// passes fill the slots from the front, short ones from the back; there
// are never more passes than rows.
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
// lane. A segment without a row (-1) idles. Each instance is a function
// of its own, so that each gets its own registers: inlined together in
// the pass kernel, the instances of 5 columns a lane spilled 60 bytes.
template <int G, int C>
__device__ __noinline__ void run_pass(const Args& a, const int* rec) {
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

// Lanes per row of a pass whose largest row has mp <= kBlockCols
// columns: the narrowest G with C = ceil(mp / G) <= 5, so that a lane's
// columns stay in registers at 16 warps per SM; 32 beyond 80 columns
// (C <= 4). With fewer than 4 rows per resident warp, every pass takes
// one row on 32 lanes, so that the few rows still occupy the card.
__device__ __forceinline__ int pass_width(int mp, bool wide) {
  return wide ? 32 : (mp <= 40 ? 8 : (mp <= 80 ? 16 : 32));
}

// The (G, C) instances of the passes; those no row of at most
// kBlockCols columns takes compile away.
__device__ __forceinline__ void dispatch(const Args& a, const int* rec) {
  const int G = rec[4] >> 8, C = rec[4] & 0xff;
#define SNAP_AG_PASS(GG, CC)                              \
  if (GG * (CC - 1) < kBlockCols && G == GG && C == CC) { \
    run_pass<GG, CC>(a, rec);                             \
    return;                                               \
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
#undef SNAP_AG_PASS
}

// One warp per window of 32 rows: rows without a cell get the initial
// readouts; the others are sorted by (plen, tlen), largest first. Rows
// of more than kBlockCols columns go to the block kernels' lists, one
// each: the mid list up to kXlCols (over kMidSplit from its front, the
// others from its back), the xl list up to kMaxCols, the big list
// beyond. The rest are cut into passes: the next 32/G rows share a warp,
// G lanes each, with C = ceil(max plen / G) columns per lane (the first
// row of a pass is its largest). The passes go to the plan in out_i,
// those over rows of more than 40 columns to the long list, which is
// taken first.
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
  int nlong = 0, nshort = 0, nxl = 0, nbig = 0, nmidl = 0, nmids = 0;
  for (int q = 0; q < nlive;) {
    const int mp = __shfl_sync(kFull, spl, q);
    if (mp > kBlockCols) {  // one row
      ++(mp > kMaxCols ? nbig
                       : (mp > kXlCols ? nxl : (mp > kMidSplit ? nmidl : nmids)));
      ++q;
    } else {
      ++(mp > 40 ? nlong : nshort);
      q += 32 / pass_width(mp, wide);
    }
  }
  int blong = 0, bshort = 0, bxl = 0, bbig = 0, bmidl = 0, bmids = 0;
  if (lane == 0) {
    if (nlong) blong = atomicAdd(&a.plan[0], nlong);
    if (nshort) bshort = atomicAdd(&a.plan[1], nshort);
    if (nxl) bxl = atomicAdd(&a.plan[3], nxl);
    if (nbig) bbig = atomicAdd(&a.plan[5], nbig);
    if (nmidl) bmidl = atomicAdd(&a.plan[7], nmidl);
    if (nmids) bmids = atomicAdd(&a.plan[8], nmids);
  }
  blong = __shfl_sync(kFull, blong, 0);
  bshort = __shfl_sync(kFull, bshort, 0);
  bxl = __shfl_sync(kFull, bxl, 0);
  bbig = __shfl_sync(kFull, bbig, 0);
  bmidl = __shfl_sync(kFull, bmidl, 0);
  bmids = __shfl_sync(kFull, bmids, 0);
  int* const xl = a.plan + kHeader + 8L * a.N;  // then the mid list
  for (int q = 0; q < nlive;) {
    const int mp = __shfl_sync(kFull, spl, q);
    const int rr = __shfl_sync(kFull, srow, min(q + lane, 31));
    if (mp > kBlockCols) {  // one row, lane 0's
      if (lane == 0) {
        if (mp > kMaxCols)
          xl[a.N - 1 - bbig] = rr;
        else if (mp > kXlCols)
          xl[bxl] = rr;
        else if (mp > kMidSplit)
          xl[a.N + bmidl] = rr;
        else
          xl[2L * a.N - 1 - bmids] = rr;
      }
      ++(mp > kMaxCols ? bbig
                       : (mp > kXlCols ? bxl : (mp > kMidSplit ? bmidl : bmids)));
      ++q;
      continue;
    }
    const int G = pass_width(mp, wide);
    const int R = 32 / G;
    const long slot = mp > 40 ? blong++ : a.N - 1 - bshort++;
    int* rec = a.plan + kHeader + 8 * slot;
    if (lane < 4) rec[lane] = (lane < R && q + lane < nlive) ? rr : -1;
    if (lane == 4) rec[4] = (G << 8) | ((mp + G - 1) / G);
    q += R;
  }
}

// Persistent warps, each taking the next pass of the plan (the long
// ones first) until none is left. Launched as the block rows' dependent
// (programmatic dependent launch), they fill the SMs beside those rows;
// a warp leaves only once the block rows' kernel is done, so that work
// queued after this kernel sees every row written.
__global__ void __launch_bounds__(32, kPassWarpsPerSM) pass_kernel(const Args a) {
  const int nlong = a.plan[0], total = nlong + a.plan[1];
  for (;;) {
    int t = 0;
    if (threadIdx.x == 0) t = atomicAdd(&a.plan[2], 1);
    t = __shfl_sync(kFull, t, 0);
    if (t >= total) break;
    const long slot = t < nlong ? t : a.N - 1 - (t - nlong);
    dispatch(a, a.plan + kHeader + 8 * slot);
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// One row on a block of P threads: a skewed wavefront over the block's
// threads. Thread t owns C consecutive pattern columns of the
// current strip (P * C columns wide; a wider row runs strip by strip)
// and works on text row s - t at step s. From thread t - 1, which
// finished row i one step earlier, come H of its last column at row i
// (the next row's diagonal input) and the F carry after it (value,
// log-prob, counts, run start): inside a warp by shuffle, across warps
// through a two-slot shared ring (one barrier a step), across strips
// through `bnd`, where the strip's last thread writes them for every
// text row and the next strip's thread 0 reads them one step ahead.
// The readouts stay per thread and are reduced once a row; `xf` and
// `red` are the block's shared ring and reduction slots.
template <int P, int C>
__device__ __forceinline__ void wavefront_row(const Args& a, int row,
                                              int4* my_bnd,
                                              int (&xf)[2][P / 32][7],
                                              int (&red)[P / 32][5]) {
  constexpr int NW = P / 32, SW = P * C;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int L = a.L, OPEN = a.OPEN, EXT = a.EXT;
  const float log_open = a.log_open, log_ext = a.log_ext;
  const int pl = clamp_len(a.plen[row], L), tl = clamp_len(a.tlen[row], a.T);
  const int S = (pl + SW - 1) / SW;
  const int si = a.sinit[row];
  const long prow = (long)row * L;
  const unsigned char* trow = a.text + (long)row * a.T;
  // readouts of this thread's cells: global (column plen-1, ties to
  // the later row) and local (larger value, earlier row, larger column)
  bool owns_g = false;
  int bg = -1, bg_row = 0, bg_ct = 0;
  float bg_lp = a.neg_f;
  int bl = -1, bl_row = 0, bl_col = 0, bl_ct = 0;
  float bl_lp = a.neg_f;

  for (int k = 0; k < S; ++k) {
    const int base = k * SW + t * C;
    const int nact = min(P, (pl - k * SW + C - 1) / C);
    // columns past plen are dead: the local readout skips them
    const int nlive = min(max(pl - base, 0), C);
    int pc[C], h[C], hc[C], e[C], ec[C];
    float lq[C], hl[C], el[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = base + c;
      const bool live = j < pl;
      pc[c] = live ? (int)a.pat[prow + j] : 0;
      lq[c] = live ? a.logq[prow + j] : 0.0f;
      // row -1: leading pattern insertions charged from score_init
      h[c] = live ? max(0, si - OPEN - j * EXT) : kNegI;
      hl[c] = __fadd_rn(__fmul_rn((float)j, log_ext), log_open);
      hc[c] = (j + 1) << 10;
      e[c] = 0;
      el[c] = a.neg_f;
      ec[c] = 0;
    }
    // diagonal input of column `base` at the current row: H(i-1,
    // base-1); column -1 at row -1 is score_init itself
    int dh, dc;
    float dl;
    if (base == 0) {
      dh = si;
      dl = 0.0f;
      dc = 0;
    } else {
      dh = max(0, si - OPEN - (base - 1) * EXT);
      dl = __fadd_rn(__fmul_rn((float)(base - 1), log_ext), log_open);
      dc = base << 10;
    }
    // what this thread hands thread t + 1: H of its last column and the
    // F carry after it, for the row it just finished
    int oh = 0, ohc = 0, orv = kNegI, orct = 0;
    float ohl = 0.0f, orlp = 0.0f, orj = 0.0f;
    int4 nx0 = make_int4(0, 0, 0, 0), nx1 = nx0;
    if (t == 0 && k > 0) {
      nx0 = __ldcg(my_bnd);
      nx1 = __ldcg(my_bnd + 1);
    }
    const int cstar = pl - 1 - base;  // global column's slot
    owns_g = owns_g || (cstar >= 0 && cstar < C);
    int sl = -1, sl_row = 0, sl_col = 0, sl_ct = 0;
    float sl_lp = a.neg_f;
    const int baseE = base * EXT;
    const int baseS = base << 10;
    const float basef = (float)base;
    int tb_nx = trow[0];
    const int steps = tl + nact - 1;

    for (int s = 0; s < steps; ++s) {
      int ih = __shfl_up_sync(kFull, oh, 1);
      float ihl = __shfl_up_sync(kFull, ohl, 1);
      int ihc = __shfl_up_sync(kFull, ohc, 1);
      int rv = __shfl_up_sync(kFull, orv, 1);
      float rlp = __shfl_up_sync(kFull, orlp, 1);
      int rct = __shfl_up_sync(kFull, orct, 1);
      float rjf = __shfl_up_sync(kFull, orj, 1);
      const int i = s - t;
      if (lane == 0 && w > 0) {
        const int* x = xf[(s - 1) & 1][w - 1];
        ih = x[0];
        ihl = __int_as_float(x[1]);
        ihc = x[2];
        rv = x[3];
        rlp = __int_as_float(x[4]);
        rct = x[5];
        rjf = __int_as_float(x[6]);
      } else if (t == 0 && k > 0) {
        // the previous strip's last column at row i (= s)
        ih = nx0.x;
        ihl = __int_as_float(nx0.y);
        ihc = nx0.z;
        rv = nx0.w;
        rlp = __int_as_float(nx1.x);
        rct = nx1.y;
        rjf = __int_as_float(nx1.z);
        if (s + 1 < tl) {
          nx0 = __ldcg(my_bnd + 2L * (s + 1));
          nx1 = __ldcg(my_bnd + 2L * (s + 1) + 1);
        }
      } else if (t == 0) {
        // column -1 at row i (the next row's h_init): i + 1 deletions
        ih = max(0, si - OPEN - i * EXT);
        ihl = __fadd_rn(log_open, __fmul_rn((float)i, log_ext));
        ihc = i + 1;
        rv = kNegI;  // no insertion run enters column 0
      }
      const int tb = tb_nx;
      tb_nx = trow[min(max(i + 1, 0), tl - 1)];
      if (t < nact && i >= 0 && i < tl) {
        const bool tbn = tb >= 4;
        // carry: rv = best max(M - OPEN, 0) + l * EXT over columns
        // l < j, rlp its open log-prob, rct its counts less (l << 10),
        // rj = l - base
        float rj = __fsub_rn(rjf, basef);
        int hd = dh, hdc = dc;
        float hdl = dl;
        int rk = -1, rkc = 0, gv = 0, gc = 0;
        float rkl = 0.0f, gl = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const bool eq = tb == pc[c];
          // mismatch: -SUB, or -1 where the pattern or text has an N
          int sc = eq ? a.MATCH : (pc[c] >= 4 ? -1 : -a.SUB);
          sc = tbn ? -1 : sc;
          const int m = hd > 0 ? hd + sc : 0;
          const float mlp = __fadd_rn(hdl, eq ? 0.0f : lq[c]);
          const int mct = hdc + (eq ? 0 : (1 << 20));
          const int tt = max(m - OPEN, 0);
          const int adj = tt + baseE + c * EXT;
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
          const bool tx = e_ext > tt;
          const float eln = tx ? __fadd_rn(el[c], log_ext) : slp;
          ec[c] = (tx ? ec[c] : mct) + 1;
          e[c] = tx ? e_ext : tt;
          el[c] = eln;
          // the old H is the next column's diagonal input
          hd = h[c];
          hdl = hl[c];
          hdc = hc[c];
          h[c] = hh;
          hl[c] = hhl;
          hc[c] = hhc;
          // local: the row's best of this thread's columns, ties to the
          // larger
          const int key = hh * 16 + c;
          if (c < nlive && key > rk) {
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
        if ((rk >> 4) > sl) {  // strictly greater: the earlier row keeps it
          sl = rk >> 4;
          sl_row = i;
          sl_col = base + (rk & 15);
          sl_lp = rkl;
          sl_ct = rkc;
        }
        if (t == P - 1 && k + 1 < S) {
          __stcg(my_bnd + 2L * i, make_int4(oh, __float_as_int(ohl), ohc, orv));
          __stcg(my_bnd + 2L * i + 1,
                 make_int4(__float_as_int(orlp), orct, __float_as_int(orj), 0));
        }
      }
      if (lane == 31 && w + 1 < NW) {
        int* x = xf[s & 1][w];
        x[0] = oh;
        x[1] = __float_as_int(ohl);
        x[2] = ohc;
        x[3] = orv;
        x[4] = __float_as_int(orlp);
        x[5] = orct;
        x[6] = __float_as_int(orj);
      }
      __syncthreads();
    }
    if (sl > bl || (sl == bl && (sl_row < bl_row ||
                                 (sl_row == bl_row && sl_col > bl_col)))) {
      bl = sl;
      bl_row = sl_row;
      bl_col = sl_col;
      bl_lp = sl_lp;
      bl_ct = sl_ct;
    }
  }

  int* oi = a.out_i + (long)row * 7;
  if (owns_g) {
    oi[0] = bg;
    oi[1] = bg_row;
    oi[2] = bg_ct;
    a.out_f[(long)row * 2] = bg_lp;
  }
  // local: larger value, then the earlier row, then the larger column
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(kFull, bl, off);
    const int orow = __shfl_xor_sync(kFull, bl_row, off);
    const int ocol = __shfl_xor_sync(kFull, bl_col, off);
    const int oct = __shfl_xor_sync(kFull, bl_ct, off);
    const float olp = __shfl_xor_sync(kFull, bl_lp, off);
    if (ov > bl ||
        (ov == bl && (orow < bl_row || (orow == bl_row && ocol > bl_col)))) {
      bl = ov;
      bl_row = orow;
      bl_col = ocol;
      bl_ct = oct;
      bl_lp = olp;
    }
  }
  if (lane == 0) {
    red[w][0] = bl;
    red[w][1] = bl_row;
    red[w][2] = bl_col;
    red[w][3] = bl_ct;
    red[w][4] = __float_as_int(bl_lp);
  }
  __syncthreads();
  if (t == 0) {
    for (int q2 = 1; q2 < NW; ++q2) {
      const int* r = red[q2];
      if (r[0] > bl ||
          (r[0] == bl && (r[1] < bl_row || (r[1] == bl_row && r[2] > bl_col)))) {
        bl = r[0];
        bl_row = r[1];
        bl_col = r[2];
        bl_ct = r[3];
        bl_lp = __int_as_float(r[4]);
      }
    }
    oi[3] = bl;
    oi[4] = bl_row;
    oi[5] = bl_col;
    oi[6] = bl_ct;
    a.out_f[(long)row * 2 + 1] = bl_lp;
  }
}

// Persistent blocks, each taking the next big row of the plan (more than
// kMaxCols columns) until none is left.
template <int P, int C>
__global__ void __launch_bounds__(P, kRowBlocksPerSM) pass_row_kernel(
    const Args a, int4* __restrict__ bnd) {
  __shared__ int xf[2][P / 32][7];
  __shared__ int red[P / 32][5];
  __shared__ int item;
  const int total = a.plan[5];
  const int* big = a.plan + kHeader + 8L * a.N + a.N - 1;  // big[-q]
  int4* my_bnd = bnd + (long)blockIdx.x * a.T * 2;
  for (;;) {
    if (threadIdx.x == 0) item = atomicAdd(&a.plan[6], 1);
    __syncthreads();
    const int q = item;
    __syncthreads();  // `item` is read before thread 0 takes the next
    if (q >= total) return;
    wavefront_row<P, C>(a, big[-q], my_bnd, xf, red);
  }
}

// Persistent blocks of P threads (B resident per SM), each taking the
// next block row of the plan (kBlockCols < plen <= P * kMidC columns,
// one strip), longest first: the xl rows, then the mid rows over
// kMidSplit columns, then the other mid rows, until none is left. A row
// runs at the fewest columns a thread that cover it: C = ceil(plen / P),
// so that nearly every thread and lane of the block holds columns (the
// instances no such row takes compile away). The pass kernel, launched
// as this kernel's programmatic dependent, starts once every block has.
template <int P, int B>
__global__ void __launch_bounds__(P, B) pass_xl_row_kernel(const Args a) {
  __shared__ int xf[2][P / 32][7];
  __shared__ int red[P / 32][5];
  __shared__ int item;
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int nxl = a.plan[3], nmidl = a.plan[7];
  const int total = nxl + nmidl + a.plan[8];
  const int* xl = a.plan + kHeader + 8L * a.N;
  const int* mid = xl + a.N;
  for (;;) {
    if (threadIdx.x == 0) item = atomicAdd(&a.plan[4], 1);
    __syncthreads();
    const int q = item;
    __syncthreads();  // `item` is read before thread 0 takes the next
    if (q >= total) return;
    const int row = q < nxl ? xl[q]
                            : (q < nxl + nmidl ? mid[q - nxl]
                                               : mid[a.N - 1 - (q - nxl - nmidl)]);
    const int cols = (clamp_len(a.plen[row], a.L) + P - 1) / P;
    // one strip: no scratch
#define SNAP_AG_ROW(CC)                                                   \
    if (P * CC > kBlockCols && CC < kMidC && cols <= CC) {                \
      wavefront_row<P, (CC < kMidC ? CC : kMidC)>(a, row, nullptr, xf, red); \
      continue;                                                           \
    }
    SNAP_AG_ROW(2)
    SNAP_AG_ROW(3)
    SNAP_AG_ROW(4)
    SNAP_AG_ROW(5)
    SNAP_AG_ROW(6)
    SNAP_AG_ROW(7)
#undef SNAP_AG_ROW
    wavefront_row<P, kMidC>(a, row, nullptr, xf, red);
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
  // L > kMaxCols: `blocks` row blocks; with more than one strip a row,
  // `scratch` holds 8 T words per block
  const int strips = (L + kRowCols - 1) / kRowCols;
  if (L > kMaxCols && (blocks <= 0 || L >= kMaxWidth ||
                       (strips > 1 && scratch == nullptr)))
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
    pass_row_kernel<kRowThreads, kRowC><<<(unsigned)blocks, kRowThreads, 0, s>>>(
        a, (int4*)scratch);
  if (L <= kBlockCols) {  // no row leaves the passes
    pass_kernel<<<(unsigned)min(N, slots), 32, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  // the block rows start first, as many at once as fit; the short passes
  // start as soon as all of them have (programmatic dependent launch)
  pass_xl_row_kernel<kMidThreads, kMidBlocksPerSM>
      <<<(unsigned)min(N, sms * kMidBlocksPerSM), kMidThreads, 0, s>>>(a);
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)min(N, slots));
  cfg.blockDim = dim3(32);
  cfg.stream = s;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, pass_kernel, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
