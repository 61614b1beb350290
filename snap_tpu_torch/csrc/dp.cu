// Fitting edit distance (Landau-Vishkin equivalent) for Hopper (sm_90a).
//
// Replaces: snap_tpu/ops/dp_pallas.py fitting_edit_distance_pallas (the
// Pallas kernel _kernel, lines 48-187). Plain PyTorch version:
// snap_tpu_torch/ops/dp.py fitting_edit_distance_core_plain.
//
// Work: per candidate row, a 3-state (M/I/D) DP over L pattern rows and
// W+1 text columns with packed (edits << 10 | indels) costs, so ties go
// to the fewest indels; the log-probability of the chosen path rides
// along. The in-row deletion recurrence is a min-plus prefix scan whose
// ties keep the earlier run start; the answer is read at row plen with
// ties to the smallest end column. anchored=1 pins the text start at
// column 0 (each leading deletion costs an edit).
//
// What bounds it on this card: operations. A row reads L+4L+W bytes and
// writes 12, but its plen * (W+1) cells each take 26 integer (compare,
// select, add) and 7 float operations of the plain recurrence, and
// Hopper runs integer operations at a quarter of its float32 FLOP rate.
//
// Rows of up to kWarpCols = 256 columns (W + 1; the main path's L = 128
// rows): one warp per candidate row. Each lane owns C <= 8 consecutive
// columns in registers (all six state planes plus its text bases), so no
// state leaves the register file during the row loop. The diagonal move
// needs the left neighbour's previous value: one __shfl_up_sync per row.
// The deletion scan is a lane-local pass over the lane's C columns, a
// 5-step __shfl_up_sync scan over lane aggregates carrying (cost,
// log-prob, column), then a second local pass — the (cost, column) pair
// replaces the TPU kernel's column-in-low-bits packing. The loop stops
// after row plen (later rows cannot change the answer). Float adds and
// multiplies are __fadd_rn/__fmul_rn in the plain version's order (and
// -fmad=false), so the log-probabilities match it bit for bit.
//
// Rows of 257-512 columns (-rl 256's 285, -rl 400's 429) take
// fitting_dp_mid_kernel, wider ones fitting_dp_row_kernel (reads past
// 483 bp at the default -d): both a skewed wavefront a row.
//
// What held the one-warp design back at 257-512 columns: 32 lanes of 12
// or 16 columns (512 columns computed for -rl 400's 429), 151 registers
// (C = 16; C = 12 at 128 with 8 bytes spilled), and per pattern row one
// warp's dependent chain of two shuffles, a 16-step local min, a 5-level
// shuffle scan of three values and a second 16-step pass, with about 8
// rows per SM to hide it. It ran at 3.54x its bound on the first -rl 400
// batch (H100 80GB HBM3, 700.00 W).
//
// This design for them (fitting_dp_mid_kernel): the long rows' skewed
// wavefront in one strip, so there is no scan: the deletion carry and
// the diagonal input arrive from thread t - 1. Its shape follows the
// launch. Past kFewRowsPerSM = 4 rows per SM (1024 or 2048 rows) the
// SMs are full, so a row takes one warp (no barrier, no shared ring;
// C = ceil((W + 1) / 32) = 9-16 columns a lane: all 32 lanes busy at
// 285, 31 at 429); with fewer rows (256, 512) a launch lasts one row's
// chain of steps, so a row takes 128 threads of 3-4 columns, which
// shortens each step. A first cut of 64 threads of 8 columns for every
// launch lost to the one-warp kernel on 1024-row launches (0.52 against
// 0.42 ms, H100 80GB HBM3, 700.00 W): its second warp held 22 of 32
// lanes' columns at 429 (4 at 285) and each cell took ~50
// instructions. So the mid kernel also does less per cell than the
// long rows' kernel: no column-0 test past thread 0's first column, the
// run start carried as a float relative to the thread's first column
// (no int-to-float conversion a cell), the new insertion as min(M, I)
// plus a step, the harvest once a row.
// Blocks take rows from the counter, longest first (kRowClasses passes
// over the rows by plen). With 128 threads every row starts at once (6
// blocks per SM); on the one-warp route a launch takes one warp per
// kMidRowsPerWarp = 2 rows (at most 8 per SM), so that the warps that
// finish early take the short rows and the SMs end together: all rows
// at once left an SM with two of -rl 400's longest rows on one
// scheduler while others idled (first -rl 400 batch, H100 80GB HBM3,
// 700.00 W: 1.54 ms at one row a warp, 1.42 at two, 2.17 at four).
// ptxas (sm_90a): one warp 164-215 registers at 9-16 columns, 128
// threads 62 and 72 at 3 and 4; no spills; 44 and 212 bytes of shared
// memory.
//
// What held the first design of the long rows' kernel back (one
// 256-thread block a row, every thread on the same pattern row): (a)
// its six state planes lived in scratch in device memory, so a thread
// walked its 6-7 columns through L1/L2 twice per pattern row; (b) each
// pattern row was a block-wide step with four barriers, two of them in a
// block scan whose cross-warp step walked the lower warps' totals one by
// one; (c) at most 4 blocks per SM of mostly stalled warps. It ran at
// 78.7x its bound on the first 1500 bp batch (H100 80GB HBM3, 700.00 W).
//
// This design (the 256-thread instance):
// - State in registers: 256 threads a row, 8 columns a thread (kRowC,
//   a template parameter), all six planes and the text bases in
//   registers; a row of up to 2048 columns is one strip.
// - A skewed wavefront instead of block scans: thread t works on pattern
//   row s - t at step s, so the diagonal input (the previous row's best
//   of the left column) and the deletion carry (value, log-prob and
//   column of the argmin over the columns to the left, ties to the
//   earlier column) arrive from thread t - 1, which finished that row one
//   step earlier: by __shfl_up_sync inside a warp, through a two-slot
//   shared ring across warps, one barrier a step.
// - The harvest at row plen - 1 stays per thread and is reduced once per
//   row.
// - Wider rows (the 20 kb reads: W + 1 = 22,002) run strip by strip: the
//   strip's last thread writes its carry for every pattern row to the
//   block's scratch (8 words a row, plen rows), and the next strip's
//   thread 0 reads it one step ahead, in place.
// - Persistent blocks, 2 per SM (<= 128 registers), take rows from a
//   counter; rows without a harvest row (plen 0 or > L) only write it.
//   ptxas (sm_90a): 118 registers, 0 bytes spilled, 420 bytes of shared
//   memory.
// A column's key needs no packing: (value, column) pairs travel as two
// ints, for any width below 2^24 (kMaxWidth).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kEditUnit = 1 << 10;
constexpr int kStep = kEditUnit + 1;  // one edit + one indel base
constexpr int kPinf = 1 << 29;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpCols = 32 * 8;  // one warp a row: up to 8 columns a lane
// rows of 257-512 columns (fitting_dp_mid_kernel), one strip: a launch
// of more than kFewRowsPerSM rows per SM takes one warp a row, one of
// fewer 128 threads a row. Threads a row, the most columns a thread (the
// largest SNAP_DP_MID case), resident blocks per SM, for each.
constexpr int kFewRowsPerSM = 4;
constexpr int kRowClasses = 4;  // passes over the rows, longest first
constexpr int kMidRowsPerWarp = 2;  // one-warp route: rows per block
constexpr int kMidThreads = 32;
constexpr int kMidC = 16;
constexpr int kMidBlocksPerSM = 8;
constexpr int kMidFewThreads = 128;
constexpr int kMidFewC = 4;
constexpr int kMidFewBlocksPerSM = 6;
constexpr int kMidCols = kMidThreads * kMidC;
// rows of more than kMidCols columns: threads a row, columns a thread,
// resident blocks per SM (ops/dp_cuda.py sizes the blocks and scratch
// from the same numbers)
constexpr int kRowThreads = 256;
constexpr int kRowC = 8;
constexpr int kRowCols = kRowThreads * kRowC;
constexpr int kRowBlocksPerSM = 2;
constexpr int kMaxWidth = 1 << 24;  // columns (as float, exact below)

// One warp a row of W + 1 <= kWarpCols columns, C columns a lane.
template <int C>
__global__ void __launch_bounds__(128) fitting_dp_kernel(
    const unsigned char* __restrict__ pat, const float* __restrict__ logq,
    const int* __restrict__ plen, const unsigned char* __restrict__ text,
    int* __restrict__ out_packed, float* __restrict__ out_lp,
    int* __restrict__ out_end, int N, int L, int W, int anchored,
    float log_open, float log_ext, float neg) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= N) return;  // uniform per warp
  const int NC = W + 1;
  const int base = lane * C;

  int m[C], ii[C], d[C], tx[C];
  float mlp[C], ilp[C], dlp[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = base + c;
    // column j holds "j text bases consumed": its diagonal move reads
    // text base j-1; columns past W see pad (5, never matches)
    tx[c] = (j >= 1 && j <= W) ? (int)text[row * W + j - 1] : 5;
    if (anchored) {
      m[c] = j == 0 ? 0 : kPinf;
      d[c] = j > 0 ? j * kStep : kPinf;
      dlp[c] = j > 0 ? __fadd_rn(__fmul_rn((float)(j - 1), log_ext), log_open)
                     : neg;
    } else {
      m[c] = 0;
      d[c] = kPinf;
      dlp[c] = neg;
    }
    ii[c] = kPinf;
    mlp[c] = 0.0f;
    ilp[c] = neg;
  }

  const int pl = plen[row];
  const int nrows = min(pl, L);
  const unsigned char* prow = pat + row * L;
  const float* qrow = logq + row * L;

  for (int i = 0; i < nrows; ++i) {
    const int pb = prow[i];
    const float lq = qrow[i];

    // best of (M, I, D) of the previous row; ties prefer M, then I
    int pbest[C];
    float plp[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int ab = min(m[c], ii[c]);
      const float ablp = m[c] <= ii[c] ? mlp[c] : ilp[c];
      pbest[c] = min(ab, d[c]);
      plp[c] = ab <= d[c] ? ablp : dlp[c];
    }
    const int left = __shfl_up_sync(kFull, pbest[C - 1], 1);
    const float leftlp = __shfl_up_sync(kFull, plp[C - 1], 1);

    int mi[C], adj[C];
    float milp[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = base + c;
      const int pv = c == 0 ? left : pbest[c > 0 ? c - 1 : 0];
      const float pvlp = c == 0 ? leftlp : plp[c > 0 ? c - 1 : 0];
      int mn;
      float mnlp;
      if (j == 0) {
        mn = kPinf;
        mnlp = neg;
      } else {
        const bool mis = tx[c] != pb;
        mn = pv + (mis ? kEditUnit : 0);
        mnlp = __fadd_rn(pvlp, mis ? lq : 0.0f);
      }
      // insertion: open from M, extend from I; a tie continues the run
      const int i_open = m[c] + kStep;
      const int i_ext = ii[c] + kStep;
      const bool te = i_ext <= i_open;
      const int inew = te ? i_ext : i_open;
      const float ilpn =
          te ? __fadd_rn(ilp[c], log_ext) : __fadd_rn(mlp[c], log_open);
      m[c] = mn;
      mlp[c] = mnlp;
      ii[c] = inew;
      ilp[c] = ilpn;
      const int ab = min(mn, inew);
      const float ablp = mn <= inew ? mnlp : ilpn;
      mi[c] = min(ab, kPinf);
      milp[c] = ab <= kPinf ? ablp : neg;
      adj[c] = mi[c] - j * kStep;
    }

    // deletion: prefix min of adj over columns, ties to the earlier
    // column, carrying (log-prob, column) of the argmin
    int av = adj[0], acol = base;
    float alp = milp[0];
#pragma unroll
    for (int c = 1; c < C; ++c) {
      if (adj[c] < av) {
        av = adj[c];
        alp = milp[c];
        acol = base + c;
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ov = __shfl_up_sync(kFull, av, off);
      const float olp = __shfl_up_sync(kFull, alp, off);
      const int ocol = __shfl_up_sync(kFull, acol, off);
      if (lane >= off && !(av < ov)) {
        av = ov;
        alp = olp;
        acol = ocol;
      }
    }
    int rv = __shfl_up_sync(kFull, av, 1);
    float rlp = __shfl_up_sync(kFull, alp, 1);
    int rcol = __shfl_up_sync(kFull, acol, 1);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = base + c;
      if (j == 0) {
        d[c] = kPinf;
        dlp[c] = neg;
        rv = adj[c];
        rlp = milp[c];
        rcol = j;
      } else {
        // D[j] extends the run started at column rcol
        d[c] = rv + j * kStep;
        dlp[c] = __fadd_rn(__fadd_rn(rlp, log_open),
                           __fmul_rn((float)(j - rcol - 1), log_ext));
        if (adj[c] < rv) {
          rv = adj[c];
          rlp = milp[c];
          rcol = j;
        }
      }
    }
  }

  int bv = kPinf, bcol = 0;
  float blp = neg;
  if (pl >= 1 && pl <= L) {
    // harvest at row plen: min over real columns of min(M, I), ties to
    // the smallest column
    bv = INT_MAX;
    bcol = INT_MAX;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = base + c;
      if (j < NC) {
        const int ab = min(m[c], ii[c]);
        const float ablp = m[c] <= ii[c] ? mlp[c] : ilp[c];
        const int v = min(ab, kPinf);
        const float vlp = ab <= kPinf ? ablp : neg;
        if (v < bv) {
          bv = v;
          blp = vlp;
          bcol = j;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ov = __shfl_xor_sync(kFull, bv, off);
      const float olp = __shfl_xor_sync(kFull, blp, off);
      const int ocol = __shfl_xor_sync(kFull, bcol, off);
      if (ov < bv || (ov == bv && ocol < bcol)) {
        bv = ov;
        blp = olp;
        bcol = ocol;
      }
    }
  }
  if (lane == 0) {
    out_packed[row] = bv;
    out_lp[row] = blp;
    out_end[row] = bcol;
  }
}

// One row of W + 1 > kMidCols columns on one block: a skewed wavefront.
// Thread t owns kRowC consecutive columns of the current strip (the
// strip is kRowThreads * kRowC columns wide; a wider row runs strip by
// strip) and works on pattern row s - t at step s. What a column needs
// from its left neighbour at row i arrives from thread t - 1, which
// finished row i one step earlier: the previous row's best (M, I, D) of
// its last column (the diagonal input) and the deletion carry (min over
// its columns and those before of min(M, I) - l * STEP, with the
// log-prob and column l of the argmin, ties to the earlier column).
// Inside a warp by shuffle, across warps through a two-slot shared ring
// (one barrier a step), across strips through `bnd`: the strip's last
// thread writes the carry of every pattern row, and the next strip's
// thread 0 reads it back one step ahead of its use.
template <int P, int C>
__global__ void __launch_bounds__(P, kRowBlocksPerSM) fitting_dp_row_kernel(
    const unsigned char* __restrict__ pat, const float* __restrict__ logq,
    const int* __restrict__ plen, const unsigned char* __restrict__ text,
    int* __restrict__ out_packed, float* __restrict__ out_lp,
    int* __restrict__ out_end, int N, int L, int W, int anchored,
    float log_open, float log_ext, float neg, int* __restrict__ next_row,
    int4* __restrict__ bnd) {
  constexpr int NW = P / 32, SW = P * C;
  __shared__ int xf[2][NW][5];
  __shared__ int hv_s[NW], hcol_s[NW];
  __shared__ float hlp_s[NW];
  __shared__ int item;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int NC = W + 1;
  const int S = (NC + SW - 1) / SW;
  int4* my_bnd = bnd + (long)blockIdx.x * L * 2;

  for (;;) {
    if (t == 0) item = atomicAdd(next_row, 1);
    __syncthreads();
    const int row = item;
    __syncthreads();  // `item` is read before thread 0 takes the next
    if (row >= N) return;
    const int pl = plen[row];
    if (pl < 1 || pl > L) {  // no harvest row: the answer stays unset
      if (t == 0) {
        out_packed[row] = kPinf;
        out_lp[row] = neg;
        out_end[row] = 0;
      }
      continue;
    }
    const unsigned char* prow = pat + (long)row * L;
    const float* qrow = logq + (long)row * L;
    const unsigned char* trow = text + (long)row * W;
    // the harvest at row plen - 1: min over the real columns of
    // min(M, I), ties to the smallest column (strips run left to right)
    int hv = INT_MAX, hcol = INT_MAX;
    float hlp = neg;

    for (int k = 0; k < S; ++k) {
      const int base = k * SW + t * C;
      const int nact = min(P, (NC - k * SW + C - 1) / C);
      int m[C], ii[C], d[C], tx[C];
      float mlp[C], ilp[C], dlp[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = base + c;
        tx[c] = (j >= 1 && j <= W) ? (int)trow[j - 1] : 5;
        if (anchored) {
          m[c] = j == 0 ? 0 : kPinf;
          d[c] = j > 0 ? j * kStep : kPinf;
          dlp[c] = j > 0 ? __fadd_rn(__fmul_rn((float)(j - 1), log_ext), log_open)
                         : neg;
        } else {
          m[c] = 0;
          d[c] = kPinf;
          dlp[c] = neg;
        }
        ii[c] = kPinf;
        mlp[c] = 0.0f;
        ilp[c] = neg;
      }
      // what this thread hands thread t + 1 for the row it just finished
      int o_pv = 0, o_rv = 0, o_rcol = 0;
      float o_pvlp = 0.0f, o_rlp = 0.0f;
      int4 nx0 = make_int4(0, 0, 0, 0), nx1 = nx0;
      if (t == 0 && k > 0) {
        nx0 = __ldcg(my_bnd);
        nx1 = __ldcg(my_bnd + 1);
      }
      int pb_nx = prow[0];
      float lq_nx = qrow[0];
      const int steps = pl + nact - 1;
      for (int s = 0; s < steps; ++s) {
        int pv = __shfl_up_sync(kFull, o_pv, 1);
        float pvlp = __shfl_up_sync(kFull, o_pvlp, 1);
        int rv = __shfl_up_sync(kFull, o_rv, 1);
        float rlp = __shfl_up_sync(kFull, o_rlp, 1);
        int rcol = __shfl_up_sync(kFull, o_rcol, 1);
        const int i = s - t;
        if (lane == 0 && w > 0) {
          const int* x = xf[(s - 1) & 1][w - 1];
          pv = x[0];
          pvlp = __int_as_float(x[1]);
          rv = x[2];
          rlp = __int_as_float(x[3]);
          rcol = x[4];
        } else if (t == 0 && k > 0) {
          // the previous strip's last column at row i (= s)
          pv = nx0.x;
          pvlp = __int_as_float(nx0.y);
          rv = nx0.z;
          rlp = __int_as_float(nx0.w);
          rcol = nx1.x;
          if (s + 1 < pl) {
            nx0 = __ldcg(my_bnd + 2L * (s + 1));
            nx1 = __ldcg(my_bnd + 2L * (s + 1) + 1);
          }
        }
        const int pb = pb_nx;
        const float lq = lq_nx;
        const int inx = min(max(i + 1, 0), pl - 1);
        pb_nx = prow[inx];
        lq_nx = qrow[inx];
        if (t < nact && i >= 0 && i < pl) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int j = base + c;
            // best of (M, I, D) of the previous row; ties prefer M, then I
            const int ab0 = min(m[c], ii[c]);
            const float ab0lp = m[c] <= ii[c] ? mlp[c] : ilp[c];
            const int pbest = min(ab0, d[c]);
            const float plp = ab0 <= d[c] ? ab0lp : dlp[c];
            int mn;
            float mnlp;
            if (j == 0) {
              mn = kPinf;
              mnlp = neg;
            } else {
              const bool mis = tx[c] != pb;
              mn = pv + (mis ? kEditUnit : 0);
              mnlp = __fadd_rn(pvlp, mis ? lq : 0.0f);
            }
            pv = pbest;
            pvlp = plp;
            // insertion: open from M, extend from I; a tie continues the run
            const int i_open = m[c] + kStep;
            const int i_ext = ii[c] + kStep;
            const bool te = i_ext <= i_open;
            const int inew = te ? i_ext : i_open;
            const float ilpn =
                te ? __fadd_rn(ilp[c], log_ext) : __fadd_rn(mlp[c], log_open);
            m[c] = mn;
            mlp[c] = mnlp;
            ii[c] = inew;
            ilp[c] = ilpn;
            const int ab = min(mn, inew);
            const float ablp = mn <= inew ? mnlp : ilpn;
            const int mi = min(ab, kPinf);
            const float milp = ab <= kPinf ? ablp : neg;
            const int adj = mi - j * kStep;
            // deletion: D[j] extends the run started at column rcol
            if (j == 0) {
              d[c] = kPinf;
              dlp[c] = neg;
              rv = adj;
              rlp = milp;
              rcol = j;
            } else {
              d[c] = rv + j * kStep;
              dlp[c] = __fadd_rn(__fadd_rn(rlp, log_open),
                                 __fmul_rn((float)(j - rcol - 1), log_ext));
              if (adj < rv) {
                rv = adj;
                rlp = milp;
                rcol = j;
              }
            }
            if (i == pl - 1 && j < NC && mi < hv) {
              hv = mi;
              hlp = milp;
              hcol = j;
            }
          }
          o_pv = pv;
          o_pvlp = pvlp;
          o_rv = rv;
          o_rlp = rlp;
          o_rcol = rcol;
          if (t == P - 1 && k + 1 < S) {
            __stcg(my_bnd + 2L * i,
                   make_int4(pv, __float_as_int(pvlp), rv, __float_as_int(rlp)));
            __stcg(my_bnd + 2L * i + 1, make_int4(rcol, 0, 0, 0));
          }
        }
        if (lane == 31 && w + 1 < NW) {
          int* x = xf[s & 1][w];
          x[0] = o_pv;
          x[1] = __float_as_int(o_pvlp);
          x[2] = o_rv;
          x[3] = __float_as_int(o_rlp);
          x[4] = o_rcol;
        }
        __syncthreads();
      }
    }

    // the block's min of the harvest, ties to the smallest column
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ov = __shfl_xor_sync(kFull, hv, off);
      const float olp = __shfl_xor_sync(kFull, hlp, off);
      const int ocol = __shfl_xor_sync(kFull, hcol, off);
      if (ov < hv || (ov == hv && ocol < hcol)) {
        hv = ov;
        hlp = olp;
        hcol = ocol;
      }
    }
    if (lane == 0) {
      hv_s[w] = hv;
      hlp_s[w] = hlp;
      hcol_s[w] = hcol;
    }
    __syncthreads();
    if (t == 0) {
      for (int q = 1; q < NW; ++q)
        if (hv_s[q] < hv || (hv_s[q] == hv && hcol_s[q] < hcol)) {
          hv = hv_s[q];
          hlp = hlp_s[q];
          hcol = hcol_s[q];
        }
      out_packed[row] = hv;
      out_lp[row] = hlp;
      out_end[row] = hcol;
    }
  }
}

// One row of kWarpCols < W + 1 <= kMidCols columns on one block of P
// threads (B resident per SM), C columns a thread: the long rows' skewed
// wavefront in one strip, with less work per cell. Column 0 is only
// thread 0's first column, so no other column tests for it; the run
// start rides along as a float relative to the thread's first column
// (rr = rcol - base), so a deletion's extension count (c - 1) - rr is
// one float subtraction of exact integers (no conversion); the harvest
// runs once, at row plen - 1. Persistent blocks take rows from a
// counter, longest first: the counter walks the rows kRowClasses times,
// and pass k takes the rows of class k (plen within the k-th of
// kRowClasses equal parts of (0, L], from the top), so that the blocks
// that finish early take the short rows and the SMs end together.
// Rows without a harvest row (plen 0 or > L) only write it, in the
// last pass.
template <int P, int C, int B>
__global__ void __launch_bounds__(P, B) fitting_dp_mid_kernel(
    const unsigned char* __restrict__ pat, const float* __restrict__ logq,
    const int* __restrict__ plen, const unsigned char* __restrict__ text,
    int* __restrict__ out_packed, float* __restrict__ out_lp,
    int* __restrict__ out_end, int N, int L, int W, int anchored,
    float log_open, float log_ext, float neg, int* __restrict__ next_row) {
  constexpr int NW = P / 32;
  __shared__ int xf[2][NW][5];
  __shared__ int hv_s[NW], hcol_s[NW];
  __shared__ float hlp_s[NW];
  __shared__ int item;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int NC = W + 1;
  const int nact = (NC + C - 1) / C;  // threads with columns
  const int base = t * C;
  const int baseK = base * kStep;
  const float basef = (float)base;

  for (;;) {
    if (t == 0) item = atomicAdd(next_row, 1);
    __syncthreads();
    const int q = item;
    __syncthreads();  // `item` is read before thread 0 takes the next
    if (q >= kRowClasses * N) return;
    const int pass = q / N, row = q - pass * N;
    const int pl = plen[row];
    const bool harvest = pl >= 1 && pl <= L;
    const int cls =
        harvest ? (int)((long)(L - pl) * kRowClasses / L) : kRowClasses - 1;
    if (cls != pass) continue;
    if (!harvest) {  // no harvest row: the answer stays unset
      if (t == 0) {
        out_packed[row] = kPinf;
        out_lp[row] = neg;
        out_end[row] = 0;
      }
      continue;
    }
    const unsigned char* prow = pat + (long)row * L;
    const float* qrow = logq + (long)row * L;
    const unsigned char* trow = text + (long)row * W;
    int m[C], ii[C], d[C], tx[C];
    float mlp[C], ilp[C], dlp[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = base + c;
      tx[c] = (j >= 1 && j <= W) ? (int)trow[j - 1] : 5;
      if (anchored) {
        m[c] = j == 0 ? 0 : kPinf;
        d[c] = j > 0 ? j * kStep : kPinf;
        dlp[c] = j > 0 ? __fadd_rn(__fmul_rn((float)(j - 1), log_ext), log_open)
                       : neg;
      } else {
        m[c] = 0;
        d[c] = kPinf;
        dlp[c] = neg;
      }
      ii[c] = kPinf;
      mlp[c] = 0.0f;
      ilp[c] = neg;
    }
    // what this thread hands thread t + 1 for the row it just finished:
    // the diagonal input and the deletion carry, its column as a float
    int o_pv = 0, o_rv = 0;
    float o_pvlp = 0.0f, o_rlp = 0.0f, o_rcf = 0.0f;
    // the harvest: min over the real columns of min(M, I), ties to the
    // smallest column
    int hv = INT_MAX, hcol = INT_MAX;
    float hlp = neg;
    int pb_nx = prow[0];
    float lq_nx = qrow[0];
    const int steps = pl + nact - 1;
    for (int s = 0; s < steps; ++s) {
      int pv = __shfl_up_sync(kFull, o_pv, 1);
      float pvlp = __shfl_up_sync(kFull, o_pvlp, 1);
      int rv = __shfl_up_sync(kFull, o_rv, 1);
      float rlp = __shfl_up_sync(kFull, o_rlp, 1);
      float rcf = __shfl_up_sync(kFull, o_rcf, 1);
      const int i = s - t;
      if (lane == 0 && w > 0) {
        const int* x = xf[(s - 1) & 1][w - 1];
        pv = x[0];
        pvlp = __int_as_float(x[1]);
        rv = x[2];
        rlp = __int_as_float(x[3]);
        rcf = __int_as_float(x[4]);
      }
      const int pb = pb_nx;
      const float lq = lq_nx;
      const int inx = min(max(i + 1, 0), pl - 1);
      pb_nx = prow[inx];
      lq_nx = qrow[inx];
      if (t < nact && i >= 0 && i < pl) {
        float rr = __fsub_rn(rcf, basef);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const bool col0 = c == 0 && t == 0;
          // best of (M, I, D) of the previous row; ties prefer M, then I
          const int ab0 = min(m[c], ii[c]);
          const float ab0lp = m[c] <= ii[c] ? mlp[c] : ilp[c];
          const int pbest = min(ab0, d[c]);
          const float plp = ab0 <= d[c] ? ab0lp : dlp[c];
          const bool mis = tx[c] != pb;
          int mn = pv + (mis ? kEditUnit : 0);
          float mnlp = __fadd_rn(pvlp, mis ? lq : 0.0f);
          if (col0) {
            mn = kPinf;
            mnlp = neg;
          }
          pv = pbest;
          pvlp = plp;
          // insertion: open from M, extend from I (each one step up: the
          // new I is the smaller plus a step); a tie continues the run
          const int inew = ab0 + kStep;
          const float ilpn = ii[c] <= m[c] ? __fadd_rn(ilp[c], log_ext)
                                           : __fadd_rn(mlp[c], log_open);
          m[c] = mn;
          mlp[c] = mnlp;
          ii[c] = inew;
          ilp[c] = ilpn;
          const int ab = min(mn, inew);
          const float ablp = mn <= inew ? mnlp : ilpn;
          const int mi = min(ab, kPinf);
          const float milp = ab <= kPinf ? ablp : neg;
          const int adj = mi - (baseK + c * kStep);
          // deletion: D[j] extends the run started at column base + rr
          if (col0) {
            d[c] = kPinf;
            dlp[c] = neg;
            rv = adj;
            rlp = milp;
            rr = 0.0f;
          } else {
            d[c] = rv + (baseK + c * kStep);
            dlp[c] = __fadd_rn(__fadd_rn(rlp, log_open),
                               __fmul_rn(__fsub_rn((float)(c - 1), rr), log_ext));
            if (adj < rv) {
              rv = adj;
              rlp = milp;
              rr = (float)c;
            }
          }
        }
        o_pv = pv;
        o_pvlp = pvlp;
        o_rv = rv;
        o_rlp = rlp;
        o_rcf = __fadd_rn(rr, basef);
        if (i == pl - 1) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int ab = min(m[c], ii[c]);
            const float ablp = m[c] <= ii[c] ? mlp[c] : ilp[c];
            const int v = min(ab, kPinf);
            if (base + c < NC && v < hv) {
              hv = v;
              hlp = ab <= kPinf ? ablp : neg;
              hcol = base + c;
            }
          }
        }
      }
      if (lane == 31 && w + 1 < NW) {
        int* x = xf[s & 1][w];
        x[0] = o_pv;
        x[1] = __float_as_int(o_pvlp);
        x[2] = o_rv;
        x[3] = __float_as_int(o_rlp);
        x[4] = __float_as_int(o_rcf);
      }
      if (NW > 1) __syncthreads();  // one warp: the shuffles order the steps
    }

    // the block's min of the harvest, ties to the smallest column
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ov = __shfl_xor_sync(kFull, hv, off);
      const float olp = __shfl_xor_sync(kFull, hlp, off);
      const int ocol = __shfl_xor_sync(kFull, hcol, off);
      if (ov < hv || (ov == hv && ocol < hcol)) {
        hv = ov;
        hlp = olp;
        hcol = ocol;
      }
    }
    if (lane == 0) {
      hv_s[w] = hv;
      hlp_s[w] = hlp;
      hcol_s[w] = hcol;
    }
    __syncthreads();
    if (t == 0) {
      for (int q = 1; q < NW; ++q)
        if (hv_s[q] < hv || (hv_s[q] == hv && hcol_s[q] < hcol)) {
          hv = hv_s[q];
          hlp = hlp_s[q];
          hcol = hcol_s[q];
        }
      out_packed[row] = hv;
      out_lp[row] = hlp;
      out_end[row] = hcol;
    }
  }
}

template <int C>
void launch(const void* pat, const void* logq, const void* plen,
            const void* text, void* out_packed, void* out_lp, void* out_end,
            int N, int L, int W, int anchored, float log_open, float log_ext,
            float neg, cudaStream_t stream) {
  const int threads = 128;  // 4 rows per block
  const long blocks = ((long)N * 32 + threads - 1) / threads;
  fitting_dp_kernel<C><<<(unsigned)blocks, threads, 0, stream>>>(
      (const unsigned char*)pat, (const float*)logq, (const int*)plen,
      (const unsigned char*)text, (int*)out_packed, (float*)out_lp,
      (int*)out_end, N, L, W, anchored, log_open, log_ext, neg);
}

}  // namespace

extern "C" int fitting_dp_launch(const void* pat, const void* logq,
                                 const void* plen, const void* text,
                                 void* out_packed, void* out_lp,
                                 void* out_end, int N, int L, int W,
                                 int anchored, float log_open, float log_ext,
                                 float neg, void* counter, void* scratch,
                                 int blocks, void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  const int need = (W + 1 + 31) / 32;  // columns per lane
  cudaStream_t s = (cudaStream_t)stream;
#define SNAP_DP_CASE(CC)                                                   \
  if (need <= CC) {                                                        \
    launch<CC>(pat, logq, plen, text, out_packed, out_lp, out_end, N, L, W, \
               anchored, log_open, log_ext, neg, s);                       \
    return (int)cudaGetLastError();                                        \
  }
  SNAP_DP_CASE(1)
  SNAP_DP_CASE(2)
  SNAP_DP_CASE(3)
  SNAP_DP_CASE(4)
  SNAP_DP_CASE(5)
  SNAP_DP_CASE(6)
  SNAP_DP_CASE(8)
#undef SNAP_DP_CASE
  // W + 1 > kWarpCols: one block a row, taking rows from `counter` (one
  // int, zeroed here)
  if (counter == nullptr || W + 1 >= kMaxWidth)
    return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (W + 1 <= kMidCols) {
    // the fewest columns a thread that cover the row
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    const bool few = N <= kFewRowsPerSM * sms;
    const int cols = (W + 1 + (few ? kMidFewThreads : kMidThreads) - 1) /
                     (few ? kMidFewThreads : kMidThreads);
    // a launch of few rows: every row at once; of many: about
    // kMidRowsPerWarp rows a warp, so that the warps that finish early
    // take the short rows
    const int per = few ? 1 : kMidRowsPerWarp;
#define SNAP_DP_MID(PP, CC, BB)                                              \
  if (cols <= CC) {                                                          \
    fitting_dp_mid_kernel<PP, CC, BB>                                        \
        <<<(unsigned)min((N + per - 1) / per, sms * BB), PP, 0, s>>>(        \
        (const unsigned char*)pat, (const float*)logq, (const int*)plen,     \
        (const unsigned char*)text, (int*)out_packed, (float*)out_lp,        \
        (int*)out_end, N, L, W, anchored, log_open, log_ext, neg,            \
        (int*)counter);                                                      \
    return (int)cudaGetLastError();                                          \
  }
    if (few) {
      SNAP_DP_MID(kMidFewThreads, 3, kMidFewBlocksPerSM)
      SNAP_DP_MID(kMidFewThreads, kMidFewC, kMidFewBlocksPerSM)
    } else {
      SNAP_DP_MID(kMidThreads, 9, kMidBlocksPerSM)
      SNAP_DP_MID(kMidThreads, 10, kMidBlocksPerSM)
      SNAP_DP_MID(kMidThreads, 11, kMidBlocksPerSM)
      SNAP_DP_MID(kMidThreads, 12, kMidBlocksPerSM)
      SNAP_DP_MID(kMidThreads, 13, kMidBlocksPerSM)
      SNAP_DP_MID(kMidThreads, 14, kMidBlocksPerSM)
      SNAP_DP_MID(kMidThreads, 15, kMidBlocksPerSM)
      SNAP_DP_MID(kMidThreads, kMidC, kMidBlocksPerSM)
    }
#undef SNAP_DP_MID
  }
  // `blocks` of them; with more than one strip a row, `scratch` holds 8 L
  // words per block
  const int strips = (W + 1 + kRowCols - 1) / kRowCols;
  if (blocks <= 0 || (strips > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  fitting_dp_row_kernel<kRowThreads, kRowC>
      <<<(unsigned)blocks, kRowThreads, 0, s>>>(
          (const unsigned char*)pat, (const float*)logq, (const int*)plen,
          (const unsigned char*)text, (int*)out_packed, (float*)out_lp,
          (int*)out_end, N, L, W, anchored, log_open, log_ext, neg,
          (int*)counter, (int4*)scratch);
  return (int)cudaGetLastError();
}
