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
// Design: one warp per candidate row. Each lane owns C consecutive
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

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kEditUnit = 1 << 10;
constexpr int kStep = kEditUnit + 1;  // one edit + one indel base
constexpr int kPinf = 1 << 29;
constexpr unsigned kFull = 0xffffffffu;

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
                                 float neg, void* stream) {
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
  SNAP_DP_CASE(12)
  SNAP_DP_CASE(16)
#undef SNAP_DP_CASE
  return (int)cudaErrorInvalidValue;  // W + 1 > 512
}
