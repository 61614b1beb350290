// Banded affine-gap extension (AffineGapVectorized computeScore) for
// Hopper (sm_90a).
//
// Replaces: snap_tpu/ops/affine_pallas.py affine_extend_pallas (the
// Pallas kernel _kernel, lines 51-258); the global-vs-local epilogue
// (finish_extend) stays torch code, as in snap_tpu. Plain PyTorch
// version: snap_tpu_torch/ops/affine.py affine_extend_core_plain.
//
// Work: per candidate row, a Gotoh DP over tlen text rows and L pattern
// columns: H floored at 0 against score_init, E (deletion) per column,
// F (insertion) as an in-row max-plus prefix scan whose ties prefer the
// later run start. Each row updates the best global score (column
// plen-1; ties to the latest row) and the best local score (ties to the
// earliest row, then the largest column), each with its row, column,
// log-probability and packed (mismatch, insertion, deletion) counts.
//
// What bounds it on this card: operations. A row reads 5L+T bytes and
// writes 36, but its plen * tlen cells each take 44 integer (compare,
// select, add) and 7 float operations of the plain recurrence, in a
// row-to-row dependent chain.
//
// Design: one warp per candidate row; each lane owns C consecutive
// pattern columns in registers (H, E and their log-probs and counts,
// plus the pattern bases and phred log-errors), so the row loop touches
// device memory only for one text base per row. The diagonal move takes
// the left neighbour's previous H by __shfl_up_sync; the F scan is a
// lane-local pass, a 5-step __shfl_up_sync scan over lane aggregates
// carrying (value, log-prob, counts, column), and a second local pass —
// the explicit column replaces the TPU kernel's low-bit packing. The
// row readouts are warp reductions. The loop stops at tlen (the plain
// version freezes every later row). Float arithmetic is
// __fadd_rn/__fmul_rn in the plain version's order (and -fmad=false),
// so the log-probabilities match it bit for bit.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kNegI = -(1 << 29);
constexpr unsigned kFull = 0xffffffffu;

template <int C>
__global__ void __launch_bounds__(128) affine_kernel(
    const unsigned char* __restrict__ pat, const float* __restrict__ logq,
    const int* __restrict__ plen, const unsigned char* __restrict__ text,
    const int* __restrict__ tlen, const int* __restrict__ sinit,
    int* __restrict__ out_i, float* __restrict__ out_f, int N, int L, int T,
    int MATCH, int SUB, int OPEN, int EXT, float log_open, float log_ext,
    float neg_f) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= N) return;  // uniform per warp
  const int base = lane * C;
  const int pl = plen[row];
  const int tl = min(tlen[row], T);
  const int si = sinit[row];

  int pc[C], h[C], hct[C], e[C], ect[C];
  float lq[C], hlp[C], elp[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = base + c;
    const bool real = j < L;
    pc[c] = real ? (int)pat[row * L + j] : 4;
    lq[c] = real ? logq[row * L + j] : 0.0f;
    // row -1: leading pattern insertions charged from score_init
    h[c] = (real && j < pl) ? max(0, si - OPEN - j * EXT) : kNegI;
    hlp[c] = __fadd_rn(__fmul_rn((float)j, log_ext), log_open);
    hct[c] = (j + 1) << 10;
    e[c] = 0;
    elp[c] = neg_f;
    ect[c] = 0;
  }
  const int last_col = min(max(pl - 1, 0), L - 1);
  const int lc_lane = last_col / C, lc_c = last_col % C;

  int bg = -1, bg_row = 0, bg_ct = 0;
  float bg_lp = neg_f;
  int bl = -1, bl_row = 0, bl_col = 0, bl_ct = 0;
  float bl_lp = neg_f;

  for (int i = 0; i < tl; ++i) {
    const int tb = text[row * T + i];
    int h_init, hct_init;
    float hlp_init;
    if (i == 0) {
      h_init = si;
      hlp_init = 0.0f;
      hct_init = 0;
    } else {
      h_init = max(0, si - OPEN - (i - 1) * EXT);
      hlp_init = __fadd_rn(log_open, __fmul_rn((float)(i - 1), log_ext));
      hct_init = i;  // one deletion per text row consumed
    }
    const int lh = __shfl_up_sync(kFull, h[C - 1], 1);
    const float llp = __shfl_up_sync(kFull, hlp[C - 1], 1);
    const int lct = __shfl_up_sync(kFull, hct[C - 1], 1);

    int mm[C], mct[C], adj[C];
    float mlp[C], slp[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = base + c;
      int hd, hdc;
      float hdl;
      if (j == 0) {
        hd = h_init;
        hdl = hlp_init;
        hdc = hct_init;
      } else if (c == 0) {
        hd = lh;
        hdl = llp;
        hdc = lct;
      } else {
        hd = h[c > 0 ? c - 1 : 0];
        hdl = hlp[c > 0 ? c - 1 : 0];
        hdc = hct[c > 0 ? c - 1 : 0];
      }
      const bool is_n = tb >= 4 || pc[c] >= 4;
      const bool eq = tb == pc[c];
      const int s = is_n ? -1 : (eq ? MATCH : -SUB);
      mm[c] = hd > 0 ? hd + s : 0;
      mlp[c] = __fadd_rn(hdl, eq ? 0.0f : lq[c]);
      mct[c] = hdc + (eq ? 0 : (1 << 20));
      adj[c] = max(mm[c] - OPEN, 0) + j * EXT;
      slp[c] = __fadd_rn(mlp[c], log_open);
    }

    // F: prefix max of adj, ties to the later column, carrying
    // (log-prob, counts, column) of the argmax
    int av = adj[0], act = mct[0], aj = base;
    float alp = slp[0];
#pragma unroll
    for (int c = 1; c < C; ++c) {
      if (adj[c] >= av) {
        av = adj[c];
        alp = slp[c];
        act = mct[c];
        aj = base + c;
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ov = __shfl_up_sync(kFull, av, off);
      const float olp = __shfl_up_sync(kFull, alp, off);
      const int oct = __shfl_up_sync(kFull, act, off);
      const int oj = __shfl_up_sync(kFull, aj, off);
      if (lane >= off && ov > av) {
        av = ov;
        alp = olp;
        act = oct;
        aj = oj;
      }
    }
    int rv = __shfl_up_sync(kFull, av, 1);
    float rlp = __shfl_up_sync(kFull, alp, 1);
    int rct = __shfl_up_sync(kFull, act, 1);
    int rj = __shfl_up_sync(kFull, aj, 1);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = base + c;
      int f, fct;
      float flp;
      if (j == 0) {
        f = kNegI;
        flp = neg_f;
        fct = 0;
        rv = adj[c];
        rlp = slp[c];
        rct = mct[c];
        rj = j;
      } else {
        const int rm1 = j - rj - 1;
        f = rv - (j - 1) * EXT;
        flp = __fadd_rn(rlp, __fmul_rn((float)rm1, log_ext));
        fct = rct + ((rm1 + 1) << 10);
        if (adj[c] >= rv) {
          rv = adj[c];
          rlp = slp[c];
          rct = mct[c];
          rj = j;
        }
      }
      // H = max(M, E, F): E wins only if > M, F only if > max(M, E)
      const bool te = e[c] > mm[c];
      int hh = te ? e[c] : mm[c];
      float hl = te ? elp[c] : mlp[c];
      int hc = te ? ect[c] : mct[c];
      if (f > hh) {
        hh = f;
        hl = flp;
        hc = fct;
      }
      if (!(j < pl && j < L)) hh = kNegI;
      // E for the next row: max(E - EXT, M - OPEN, 0); a tie opens
      const int e_ext = e[c] - EXT;
      const int t_del = max(mm[c] - OPEN, 0);
      const bool tx = e_ext > t_del;
      const int en = tx ? e_ext : t_del;
      const float eln =
          tx ? __fadd_rn(elp[c], log_ext) : __fadd_rn(mlp[c], log_open);
      const int ecn = (tx ? ect[c] : mct[c]) + 1;
      h[c] = hh;
      hlp[c] = hl;
      hct[c] = hc;
      e[c] = en;
      elp[c] = eln;
      ect[c] = ecn;
    }

    // global readout at column plen-1; ties move to the later row
    int gv = 0, gc = 0;
    float gl = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c == lc_c) {
        gv = h[c];
        gl = hlp[c];
        gc = hct[c];
      }
    }
    gv = __shfl_sync(kFull, gv, lc_lane);
    gl = __shfl_sync(kFull, gl, lc_lane);
    gc = __shfl_sync(kFull, gc, lc_lane);
    if (gv >= bg) {
      bg = gv;
      bg_row = i;
      bg_lp = gl;
      bg_ct = gc;
    }

    // local readout: max over real columns, ties to the largest column
    int rmax = INT_MIN, cmax = -1;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = base + c;
      if (j < L && (h[c] > rmax || (h[c] == rmax && j > cmax))) {
        rmax = h[c];
        cmax = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int orm = __shfl_xor_sync(kFull, rmax, off);
      const int ocm = __shfl_xor_sync(kFull, cmax, off);
      if (orm > rmax || (orm == rmax && ocm > cmax)) {
        rmax = orm;
        cmax = ocm;
      }
    }
    if (rmax > bl) {  // uniform across the warp
      const int own = cmax / C, oc = cmax % C;
      int lc = 0;
      float ll = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c == oc) {
          ll = hlp[c];
          lc = hct[c];
        }
      }
      ll = __shfl_sync(kFull, ll, own);
      lc = __shfl_sync(kFull, lc, own);
      bl = rmax;
      bl_row = i;
      bl_col = cmax;
      bl_lp = ll;
      bl_ct = lc;
    }
  }

  if (lane == 0) {
    int* oi = out_i + row * 7;
    oi[0] = bg;
    oi[1] = bg_row;
    oi[2] = bg_ct;
    oi[3] = bl;
    oi[4] = bl_row;
    oi[5] = bl_col;
    oi[6] = bl_ct;
    out_f[row * 2] = bg_lp;
    out_f[row * 2 + 1] = bl_lp;
  }
}

template <int C>
void launch(const void* pat, const void* logq, const void* plen,
            const void* text, const void* tlen, const void* sinit,
            void* out_i, void* out_f, int N, int L, int T, int MATCH, int SUB,
            int OPEN, int EXT, float log_open, float log_ext, float neg_f,
            cudaStream_t stream) {
  const int threads = 128;  // 4 rows per block
  const long blocks = ((long)N * 32 + threads - 1) / threads;
  affine_kernel<C><<<(unsigned)blocks, threads, 0, stream>>>(
      (const unsigned char*)pat, (const float*)logq, (const int*)plen,
      (const unsigned char*)text, (const int*)tlen, (const int*)sinit,
      (int*)out_i, (float*)out_f, N, L, T, MATCH, SUB, OPEN, EXT, log_open,
      log_ext, neg_f);
}

}  // namespace

extern "C" int affine_extend_launch(const void* pat, const void* logq,
                                    const void* plen, const void* text,
                                    const void* tlen, const void* sinit,
                                    void* out_i, void* out_f, int N, int L,
                                    int T, int MATCH, int SUB, int OPEN,
                                    int EXT, float log_open, float log_ext,
                                    float neg_f, void* stream) {
  if (N <= 0 || L <= 0) return (int)cudaGetLastError();
  const int need = (L + 31) / 32;  // pattern columns per lane
  cudaStream_t s = (cudaStream_t)stream;
#define SNAP_AG_CASE(CC)                                                    \
  if (need <= CC) {                                                         \
    launch<CC>(pat, logq, plen, text, tlen, sinit, out_i, out_f, N, L, T,   \
               MATCH, SUB, OPEN, EXT, log_open, log_ext, neg_f, s);         \
    return (int)cudaGetLastError();                                         \
  }
  SNAP_AG_CASE(1)
  SNAP_AG_CASE(2)
  SNAP_AG_CASE(3)
  SNAP_AG_CASE(4)
  SNAP_AG_CASE(5)
  SNAP_AG_CASE(6)
  SNAP_AG_CASE(8)
#undef SNAP_AG_CASE
  return (int)cudaErrorInvalidValue;  // L > 256
}
