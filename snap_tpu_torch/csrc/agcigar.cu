// Emission-time affine-gap CIGAR alignment for Hopper (sm_90a).
//
// Replaces no Pallas kernel: snap_tpu computes this on the host, one row
// at a time, in native/snapio.cpp ag_tb_core (a scalar C loop). It was
// added because that loop was the largest piece of host compute of the
// port's single-end runs (the two-phase path's per-read loop and the fast
// finalize's batched AG CIGARs) while the card sat idle. Plain PyTorch
// version: snap_tpu_torch/ops/agcigar_cuda.py ag_traceback_plain.
//
// Work: per row, ag_tb_core's answer bit for bit. The affine-gap DP is
// global in the pattern (L columns) over T text rows (the genome from
// `loc`), gaps open from M only (open = gap open + extend), the best
// readout is at the last pattern column with ties to the later text row,
// and the traceback keeps ag_tb_core's four tie rules. Out: run-length
// ops in traceback order, as count << 2 | code (0 M, 1 D, 2 I), after a
// header of (runs, text rows used). All arithmetic is int32, as there.
//
// What bounds it on this card: operations. A row reads L + T bytes and
// writes a few dozen words, but its T * L cells take about 25 integer
// operations each (compare, select, add), and the traceback is one
// thread's chain of dependent reads, T + L steps long.
//
// Design: one warp a row (a block of 32 threads). Each lane owns C
// consecutive pattern columns of a stripe of 32C, C the smallest case of
// SNAP_AG_CASE that covers L / 32; its H, E and pattern bases stay in
// registers for the whole row loop. Per text row: the diagonal input of
// the lane's first column comes from the left lane by one __shfl_up_sync;
// F is the exclusive prefix max of m[l] - open + l * ext over columns
// l < j (the `pmax` scan of ag_tb_core): a local max over the lane's
// columns, a 5-step shuffle scan over the lanes, then a second local
// pass. Each cell leaves four bits of traceback (kBitI, kBitD, kBitEc,
// kBitFc: the four comparisons ag_tb_core makes on it) in one byte of a
// T x P plane, stored a word per lane where C % 4 == 0. Then lane 0 walks
// the traceback and writes only the runs to device memory. The text
// comes from the index's genome on the card.
//
// Two planes. Shared (G false): the row fits one stripe (L <= 32C) and
// its text plus a T x 32C plane fit kMaxSmem bytes; one block a row.
// Global (G true, C 16): any other row. Its plane lies in a slot of the
// scratch buffer, one slot a block, each block taking rows blockIdx.x,
// + gridDim.x, ...; the columns go in stripes of 512, left to right, each
// over all T text rows, and a stripe hands the next, per text row, its
// last column's H and the running max of F's scan term, through two
// arrays of T words in the slot (double-buffered by stripe). The text
// and those arrays are read 32 rows at a time, a word per lane, and
// shuffled out a row at a time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kHeader = 2;          // runs, text rows used
constexpr int kMaxSmem = 232448;    // dynamic shared memory of one block
constexpr int kOptInSmem = 48 * 1024;  // above this a kernel must opt in
constexpr int kGlobalCols = 16;     // C of the global plane's stripes
constexpr int kNeg = -10000000;     // ag_tb_core's NEG
constexpr unsigned kFull = 0xffffffffu;

// traceback bits of a cell (i, j), the comparisons ag_tb_core makes on
// its stored M, E and F
constexpr int kBitI = 1;   // F > max(M, E): H leaves to I
constexpr int kBitD = 2;   // E > M: H leaves to D
constexpr int kBitEc = 4;  // E - ext > M - open: a D run continues up
constexpr int kBitFc = 8;  // F - ext > M - open: an I run continues left

constexpr int kOpM = 0, kOpD = 1, kOpI = 2;

__host__ __device__ inline int text_bytes(int T) { return (T + 15) & ~15; }

// a global slot: the stripes' hand-over words (2 buffers x (H, run) x T),
// then the T x P plane
__host__ __device__ inline int64_t handover_bytes(int T) {
  return ((int64_t)16 * T + 15) & ~(int64_t)15;
}

__device__ inline uint8_t plane_at(const uint8_t* tb, int64_t k, bool global) {
  return global ? __ldcg(tb + k) : tb[k];
}

template <int C, bool G>
__global__ void __launch_bounds__(kLanes)
ag_traceback_kernel(const uint8_t* __restrict__ genome,
                    const int64_t* __restrict__ meta,  // [n, 4]
                    const uint8_t* __restrict__ pat_buf,
                    int32_t* __restrict__ out, uint8_t* __restrict__ scratch,
                    int64_t slot_bytes, int n, int R, int open, int ext,
                    int match, int sub) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int S = kLanes * C;  // columns a stripe
  const int lane = threadIdx.x;
  uint8_t* slot = G ? scratch + (int64_t)blockIdx.x * slot_bytes : nullptr;

  for (int r = blockIdx.x; r < n; r += gridDim.x) {
    const int64_t pat_off = meta[4 * r];
    const int L = (int)meta[4 * r + 1];
    const int64_t loc = meta[4 * r + 2];
    const int T = (int)meta[4 * r + 3];
    int32_t* o = out + (int64_t)r * R;
    if (L <= 0 || T <= 0) {
      if (lane == 0) {
        o[0] = -1;
        o[1] = 0;
      }
      continue;
    }
    const int nst = G ? (L + S - 1) / S : 1;
    const int64_t P = (int64_t)nst * S;  // plane row stride
    uint8_t* txt = smem;
    uint8_t* tb;
    int32_t* hand = nullptr;
    if constexpr (G) {
      hand = reinterpret_cast<int32_t*>(slot);
      tb = slot + handover_bytes(T);
    } else {
      tb = smem + text_bytes(T);
      for (int t = lane; t < T; t += kLanes) txt[t] = genome[loc + t];
      __syncwarp();
    }

    int best = kNeg, best_row = -1;
    for (int s = 0; s < nst; s++) {
      const int s0 = s * S;
      const int j0 = s0 + lane * C;
      int hp[C], ev[C], pc[C];
#pragma unroll
      for (int c = 0; c < C; c++) {
        const int j = j0 + c;
        hp[c] = -(open + j * ext);
        ev[c] = kNeg;
        pc[c] = j < L ? pat_buf[pat_off + j] : 4;
      }
      const bool last = s == nst - 1;
      const int owner = (L - 1 - s0) / C;  // the lane of column L - 1
      const int c_last = (L - 1 - s0) - owner * C;
      // stripe s reads the hand-over of s - 1 and writes its own
      const int32_t* h_in = G ? hand + ((s + 1) & 1) * 2 * T : nullptr;
      const int32_t* run_in = G ? h_in + T : nullptr;
      int32_t* h_out = G ? hand + (s & 1) * 2 * T : nullptr;
      int32_t* run_out = G ? h_out + T : nullptr;
      int chunk_t = 4, chunk_h = 0, chunk_run = kNeg;

      for (int i = 0; i < T; i++) {
        int tch, carry_h = 0, carry_run = kNeg;
        if constexpr (G) {
          if ((i & (kLanes - 1)) == 0) {
            const int t = i + lane;
            if (t < T) {
              chunk_t = __ldg(genome + loc + t);
              if (s > 0) {
                chunk_h = t == 0 ? -(open + (s0 - 1) * ext) : __ldcg(h_in + t - 1);
                chunk_run = __ldcg(run_in + t);
              }
            }
          }
          tch = __shfl_sync(kFull, chunk_t, i & (kLanes - 1));
          carry_h = __shfl_sync(kFull, chunk_h, i & (kLanes - 1));
          carry_run = __shfl_sync(kFull, chunk_run, i & (kLanes - 1));
        } else {
          tch = txt[i];
        }
        // H of the column left of the stripe, one text row up
        if (s == 0) {
          carry_h = i == 0 ? 0 : -(open + (i - 1) * ext);
          carry_run = kNeg;
        }
        const int left = __shfl_up_sync(kFull, hp[C - 1], 1);
        int diag = lane == 0 ? carry_h : left;
        int m[C];
        int lmax = kNeg;
#pragma unroll
        for (int c = 0; c < C; c++) {
          const int pb = pc[c];
          const int sc = (tch >= 4 || pb >= 4) ? -1 : (tch == pb ? match : -sub);
          m[c] = diag + sc;
          diag = hp[c];
          lmax = max(lmax, m[c] - open + (j0 + c) * ext);
        }
        // exclusive prefix max over the lanes of the lane maxima, after
        // the stripes to the left
#pragma unroll
        for (int d = 1; d < kLanes; d <<= 1) {
          const int t = __shfl_up_sync(kFull, lmax, d);
          if (lane >= d) lmax = max(lmax, t);
        }
        int run = __shfl_up_sync(kFull, lmax, 1);
        run = lane == 0 ? carry_run : max(run, carry_run);
        uint32_t bits[C];
#pragma unroll
        for (int c = 0; c < C; c++) {
          const int j = j0 + c;
          const int mv = m[c], e = ev[c];
          const int f = j == 0 ? kNeg : run - (j - 1) * ext;
          const int h = max(mv, max(e, f));
          bits[c] = (f > max(mv, e) ? kBitI : 0) | (e > mv ? kBitD : 0) |
                    (e - ext > mv - open ? kBitEc : 0) |
                    (f - ext > mv - open ? kBitFc : 0);
          run = max(run, mv - open + j * ext);
          ev[c] = max(e - ext, mv - open);
          hp[c] = h;
          if (last && lane == owner && c == c_last && h >= best) {
            best = h;
            best_row = i;
          }
        }
        if (G && !last && lane == kLanes - 1) {
          __stcg(h_out + i, hp[C - 1]);
          __stcg(run_out + i, run);
        }
        uint8_t* row = tb + (int64_t)i * P + j0;
        if constexpr (C % 4 == 0) {
#pragma unroll
          for (int w = 0; w < C / 4; w++)
            reinterpret_cast<uint32_t*>(row)[w] =
                bits[4 * w] | (bits[4 * w + 1] << 8) | (bits[4 * w + 2] << 16) |
                (bits[4 * w + 3] << 24);
        } else {
#pragma unroll
          for (int c = 0; c < C; c++) row[c] = (uint8_t)bits[c];
        }
      }
      if (last) best_row = __shfl_sync(kFull, best_row, owner);
      __syncwarp();  // the hand-over and the plane, before they are read
    }

    if (lane == 0) {
      // traceback from (best_row, L - 1) in H, as ag_tb_core walks it
      int32_t* runs = o + kHeader;
      int nr = 0, cur = -1, cnt = 0;
      auto push = [&](int code, int k) {
        if (code == cur) {
          cnt += k;
          return;
        }
        if (cur >= 0) runs[nr++] = (cnt << 2) | cur;
        cur = code;
        cnt = k;
      };
      int i = best_row, j = L - 1, state = kOpM;  // kOpM stands for H here
      while (i >= 0 && j >= 0) {
        if (state == kOpM) {
          const int b = plane_at(tb, (int64_t)i * P + j, G);
          if (b & kBitI) {
            state = kOpI;
          } else if (b & kBitD) {
            state = kOpD;
          } else {
            push(kOpM, 1);
            i--;
            j--;
          }
        } else if (state == kOpD) {
          push(kOpD, 1);
          const bool cont =
              i >= 1 && (plane_at(tb, (int64_t)(i - 1) * P + j, G) & kBitEc);
          i--;
          state = cont ? kOpD : kOpM;
        } else {
          push(kOpI, 1);
          const bool cont =
              j >= 1 && (plane_at(tb, (int64_t)i * P + j - 1, G) & kBitFc);
          j--;
          state = cont ? kOpI : kOpM;
        }
      }
      if (i >= 0) push(kOpD, i + 1);
      if (j >= 0) push(kOpI, j + 1);
      runs[nr++] = (cnt << 2) | cur;
      o[0] = nr;
      o[1] = best_row + 1;
    }
    __syncwarp();  // the traceback has read the plane before the next row
  }
}

template <int C, bool G>
int launch(const void* genome, const void* meta, const void* pat, void* out,
           void* scratch, long long slot_bytes, int n, int grid, int R,
           int smem, int open, int ext, int match, int sub, cudaStream_t s) {
  auto kern = ag_traceback_kernel<C, G>;
  if (smem > kOptInSmem) {
    // the opt-in acts on the current device: kept a bit a device
    static unsigned opted_in = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= 32) return (int)cudaErrorInvalidDevice;
    if (!(opted_in >> dev & 1u)) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return (int)err;
      opted_in |= 1u << dev;
    }
  }
  kern<<<(unsigned)grid, kLanes, smem, s>>>(
      (const uint8_t*)genome, (const int64_t*)meta, (const uint8_t*)pat,
      (int32_t*)out, (uint8_t*)scratch, (int64_t)slot_bytes, n, R, open,
      ext, match, sub);
  return (int)cudaGetLastError();
}

}  // namespace

// n rows; meta [n, 4] int64 (pattern offset, L, genome location, T);
// out [n, R] int32. Shared plane (scratch NULL): one block a row; smem
// the largest row's text_bytes(T) + T * 32 * C, lane_cols C the smallest
// SNAP_AG_CASE at least ceil(max L / 32). Global plane (scratch given):
// `grid` blocks, each with a slot of slot_bytes (at least the largest
// row's handover_bytes(T) + T * ceil(L / 512) * 512) from scratch;
// lane_cols 16, smem 0. The current device must be the tensors'.
extern "C" int ag_traceback_launch(const void* genome, const void* meta,
                                   const void* pat, void* out, void* scratch,
                                   long long slot_bytes, int n, int grid,
                                   int R, int lane_cols, int smem, int open,
                                   int ext, int match, int sub, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (smem > kMaxSmem || grid <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (scratch != nullptr) {
    if (lane_cols != kGlobalCols || slot_bytes <= 0)
      return (int)cudaErrorInvalidValue;
    return launch<kGlobalCols, true>(genome, meta, pat, out, scratch,
                                     slot_bytes, n, grid, R, smem, open, ext,
                                     match, sub, s);
  }
  if (grid != n) return (int)cudaErrorInvalidValue;
#define SNAP_AG_CASE(CC)                                                   \
  if (lane_cols == CC)                                                     \
    return launch<CC, false>(genome, meta, pat, out, nullptr, 0, n, n, R,  \
                             smem, open, ext, match, sub, s);
  SNAP_AG_CASE(1)
  SNAP_AG_CASE(2)
  SNAP_AG_CASE(3)
  SNAP_AG_CASE(4)
  SNAP_AG_CASE(6)
  SNAP_AG_CASE(8)
  SNAP_AG_CASE(12)
  SNAP_AG_CASE(16)
#undef SNAP_AG_CASE
  return (int)cudaErrorInvalidValue;
}
