// Tier-1 gapless prescreen for Hopper (sm_90a).
//
// Replaces: snap_tpu/ops/gapless_pallas.py gapless_prescreen_pallas
// (the Pallas kernel _kernel, lines 33-95). Plain PyTorch version:
// snap_tpu_torch/ops/gapless.py gapless_prescreen_plain.
//
// Work: for every (read b, candidate k), XOR PW 2-bit-packed text words
// with the forward or RC pattern words (by dirs[b,k]), OR in the text
// and pattern N bits, mask to the read length, popcount -> dist, and sum
// ln P(error) over the mismatching positions -> logp_err.
//
// What bounds it on this card: bytes. Each pair reads 2*PW text/bad
// words (64 B at PW=8) and writes 8 B; the per-read pattern words and
// the L floats of logq are shared by the K candidates of a read. The
// arithmetic (a few integer ops per word, one add per mismatch) is far
// below the card's integer rate.
//
// What held the first design back: each thread walked all 16*PW
// positions in one dependent chain of float adds, a load and a branch
// per position, however few bits were set.
//
// Reads of up to kOneThreadL = 128 positions (the main path's step):
// one thread per (read, candidate); threads of one read sit next to each
// other, so the per-read pattern words and logq row are fetched once
// from device memory and served to the K threads from L1. Per packed
// word, the logq terms of its set mismatch bits are fetched together (16
// predicated loads in flight instead of one dependent load per position)
// and then added in position order, skipping the clear bits, in the
// fixed order of ops/sums.py (windows of 32 positions, each summed from
// +0.0, then the window sums from +0.0), one rounded float add at a time
// (built with -fmad=false). The adds it skips are +0.0 terms and empty
// windows: ln P(error) is never -0.0 (align/pipeline.py device_logq), so
// neither is a partial sum, and adding +0.0 changes no bit. So it
// matches the plain version bit for bit.
//
// What held that design back past 128 positions (one thread a pair for
// every L, a second kernel with one open window per level past 1024):
// the thread walked all PW = ceil(L / 16) words of its pair (16 at
// -rl 256, 25 at -rl 400, 94 at 1500 bp) in one dependent chain of float
// adds, and a 1500 bp launch (B x K = 1,024-2,048 pairs) filled 4-8
// blocks of 256 threads for 132 SMs. It ran at 407x its byte bound on
// the first 1500 bp batch, 12.8x at -rl 256 and 6.39x at -rl 400 (H100
// 80GB HBM3, 700.00 W).
//
// This design past 128 positions (gapless_split_kernel): a pair's
// windows over several threads, one in each warp of a block. The
// block's G warps (threads a pair) take the same 32 pairs, lane j pair
// j, so the lanes of a warp keep the one-thread kernel's access pattern
// (the pairs of a read fetch the same logq terms and pattern words);
// warp g owns a run of consecutive first-level windows of ops/sums.py
// for its pairs. G = kFillPairs / pairs, so that a launch fills the
// card: 16 for 1500 bp's 1,024-2,048 pairs, 8-4 for -rl 256's and
// -rl 400's 4,096-16,384, 1 for their 65,536-131,072 (K = 512), below
// twice the windows.
// Window w covers positions 32w - lo .. 32w - lo + 31, which straddle
// three packed words where lo (the zeros padded in front, 0..15) is not
// 0. Per chunk of 16 G windows (at most 64), the block first stages its
// 32 pairs' text and N words of the chunk in shared memory, read
// coalesced (one pair's words lie next to each other, a lane's would
// not) and laid out [word][pair] so that a warp reads them without bank
// conflicts. A thread fetches its window's 32 logq terms together
// (16-byte loads where aligned; they do not wait for the words), packs
// the words' mismatch bits into one bit a position (a word shared with
// the window before is packed once), masks the window to
// plen and L once, and adds the terms of the set bits in position order
// from +0.0; the +0.0 terms it skips change no bit, as in the one-thread
// kernel. It counts the mismatches of words 2w and 2w + 1 (the last
// window: up to word PW - 1) within plen, so each word is counted once.
// The window sums go to shared memory, and warp 0 folds them for its
// pair as ops/sums.py does past the first level: left to right from +0.0
// when there are at most 32, else into windows of 32 whose sums fold
// again (one open window a level, closed from the lowest level up, as
// the nested sums nest; every window sum is added, +0.0 ones too). dist
// is an integer sum over the warps.
// Cuts that lost on the recorded launches (H100 80GB HBM3, 700.00 W): a
// pair's windows on neighbouring lanes of one warp (8-32 lanes a pair),
// where each logq load touched up to 16 lines, a window each (2.5x the
// one-thread kernel's time on the 131,072-pair launch of the first
// -rl 400 batch); 8 threads a pair whatever the pairs, reading each
// pair's words from device memory, where each load touched ~25 lines, a
// pair each (1.3x on the same launch); masks to plen and L a word, not a
// window (~70 instructions a word, 5% slower on the first -rl 400 batch);
// a warp's windows strided (g, g + G, ...) and the shared word packed
// twice (3-6% slower on the first -rl 400 and 1500 bp batches).
// ptxas (sm_90a): gapless_split_kernel 96-118 registers, no spills,
// 11-44 KB of dynamic shared memory a block (by its chunk);
// gapless_kernel 64 registers, no spills.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kEven = 0x55555555u;
constexpr int kThreads = 256;     // threads a block of the one-thread kernel
constexpr int kOneThreadL = 128;  // longer reads: the split kernel
// the split kernel's threads a pair (warps a block): kFillPairs / pairs,
// a power of two up to kMaxSplit and below twice the first-level
// windows; a thread takes kWindowsPerThread windows a chunk, a chunk at
// most kMaxChunk (its shared memory under 48 KB)
constexpr long kFillPairs = 1L << 16;
constexpr int kMaxSplit = 16;
constexpr int kWindowsPerThread = 16;
constexpr int kMaxChunk = 64;
constexpr int kStageLoads = 1;    // staged words a thread has in flight
constexpr int kMaxLevels = 4;     // window levels: reads of up to 32^5

// the even bits of the first n (clamped to 0..16) positions of a word
__device__ __forceinline__ unsigned even_below(int n) {
  const int r = min(max(n, 0), 16);
  return r >= 16 ? kEven : (((1u << (2 * r)) - 1u) & kEven);
}

// Reads of up to kOneThreadL positions: the order of ops/sums.py
// ordered_sum is windows of 32 positions starting `lo` positions before
// position 0 (one window when L <= 32), then the window sums: one level.
__global__ void gapless_kernel(
    const unsigned* __restrict__ tw, const unsigned* __restrict__ bw,
    const unsigned* __restrict__ fw, const unsigned* __restrict__ rw,
    const unsigned* __restrict__ fb, const unsigned* __restrict__ rb,
    const float* __restrict__ lqf, const float* __restrict__ lqr,
    const int* __restrict__ dirs, const int* __restrict__ plen,
    int* __restrict__ dist, float* __restrict__ logp,
    int B, int K, int PW, int L) {
  long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)B * K) return;
  long b = idx / K;
  bool rc = dirs[idx] == 1;
  const unsigned* t = tw + idx * PW;
  const unsigned* tb = bw + idx * PW;
  const unsigned* pw = (rc ? rw : fw) + b * PW;
  const unsigned* pb = (rc ? rb : fb) + b * PW;
  const float* lq = (rc ? lqr : lqf) + b * L;
  int pl = plen[b];
  const int lo = L <= 32 ? 0 : ((32 - L % 32) % 32) / 2;
  const int wsh = L <= 32 ? 31 : 5;
  int d = 0;
  float total = 0.0f, wacc = 0.0f;
  int cur = 0;
  for (int w = 0; w < PW; ++w) {
    unsigned x = __ldg(t + w) ^ __ldg(pw + w);
    unsigned m =
        (((x | (x >> 1)) & kEven) | __ldg(tb + w) | __ldg(pb + w)) &
        even_below(pl - 16 * w);
    d += __popc(m);
    m &= even_below(L - 16 * w);  // logq has L positions
    // the word's ln P(error) terms, fetched together, then added in
    // position order
    float v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u)
      v[u] = (m >> (2 * u)) & 1u ? __ldg(lq + 16 * w + u) : 0.0f;
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (!((m >> (2 * u)) & 1u)) continue;
      const int win = (16 * w + u + lo) >> wsh;
      if (win != cur) {
        total = __fadd_rn(total, wacc);
        wacc = 0.0f;
        cur = win;
      }
      wacc = __fadd_rn(wacc, v[u]);
    }
  }
  dist[idx] = d;
  logp[idx] = __fadd_rn(total, wacc);
}

// The window levels of ops/sums.py ordered_sum over L terms: a level per
// pass that finds more than 32 terms, with lo[l] zeros padded in front
// of its windows (none for L <= 32: one window of the L terms).
struct SumPlan {
  int levels;
  int lo[kMaxLevels];
};

// the first n (clamped to 0..32) bits
__device__ __forceinline__ unsigned below(int n) {
  return n >= 32 ? 0xffffffffu : (n <= 0 ? 0u : (1u << n) - 1u);
}

// the 16 even bits of a word's positions, packed into its low 16 bits
__device__ __forceinline__ unsigned pack_even(unsigned m) {
  m = (m | (m >> 1)) & 0x33333333u;
  m = (m | (m >> 2)) & 0x0f0f0f0fu;
  m = (m | (m >> 4)) & 0x00ff00ffu;
  return (m | (m >> 8)) & 0x0000ffffu;
}

// Reads of more than kOneThreadL positions: a block of G warps takes 32
// pairs, lane j of every warp pair j. Per chunk of `chunk` first-level
// windows, the block stages its pairs' text and N words of the chunk in
// shared memory (read coalesced, laid out [word][pair]), warp g sums a
// run of the pairs' consecutive windows into shared memory, and warp 0
// folds them in window order.
template <int G>
__global__ void __launch_bounds__(32 * G) gapless_split_kernel(
    const unsigned* __restrict__ tw, const unsigned* __restrict__ bw,
    const unsigned* __restrict__ fw, const unsigned* __restrict__ rw,
    const unsigned* __restrict__ fb, const unsigned* __restrict__ rb,
    const float* __restrict__ lqf, const float* __restrict__ lqr,
    const int* __restrict__ dirs, const int* __restrict__ plen,
    int* __restrict__ dist, float* __restrict__ logp,
    int B, int K, int PW, int L, const SumPlan sp, int chunk) {
  extern __shared__ unsigned smem[];
  const int stage = 2 * chunk + 1;       // words a chunk's windows touch
  unsigned* st = smem;                   // text words [word][33]
  unsigned* sb = st + stage * 33;        // text N words [word][33]
  float* ws = (float*)(sb + stage * 33);  // window sums [window][32]
  int* ds = (int*)(ws + chunk * 32);      // mismatch counts [warp][32]
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const long n = (long)B * K;
  const long idx = (long)blockIdx.x * 32 + lane;
  // lanes past the last pair stay for the barriers, with no windows
  const bool live = idx < n;
  const long b = live ? idx / K : 0;
  const bool rc = live && dirs[idx] == 1;
  const unsigned* pw = (rc ? rw : fw) + b * PW;
  const unsigned* pb = (rc ? rb : fb) + b * PW;
  const float* lq = (rc ? lqr : lqf) + b * L;
  const int pl = live ? plen[b] : 0;
  const int lo = sp.levels ? sp.lo[0] : 0;
  const int nw = (L + lo + 31) / 32;  // first-level windows
  int d = 0;
  // warp 0's fold: acc[l] the open window of level l (l >= 1;
  // acc[max(levels, 1)] the total), cur[l] its index
  float acc[kMaxLevels + 1];
  int cur[kMaxLevels];
#pragma unroll
  for (int l = 0; l <= kMaxLevels; ++l) acc[l] = 0.0f;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) cur[l] = 0;

  for (int c0 = 0; c0 < nw; c0 += chunk) {
    const int cn = min(chunk, nw - c0);
    // the words of windows c0 .. c0 + cn - 1: qa .. qb
    const int qa = max(0, (32 * c0 - lo + 16) / 16 - 1);
    const int qb = min(PW - 1, (32 * (c0 + cn) - lo - 1) / 16);
    const int nq = qb - qa + 1;
    // element f = ep * nq + eq (pair ep, word qa + eq): the block's
    // threads take consecutive elements, kStageLoads at a time in flight
    // each
    constexpr int S = 32 * G;
    const int pairs = (int)min(32L, n - (long)blockIdx.x * 32);
    const int dp = S / nq, dq = S - dp * nq;
    int ep = threadIdx.x / nq, eq = threadIdx.x - ep * nq;
    const unsigned* tblk = tw + (long)blockIdx.x * 32 * PW + qa;
    const unsigned* bblk = bw + (long)blockIdx.x * 32 * PW + qa;
    for (int f0 = threadIdx.x; f0 < 32 * nq; f0 += kStageLoads * S) {
      unsigned vt[kStageLoads], vb[kStageLoads];
      int at[kStageLoads];
#pragma unroll
      for (int r = 0; r < kStageLoads; ++r) {
        const bool in = ep < pairs;  // f0 + r * S < 32 * nq, a live pair
        at[r] = eq * 33 + ep;
        vt[r] = in ? __ldg(tblk + (long)ep * PW + eq) : 0u;
        vb[r] = in ? __ldg(bblk + (long)ep * PW + eq) : 0u;
        ep += dp;
        eq += dq;
        if (eq >= nq) {
          eq -= nq;
          ++ep;
        }
      }
#pragma unroll
      for (int r = 0; r < kStageLoads; ++r) {
        if (f0 + r * S < 32 * nq) {
          st[at[r]] = vt[r];
          sb[at[r]] = vb[r];
        }
      }
    }
    __syncthreads();
    // warp g: a run of consecutive windows, so that a window's last word
    // (its first in the next window, where lo is not 0) is packed once
    const int run = (cn + G - 1) / G;
    int kept_q = -1;    // the word whose packed bits are kept
    unsigned kept = 0;
    for (int w = c0 + g * run; w < min(c0 + cn, c0 + (g + 1) * run); ++w) {
      float s = 0.0f;
      if (live) {
        const int ps = 32 * w - lo;  // the window's first position
        // its 32 terms, fetched before its mismatches are known (the
        // pairs of a read fetch the same ones)
        float v[32];
        if (ps >= 0 && ps + 32 <= L &&
            (reinterpret_cast<size_t>(lq + ps) & 15) == 0) {
          const float4* v4 = reinterpret_cast<const float4*>(lq + ps);
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const float4 x = __ldg(v4 + u);
            v[4 * u] = x.x;
            v[4 * u + 1] = x.y;
            v[4 * u + 2] = x.z;
            v[4 * u + 3] = x.w;
          }
        } else if (ps >= 0 && ps + 32 <= L) {
#pragma unroll
          for (int u = 0; u < 32; ++u) v[u] = __ldg(lq + ps + u);
        } else {
#pragma unroll
          for (int u = 0; u < 32; ++u)
            v[u] = ps + u >= 0 && ps + u < L ? __ldg(lq + ps + u) : 0.0f;
        }
        const int q0 = (ps + 16) / 16 - 1;  // its word: floor(ps / 16)
        unsigned long long bits = 0;        // a bit a position from q0
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int q = q0 + j;
          if (q < 0 || q >= PW || 16 * q > ps + 31) continue;
          unsigned m = kept;
          if (q != kept_q) {
            const unsigned x = st[(q - qa) * 33 + lane] ^ __ldg(pw + q);
            m = pack_even(
                ((x | (x >> 1)) | sb[(q - qa) * 33 + lane] | __ldg(pb + q)) &
                kEven);
          }
          bits |= (unsigned long long)m << (16 * j);
          kept_q = q;
          kept = m;
        }
        // words 2w and 2w + 1 (positions 32w ..), within plen
        d += __popc((unsigned)(bits >> (32 * w - 16 * q0)) & below(pl - 32 * w));
        if (w == nw - 1) {  // the last window also counts the words past it
          for (int q = 2 * w + 2; q < PW; ++q) {
            const unsigned x = __ldg(tw + idx * PW + q) ^ __ldg(pw + q);
            d += __popc((((x | (x >> 1)) & kEven) | __ldg(bw + idx * PW + q) |
                         __ldg(pb + q)) &
                        even_below(pl - 16 * q));
          }
        }
        // within plen, and logq has L positions
        const unsigned wb =
            (unsigned)(bits >> (ps - 16 * q0)) & below(min(pl, L) - ps);
        // the terms of the set bits in position order; the plain version
        // also adds +0.0 for the clear ones, which changes no bit
#pragma unroll
        for (int u = 0; u < 32; ++u)
          if ((wb >> u) & 1u) s = __fadd_rn(s, v[u]);
      }
      ws[(w - c0) * 32 + lane] = s;
    }
    __syncthreads();
    if (g == 0) {
      for (int j = 0; j < cn; ++j) {
        // close the open windows this one is not in, lowest level first
        int win = c0 + j;
#pragma unroll
        for (int l = 1; l < kMaxLevels; ++l) {
          if (l < sp.levels) {
            win = (win + sp.lo[l]) >> 5;
            if (win != cur[l]) {
              acc[l + 1] = __fadd_rn(acc[l + 1], acc[l]);
              acc[l] = 0.0f;
              cur[l] = win;
            }
          }
        }
        acc[1] = __fadd_rn(acc[1], ws[j * 32 + lane]);
      }
    }
    // the next chunk stages its words only once warp 0 has folded (its
    // barrier there follows the fold)
  }
  ds[g * 32 + lane] = d;
  __syncthreads();
  if (g == 0 && live) {
    float total = acc[1];
#pragma unroll
    for (int l = 1; l < kMaxLevels; ++l) {
      if (l < sp.levels) {
        acc[l + 1] = __fadd_rn(acc[l + 1], acc[l]);
        total = acc[l + 1];
      }
    }
    int dt = 0;
#pragma unroll
    for (int q = 0; q < G; ++q) dt += ds[q * 32 + lane];
    dist[idx] = dt;
    logp[idx] = total;
  }
}

}  // namespace

extern "C" int gapless_prescreen_launch(
    const void* tw, const void* bw, const void* fw, const void* rw,
    const void* fb, const void* rb, const void* lqf, const void* lqr,
    const void* dirs, const void* plen, void* dist, void* logp,
    int B, int K, int PW, int L, void* stream) {
  SumPlan sp{};
  for (int n = L; n > 32; n = (n + 31) / 32) {
    if (sp.levels == kMaxLevels) return (int)cudaErrorInvalidValue;
    sp.lo[sp.levels++] = ((32 - n % 32) % 32) / 2;
  }
  const long n = (long)B * K;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned* a[6] = {(const unsigned*)tw, (const unsigned*)bw,
                          (const unsigned*)fw, (const unsigned*)rw,
                          (const unsigned*)fb, (const unsigned*)rb};
  if (L <= kOneThreadL) {
    gapless_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                     s>>>(a[0], a[1], a[2], a[3], a[4], a[5],
                          (const float*)lqf, (const float*)lqr,
                          (const int*)dirs, (const int*)plen, (int*)dist,
                          (float*)logp, B, K, PW, L);
    return (int)cudaGetLastError();
  }
  // threads a pair: kFillPairs / pairs (enough warps to fill the card),
  // a power of two from 1 to kMaxSplit, no more than the windows need
  const int nw = (L + (sp.levels ? sp.lo[0] : 0) + 31) / 32;
  int split = kMaxSplit;
  while (split > 1 && ((long)split * n > kFillPairs || split >= 2 * nw))
    split /= 2;
  const int chunk = min(kWindowsPerThread * split, kMaxChunk);
  const size_t smem = (size_t)(2 * (2 * chunk + 1) * 33 + chunk * 32 + split * 32) * 4;
  const unsigned blocks = (unsigned)((n + 31) / 32);
#define SNAP_GL_SPLIT(GG)                                                    \
  if (split == GG) {                                                         \
    gapless_split_kernel<GG><<<blocks, 32 * GG, smem, s>>>(                  \
        a[0], a[1], a[2], a[3], a[4], a[5], (const float*)lqf,               \
        (const float*)lqr, (const int*)dirs, (const int*)plen, (int*)dist,  \
        (float*)logp, B, K, PW, L, sp, chunk);                               \
    return (int)cudaGetLastError();                                          \
  }
  SNAP_GL_SPLIT(1)
  SNAP_GL_SPLIT(2)
  SNAP_GL_SPLIT(4)
  SNAP_GL_SPLIT(8)
  SNAP_GL_SPLIT(16)
#undef SNAP_GL_SPLIT
  return (int)cudaErrorInvalidValue;
}
