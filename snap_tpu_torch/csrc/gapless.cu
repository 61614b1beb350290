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
// Design: one thread per (read, candidate); threads of one read sit next
// to each other, so the per-read pattern words and logq row are fetched
// once from device memory and served to the K threads from L1. Per
// packed word, the logq terms of its set mismatch bits are fetched
// together (16 predicated loads in flight instead of one dependent load
// per position) and then added in position order, skipping the clear
// bits, in the fixed order of ops/sums.py (windows of 32 positions, each
// summed from +0.0, then the window sums from +0.0), one rounded float
// add at a time (built with -fmad=false). The adds it skips are +0.0
// terms and empty windows: ln P(error) is never -0.0
// (align/pipeline.py device_logq), so neither is a partial sum, and
// adding +0.0 changes no bit. So it matches the plain version bit for
// bit.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kEven = 0x55555555u;

// the even bits of the first n (clamped to 0..16) positions of a word
__device__ __forceinline__ unsigned even_below(int n) {
  const int r = min(max(n, 0), 16);
  return r >= 16 ? kEven : (((1u << (2 * r)) - 1u) & kEven);
}

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
  // summation order of ops/sums.py ordered_sum: windows of 32
  // positions starting `lo` positions before position 0 (one window
  // when L <= 32), then the window sums (L <= 1024: one level)
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

}  // namespace

extern "C" int gapless_prescreen_launch(
    const void* tw, const void* bw, const void* fw, const void* rw,
    const void* fb, const void* rb, const void* lqf, const void* lqr,
    const void* dirs, const void* plen, void* dist, void* logp,
    int B, int K, int PW, int L, void* stream) {
  long n = (long)B * K;
  if (n > 0) {
    int threads = 256;
    long blocks = (n + threads - 1) / threads;
    gapless_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const unsigned*)tw, (const unsigned*)bw, (const unsigned*)fw,
        (const unsigned*)rw, (const unsigned*)fb, (const unsigned*)rb,
        (const float*)lqf, (const float*)lqr, (const int*)dirs,
        (const int*)plen, (int*)dist, (float*)logp, B, K, PW, L);
  }
  return (int)cudaGetLastError();
}
