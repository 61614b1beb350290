// Block-wide helpers of the long-row kernels (csrc/dp.cu, csrc/affine.cu).
//
// A long row runs on one block of kThreads threads, each thread owning a
// run of consecutive columns. A (value, column) pair travels as one
// 64-bit key, value * 2^24 + column, so a min over keys is the
// lexicographic choice with ties to the smaller column and a max the one
// with ties to the larger column: the plain versions' packed cummin /
// cummax keys, with room for any column below 2^24.

#pragma once

namespace rows {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColBits = 24;

__device__ __forceinline__ long long key(int v, int col) {
  return (long long)v * (1LL << kColBits) + col;
}
__device__ __forceinline__ int key_value(long long k) {
  return (int)(k >> kColBits);
}
__device__ __forceinline__ int key_col(long long k) {
  return (int)(k & ((1LL << kColBits) - 1));
}

template <bool kMax>
__device__ __forceinline__ long long pick(long long a, long long b) {
  return kMax ? max(a, b) : min(a, b);
}

// The pick over the keys of the threads below this one (`ident` for
// thread 0). `tot`: kWarps shared slots, free again on return.
template <bool kMax>
__device__ long long exclusive_scan(long long v, long long ident,
                                    long long* tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  long long inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc = pick<kMax>(inc, o);
  }
  long long ex = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) ex = ident;
  if (lane == 31) tot[w] = inc;
  __syncthreads();
  for (int k = 0; k < w; ++k) ex = pick<kMax>(ex, tot[k]);
  __syncthreads();
  return ex;
}

// The pick over every thread's key, in every thread.
template <bool kMax>
__device__ long long all_reduce(long long v, long long* tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = pick<kMax>(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) tot[w] = v;
  __syncthreads();
  long long r = tot[0];
  for (int k = 1; k < kWarps; ++k) r = pick<kMax>(r, tot[k]);
  __syncthreads();
  return r;
}

}  // namespace rows
