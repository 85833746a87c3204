// Device code shared by K1 (pack.cu) and K2 (wavefront.cu): the pieces of
// one first-fit row placement that both kernels compute the same way.
//
// For group g with count c > 0, per node lane n
//     fit   = min over r with req[g,r] > 0 of max(free[n,r], 0) / req[g,r]
//     fit   = mask bit of g at n ? fit : 0
//     fit   = limit_one[g] ? min(fit, 1) : fit
//     fit   = min(fit, c)
//     place = clip(c - (inclusive_prefix(fit)[n] - fit), 0, fit)
//
// - No division. max(free,0) / d for d >= 2 is __umulhi(x, m) >> s with
//   s = ceil(log2 d) - 1 and m = ceil(2^(32+s) / d), exact for every x <
//   2^31 (the error x*(m*d - 2^(32+s)) / (d*2^(32+s)) stays below 1/d);
//   d == 1 is x itself. `divisor` computes (m, s) once per (group,
//   resource), `quotient` applies them (K2; K1 writes the same expression
//   out in its loop).
// - A saturating prefix. With cap = c, place = min(incl, cap) - min(excl,
//   cap), and a sum saturated at cap stays exact below it, so the scan runs
//   in 32-bit unsigned (two values <= cap < 2^31 never overflow). K1 scans
//   K lanes a thread at once in its row pass; K2 scans one lane a thread
//   with warp_scan_sat and sums across a warp with warp_sum_sat.
// - The CTA's shape for a row of N lanes (row_shape): K lanes a thread,
//   as few threads as cover the row.

#pragma once

#include <cuda_runtime.h>

namespace ka {

constexpr int kBig = 1 << 30;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMinLanes = 2;  // node lanes per thread and chunk: 512 threads cover 1,024
constexpr int kMaxLanes = 8;
constexpr int kNoLimit = -2;   // shift code of a resource the group does not request
constexpr int kIdentity = -1;  // shift code of a request of 1

// a * b in int32 with the wrap-around of the plain version's int32 tensors
__device__ __forceinline__ int mul_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// the multiplier and shift code of request d (see the header)
__device__ __forceinline__ void divisor(int d, unsigned& m, int& s) {
  m = 0;
  s = kNoLimit;
  if (d == 1) {
    s = kIdentity;
  } else if (d > 1) {
    s = 31 - __clz(d - 1);  // ceil(log2 d) - 1
    m = static_cast<unsigned>(((1ull << (32 + s)) + d - 1) / d);
  }
}

// max(f, 0) / d by the codes (m, s) of a request d > 0
__device__ __forceinline__ unsigned quotient(int f, unsigned m, int s) {
  const unsigned x = static_cast<unsigned>(max(f, 0));
  return s == kIdentity ? x : (__umulhi(x, m) >> s);
}

// the inclusive prefix of x over the warp's lanes, saturated at cap
// (x <= cap on every lane)
__device__ __forceinline__ unsigned warp_scan_sat(unsigned x, unsigned cap, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(kFullMask, x, off);
    if (lane >= off) x = min(x + y, cap);
  }
  return x;
}

// the sum of x over the warp's lanes, saturated at cap, on every lane
// (x <= cap on every lane)
__device__ __forceinline__ unsigned warp_sum_sat(unsigned x, unsigned cap) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = min(x + __shfl_xor_sync(kFullMask, x, off), cap);
  return x;
}

// K lanes per thread (K = ceil(N / 1024), kMinLanes to kMaxLanes), and as
// few threads as cover the row with K lanes each
inline void row_shape(int N, int& K, int& threads) {
  K = (N + kMaxThreads - 1) / kMaxThreads;
  K = K < kMinLanes ? kMinLanes : (K > kMaxLanes ? kMaxLanes : K);
  threads = (N + K - 1) / K;
  threads = ((threads + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
}

}  // namespace ka
