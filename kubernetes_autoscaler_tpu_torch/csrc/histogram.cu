// The VPA histogram bank's sample scatter: weights[a, b] += w and
// total[a] += w for every sample, summed in sample order.
//
// Replaces XLA's scatter-add in the reference package's
// kubernetes_autoscaler_tpu/vpa/histogram.py:116-121 (`_scatter_add`,
// `.at[agg, bucket].add(w)`), which has no Pallas kernel. On the CPU XLA
// adds a bin's samples one after another in sample order, starting from
// the bin's current value; the recommendation is the bucket end where the
// running sum crosses a quantile, so one ulp in a bin can move a pod's
// request. An atomic add on the card sums in whatever order the threads
// arrive, so the port cannot use one.
//
// Design: the wrapper sorts the samples stably by aggregate (a
// permutation; no arithmetic), and one thread owns each run of equal
// aggregates. It walks its run in sample order, adding each weight onto
// its bin in device memory (read, add, write) and onto a running total
// kept in a register, then writes the total once. A row of the bank is
// touched by one thread only, so there is no race and no atomic, and every
// bin sees its samples in the order XLA's CPU sees them.
//
// Bound on this card: bytes. Each sample is read once (aggregate, bucket,
// weight, its place in the permutation) and each touched bin is read and
// written once; the adds are a few per sample. The threads of long runs
// walk dependent loads one after another, so a heavily skewed batch (one
// aggregate owning most samples) runs at the latency of that one chain.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void hist_scatter_kernel(
    const int32_t* __restrict__ sorted_agg,  // [n] aggregates, stably sorted
    const int64_t* __restrict__ order,       // [n] sample index of each place
    const int32_t* __restrict__ bucket,      // [n] bucket of each sample
    const float* __restrict__ w,             // [n] weight of each sample
    float* weights,                          // [A, n_buckets], in place
    float* total,                            // [A], in place
    int64_t n, int n_buckets) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int a = sorted_agg[i];
  // only the first place of a run works; the wrapper has checked that
  // every aggregate and bucket lies inside the bank
  if (i > 0 && sorted_agg[i - 1] == a) return;
  float* row = weights + (int64_t)a * n_buckets;
  float t = total[a];
  for (int64_t j = i; j < n && sorted_agg[j] == a; ++j) {
    int64_t s = order[j];
    float x = w[s];
    t = __fadd_rn(t, x);
    row[bucket[s]] = __fadd_rn(row[bucket[s]], x);
  }
  total[a] = t;
}

extern "C" int ka_hist_scatter(const int32_t* sorted_agg, const int64_t* order,
                               const int32_t* bucket, const float* w,
                               float* weights, float* total, int64_t n,
                               int n_buckets, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  hist_scatter_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      sorted_agg, order, bucket, w, weights, total, n, n_buckets);
  return (int)cudaGetLastError();
}
