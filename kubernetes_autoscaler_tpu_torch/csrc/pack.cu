// K1: batched first-fit-decreasing (FFD) pack, hand-written for Hopper (sm_90a).
//
// Replaces kubernetes_autoscaler_tpu/ops/pallas/pack_kernel.py:_pack_kernel,
// the body of pack_groups_batched's pallas_call. Same function: for each
// batch row b (an independent bin pool) and each group g in `order`, per
// node lane n
//     fit   = min over r with req[g,r] > 0 of max(free[n,r], 0) / req[g,r]
//     fit   = mask bit (word g>>5, bit g&31) ? fit : 0
//     fit   = limit_one[g] ? min(fit, 1) : fit
//     fit   = min(fit, count[g])          // before the scan: a zero-request
//                                          // group has fit 2^30 per lane
//     place = clip(count[g] - (inclusive_prefix(fit)[n] - fit), 0, fit)
//     free[n,:] -= place * req[g,:]
// with placed[b,g,:] = place and scheduled[b,g] = sum(place).
//
// What bounds it. The bytes are small: the `placed` writes (B*G*N int32,
// 5.2 MB at the option shape B=20, G=64, N=1024) plus the free capacity in
// and out; that is a few microseconds of device memory time. The real bound
// is the serial depth: groups must go one after another, because each one
// sees the free capacity its predecessors left, and each group needs one
// prefix sum over every node lane of its row.
//
// The design. The TPU kernel walks node tiles in a sequential grid and
// carries the remaining count across tiles in SMEM. Here one CTA owns one
// batch row and walks the G groups itself, so the carry never leaves the
// CTA and the rows run in parallel on separate SMs (20 CTAs for the
// options, 1 for the filter). Each thread owns `lanes` CONTIGUOUS node lanes
// (thread t: [t*lanes, (t+1)*lanes)), so one block-wide scan per group
// covers any N: a thread sums its own lanes' fits, the block takes an
// exclusive scan of those sums (warp __shfl_up_sync, then the warp totals
// in shared memory), and the thread walks its lanes again from its
// exclusive offset. The serial depth is therefore G block scans whatever N
// is. The free capacity lives in shared memory as [R][N] (threads on
// neighbouring lanes hit different banks) when it fits in the opt-in
// shared memory (N*R*4 bytes plus the group metadata), else in the
// free_after buffer in device memory, read and written only by the thread
// that owns the lane. Prefix sums are int64, so no count can overflow them.
//
// Contract (checked by the Python wrapper): int32 tensors, contiguous,
// free [B,N,R], mask_bits [B,ceil(G/32),N], req [G,R], count/order/limit_one
// [G], order a permutation of 0..G-1; outputs placed [B,G,N],
// free_after [B,N,R], scheduled [B,G]. Launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kMaxThreads = 1024;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ long long warp_inclusive_scan(long long x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    long long y = __shfl_up_sync(kFullMask, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// fit of node lane n for one group, after mask, one-per-node cap and count clamp
__device__ __forceinline__ int lane_fit(const int* fcap, int sn, int sr, int n,
                                        const int* rq, int R, int mask_word,
                                        int bit, int lim, int cnt) {
  int fit = 0;
  if ((static_cast<unsigned>(mask_word) >> bit) & 1u) {
    fit = kBig;
    for (int r = 0; r < R; ++r) {
      const int rv = rq[r];
      if (rv > 0) {
        const int fr = max(fcap[n * sn + r * sr], 0);
        fit = min(fit, fr / rv);
      }
    }
  }
  if (lim) fit = min(fit, 1);
  return min(fit, cnt);
}

__global__ void __launch_bounds__(kMaxThreads)
pack_batched_kernel(const int* __restrict__ free_in, const int* __restrict__ mask_bits,
                    const int* __restrict__ req, const int* __restrict__ count,
                    const int* __restrict__ order, const int* __restrict__ limit_one,
                    int* __restrict__ placed, int* __restrict__ free_after,
                    int* __restrict__ scheduled, int G, int N, int R, int lanes,
                    int free_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* warp_tot = reinterpret_cast<long long*>(smem_raw);  // [2][32]
  int* req_s = reinterpret_cast<int*>(warp_tot + 64);            // [G*R]
  int* cnt_s = req_s + G * R;                                    // [G]
  int* ord_s = cnt_s + G;                                        // [G]
  int* lim_s = ord_s + G;                                        // [G]
  int* sched_s = lim_s + G;                                      // [G]
  int* free_s = sched_s + G;                                     // [R][N] if in smem

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nr = N * R;
  const int* fin = free_in + static_cast<size_t>(b) * nr;
  int* fout = free_after + static_cast<size_t>(b) * nr;
  const int* mrow = mask_bits + static_cast<size_t>(b) * ((G + 31) >> 5) * N;
  int* prow = placed + static_cast<size_t>(b) * G * N;

  for (int i = tid; i < G * R; i += blockDim.x) req_s[i] = req[i];
  for (int i = tid; i < G; i += blockDim.x) {
    cnt_s[i] = count[i];
    ord_s[i] = order[i];
    lim_s[i] = limit_one[i];
    sched_s[i] = 0;
  }
  // element (n, r) of the working free capacity is fcap[n*sn + r*sr]
  int* fcap;
  int sn, sr;
  if (free_in_smem) {
    fcap = free_s;
    sn = 1;
    sr = N;
    for (int i = tid; i < nr; i += blockDim.x) free_s[(i % R) * N + i / R] = fin[i];
  } else {
    fcap = fout;
    sn = R;
    sr = 1;
    for (int i = tid; i < nr; i += blockDim.x) fout[i] = fin[i];
  }
  __syncthreads();

  const int n0 = min(tid * lanes, N);
  const int n1 = min(n0 + lanes, N);

  for (int it = 0; it < G; ++it) {
    const int g = ord_s[it];
    const int cnt = cnt_s[g];
    const int lim = lim_s[g];
    const int* rq = req_s + g * R;
    const int* mword = mrow + static_cast<size_t>(g >> 5) * N;
    const int bit = g & 31;

    // pass 1: this thread's share of the row's fits
    long long local = 0;
    for (int n = n0; n < n1; ++n)
      local += lane_fit(fcap, sn, sr, n, rq, R, mword[n], bit, lim, cnt);

    // block-wide exclusive scan of the per-thread sums; the warp-total
    // buffer alternates between groups, so one group's readers never race
    // the next group's writers (two barriers separate reuse of a buffer)
    const long long incl = warp_inclusive_scan(local, lane);
    long long* wt = warp_tot + (it & 1) * 32;
    if (lane == 31) wt[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      long long w = lane < nwarps ? wt[lane] : 0;
      w = warp_inclusive_scan(w, lane);
      if (lane < nwarps) wt[lane] = w;
    }
    __syncthreads();
    long long run = (warp > 0 ? wt[warp - 1] : 0) + incl - local;

    // pass 2: place along the thread's lanes in node order
    int psum = 0;
    for (int n = n0; n < n1; ++n) {
      const int f = lane_fit(fcap, sn, sr, n, rq, R, mword[n], bit, lim, cnt);
      run += f;
      long long x = static_cast<long long>(cnt) - (run - f);
      x = x < 0 ? 0 : x;
      const int place = static_cast<int>(x < f ? x : static_cast<long long>(f));
      if (place != 0) {
        for (int r = 0; r < R; ++r) fcap[n * sn + r * sr] -= place * rq[r];
        psum += place;
      }
      prow[static_cast<size_t>(g) * N + n] = place;
    }
    if (psum != 0) atomicAdd(&sched_s[g], psum);
  }
  __syncthreads();

  for (int i = tid; i < G; i += blockDim.x) scheduled[static_cast<size_t>(b) * G + i] = sched_s[i];
  if (free_in_smem)
    for (int i = tid; i < nr; i += blockDim.x) fout[i] = free_s[(i % R) * N + i / R];
}

}  // namespace

// Per device, read or set once and reused by every later launch: the opt-in
// shared-memory limit (0 until read) and the dynamic shared-memory size the
// kernel's attribute allows so far (raised only when a launch needs more).
constexpr int kMaxDevices = 64;
static std::mutex g_smem_mu;
static int g_max_smem[kMaxDevices];
static size_t g_smem_allowed[kMaxDevices];

extern "C" int ka_pack_groups_batched(const void* free_in, const void* mask_bits,
                                      const void* req, const void* count,
                                      const void* order, const void* limit_one,
                                      void* placed, void* free_after, void* scheduled,
                                      int B, int G, int N, int R, void* stream) {
  if (B <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);

  const size_t meta = 64 * sizeof(long long) + sizeof(int) * (static_cast<size_t>(G) * R + 4 * static_cast<size_t>(G));
  const size_t free_bytes = sizeof(int) * static_cast<size_t>(N) * R;
  size_t smem;
  int free_in_smem;
  {
    std::lock_guard<std::mutex> lock(g_smem_mu);
    if (g_max_smem[dev] == 0) {
      err = cudaDeviceGetAttribute(&g_max_smem[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const size_t max_smem = static_cast<size_t>(g_max_smem[dev]);
    free_in_smem = meta + free_bytes <= max_smem;
    smem = meta + (free_in_smem ? free_bytes : 0);
    if (smem > max_smem) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > g_smem_allowed[dev]) {
      err = cudaFuncSetAttribute(pack_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      g_smem_allowed[dev] = smem;
    }
  }

  int threads = ((N + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  const int lanes = (N + threads - 1) / threads;
  pack_batched_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(free_in), static_cast<const int*>(mask_bits),
      static_cast<const int*>(req), static_cast<const int*>(count),
      static_cast<const int*>(order), static_cast<const int*>(limit_one),
      static_cast<int*>(placed), static_cast<int*>(free_after),
      static_cast<int*>(scheduled), G, N, R, lanes, free_in_smem);
  return static_cast<int>(cudaGetLastError());
}
