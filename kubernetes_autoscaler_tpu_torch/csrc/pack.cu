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
// 6.3 MB at the option shape B=24, G=64, N=1024; 1.3 MB for the filter,
// B=1, N=5120) plus the mask and the free capacity in and out, a few
// microseconds of device memory time. What bounds it is the chain of
// groups: each sees the free capacity its predecessors left, and each needs
// one prefix sum over its whole row. The row's CTA pays, per group, its
// SM's issue time for every lane's fit and scan step plus a barrier; a
// batch of one row (the filter) leaves the other SMs idle.
//
// The design. One CTA per batch row walks the groups in order. What one
// group costs is what the design cuts:
// - Lanes coalesce. The row is cut into chunks of blockDim.x * K lanes
//   (K = ceil(N / 1024), at least 2 and at most 8, so a row of up to 8,192
//   lanes is one chunk; two lanes a thread beat one at N = 1,024). Warp w
//   owns a contiguous run of 32*K lanes of each chunk; at step k lane i
//   takes lane 32k + i of that run, so every warp-wide load and store (mask
//   words, `placed`) touches consecutive addresses. A lane belongs to one
//   thread for the whole launch, so the free plane is thread-private: no
//   barrier orders its updates.
// - Everything is staged once. The CTA copies its row's free plane into
//   shared memory as [R][Np] (Np padded so the transposing copy hits
//   distinct banks) and the bit-packed mask words [ceil(G/32)][N] beside
//   it, when they fit the opt-in limit; else the free plane stays in the
//   free_after buffer and the mask in device memory, read coalesced.
// - Dead groups are skipped, block-uniformly. A group with count 0, or a
//   positive count and no mask bit in the row (OR-reduced while staging),
//   places nothing: its lanes are zero-filled by coalesced stores that
//   drain while later groups compute, with no scan and no barrier. A
//   negative count places the count on every lane, feasible or not (the
//   clamp comes after the mask), so it takes a plain per-lane update and no
//   scan.
// - One barrier per live group (and chunk). The prefix is a saturating
//   scan: with cap = count > 0, place = min(incl, cap) - min(excl, cap), and
//   a sum saturated at cap stays exact below it, so the scan runs in 32-bit
//   unsigned (two values <= cap < 2^31 never overflow). Each thread keeps
//   its K fits in registers; the warp scans its K steps at once and chains
//   them by their totals; each warp's total goes into a double-buffered
//   slot; one barrier; then every warp scans the <= 32 slots itself. The row
//   total saturated at the count is scheduled[b,g]. A row longer than one
//   chunk takes one such scan per chunk, the carry block-uniform.
// - No division: max(free,0) / d is a multiply-high and a shift with the
//   codes (m, s) of pack_row.cuh's `divisor`, computed once per (group,
//   resource), as K2 computes them. The quotient is written out in the
//   loop: pack_row.cuh's `quotient` there measured 0.6 % slower at the
//   option shape (tools/torch_kernel_ab.py).
// - One block per SM (__launch_bounds__(1024, 1)), so ptxas may give each
//   thread 64 registers; K and where the free plane and the mask live are
//   template parameters, so the fits stay in registers and shared-memory
//   accesses compile to direct loads.
// PERF.md gives each step's measured effect.
//
// Contract (checked by the Python wrapper): int32 tensors, contiguous,
// free [B,N,R], mask_bits [B,ceil(G/32),N], req [G,R], count/order/limit_one
// [G], order a permutation of 0..G-1; outputs placed [B,G,N],
// free_after [B,N,R], scheduled [B,G]. Launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include <mutex>

#include "pack_row.cuh"

namespace {

using namespace ka;

// row stride of the [R][N] free plane in shared memory: N rounded up to
// 32/R (mod 32) when R divides 32, so that the R values of the lanes a warp
// copies in turn fall in distinct banks
__host__ __device__ inline int padded_lanes(int N, int R) {
  const int want = (R > 0 && 32 % R == 0) ? (32 / R) % 32 : 0;
  return N + ((want - N % 32) % 32 + 32) % 32;
}

// byte offsets of the shared-memory arrays, in order
struct Layout {
  size_t req, mul, shift, cnt, ord, lim, any, mask, free, end;
};

__host__ __device__ inline Layout layout(int G, int N, int R, int mask_in_smem,
                                         int free_in_smem) {
  const size_t gr = static_cast<size_t>(G) * R * sizeof(int);
  const size_t g = static_cast<size_t>(G) * sizeof(int);
  const size_t words = static_cast<size_t>((G + 31) >> 5);
  Layout l;
  l.req = 2 * 32 * sizeof(unsigned);  // after the warp totals [2][32]
  l.mul = l.req + gr;
  l.shift = l.mul + gr;
  l.cnt = l.shift + gr;
  l.ord = l.cnt + g;
  l.lim = l.ord + g;
  l.any = l.lim + g;
  l.mask = l.any + words * sizeof(unsigned);
  l.free = l.mask + (mask_in_smem ? words * N * sizeof(int) : 0);
  l.end = l.free + (free_in_smem ? static_cast<size_t>(padded_lanes(N, R)) * R * sizeof(int) : 0);
  return l;
}

template <int K, bool kFreeSmem, bool kMaskSmem>
__global__ void __launch_bounds__(kMaxThreads, 1)
pack_batched_kernel(const int* __restrict__ free_in, const int* __restrict__ mask_bits,
                    const int* __restrict__ req, const int* __restrict__ count,
                    const int* __restrict__ order, const int* __restrict__ limit_one,
                    int* __restrict__ placed, int* __restrict__ free_after,
                    int* __restrict__ scheduled, int G, int N, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L = layout(G, N, R, kMaskSmem, kFreeSmem);
  unsigned* warp_tot = reinterpret_cast<unsigned*>(smem_raw);  // [2][32]
  int* req_s = reinterpret_cast<int*>(smem_raw + L.req);          // [G*R]
  unsigned* mul_s = reinterpret_cast<unsigned*>(smem_raw + L.mul);  // [G*R]
  int* shift_s = reinterpret_cast<int*>(smem_raw + L.shift);      // [G*R]
  int* cnt_s = reinterpret_cast<int*>(smem_raw + L.cnt);          // [G]
  int* ord_s = reinterpret_cast<int*>(smem_raw + L.ord);          // [G]
  int* lim_s = reinterpret_cast<int*>(smem_raw + L.lim);          // [G]
  unsigned* any_s = reinterpret_cast<unsigned*>(smem_raw + L.any);  // [nwords]
  int* mask_s = reinterpret_cast<int*>(smem_raw + L.mask);        // [nwords][N] if staged
  int* free_s = reinterpret_cast<int*>(smem_raw + L.free);        // [R][np] if staged

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int nwords = (G + 31) >> 5;
  const int np = padded_lanes(N, R);
  const int chunk = nthreads * K;                // lanes of one chunk
  const int first = warp * 32 * K + lane;        // this thread's lane in a chunk, step 0
  const int* fin = free_in + static_cast<size_t>(b) * N * R;
  int* fout = free_after + static_cast<size_t>(b) * N * R;
  const int* mrow = mask_bits + static_cast<size_t>(b) * nwords * N;
  int* prow = placed + static_cast<size_t>(b) * G * N;
  int* srow = scheduled + static_cast<size_t>(b) * G;

  for (int i = tid; i < G * R; i += nthreads) {
    const int d = req[i];
    req_s[i] = d;
    unsigned m;
    int s;
    divisor(d, m, s);
    mul_s[i] = m;
    shift_s[i] = s;
  }
  for (int i = tid; i < G; i += nthreads) {
    cnt_s[i] = count[i];
    ord_s[i] = order[i];
    lim_s[i] = limit_one[i];
  }
  for (int i = tid; i < nwords; i += nthreads) any_s[i] = 0;

  // element (r) of the working free capacity of lane n
  auto fcap = [&](int n, int r) -> int& {
    return kFreeSmem ? free_s[r * np + n] : fout[n * R + r];
  };
  // element i = n*R + r of the row's [N, R] plane, stepped by nthreads
  // without a division per element: (n, r) advance by (nthreads / R,
  // nthreads % R)
  const int qn = R > 0 ? nthreads / R : 0;
  const int qr = R > 0 ? nthreads % R : 0;
  const int nr = N * R;
  if (kFreeSmem) {
    int n = R > 0 ? tid / R : 0, r = R > 0 ? tid % R : 0;
    for (int i0 = tid; i0 < nr; i0 += 8 * nthreads) {  // 8 loads in flight
      int v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = i0 + j * nthreads;
        v[j] = i < nr ? fin[i] : 0;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (i0 + j * nthreads < nr) free_s[r * np + n] = v[j];
        n += qn;
        r += qr;
        if (r >= R) {
          r -= R;
          ++n;
        }
      }
    }
  } else {
    for (int i = tid; i < nr; i += nthreads) fout[i] = fin[i];
  }
  __syncthreads();  // any_s is zero

  // stage the mask words of this thread's lanes (coalesced) and OR them into
  // one "some lane is feasible" word per 32 groups
  for (int c = 0; c < nwords; ++c) {
    const int* src = mrow + static_cast<size_t>(c) * N;
    unsigned acc = 0;
    for (int l0 = 0; l0 < N; l0 += chunk) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int n = l0 + first + 32 * k;
        if (n < N) {
          const int v = src[n];
          if (kMaskSmem) mask_s[c * N + n] = v;
          acc |= static_cast<unsigned>(v);
        }
      }
    }
    acc = __reduce_or_sync(kFullMask, acc);
    if (lane == 0 && acc) atomicOr(&any_s[c], acc);
  }
  __syncthreads();

  unsigned phase = 0;  // which half of warp_tot the next scan uses
  for (int it = 0; it < G; ++it) {
    const int g = ord_s[it];
    const int cnt = cnt_s[g];
    const int* rq = req_s + g * R;
    int* grow = prow + static_cast<size_t>(g) * N;
    const bool feasible_somewhere = (any_s[g >> 5] >> (g & 31)) & 1u;

    if (cnt == 0 || (cnt > 0 && !feasible_somewhere)) {  // dead: places nothing
      for (int l0 = 0; l0 < N; l0 += chunk) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int n = l0 + first + 32 * k;
          if (n < N) grow[n] = 0;
        }
      }
      if (tid == 0) srow[g] = 0;
      continue;
    }

    if (cnt < 0) {  // every lane places the count
      for (int l0 = 0; l0 < N; l0 += chunk) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int n = l0 + first + 32 * k;
          if (n < N) {
            grow[n] = cnt;
            for (int r = 0; r < R; ++r) fcap(n, r) -= mul_wrap(cnt, rq[r]);
          }
        }
      }
      if (tid == 0) srow[g] = mul_wrap(cnt, N);
      continue;
    }

    // live: a positive count and a feasible lane somewhere in the row
    const unsigned cap = static_cast<unsigned>(cnt);
    const int lim = lim_s[g];
    const int* mword = mrow + static_cast<size_t>(g >> 5) * N;
    const int* sword = mask_s + (g >> 5) * N;
    const int bit = g & 31;
    const unsigned* mul = mul_s + g * R;
    const int* shift = shift_s + g * R;
    unsigned carry = 0;  // block-uniform: placed by earlier chunks, saturated at cap
    for (int l0 = 0; l0 < N; l0 += chunk) {
      const int base = l0 + first;                 // this thread's lane of step 0

      // pass 1: this thread's K fits
      unsigned x[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int n = base + 32 * k;
        const unsigned w = n >= N ? 0u : static_cast<unsigned>(kMaskSmem ? sword[n] : mword[n]);
        x[k] = ((w >> bit) & 1u) ? kBig : 0u;
      }
      for (int r = 0; r < R; ++r) {
        const int s = shift[r];
        if (s == kNoLimit) continue;  // block-uniform
        const unsigned mu = mul[r];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int n = base + 32 * k;
          const unsigned f = n < N ? static_cast<unsigned>(max(fcap(n, r), 0)) : 0u;
          const unsigned q = s == kIdentity ? f : (__umulhi(f, mu) >> s);
          x[k] = min(x[k], q);
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (lim) x[k] = min(x[k], 1u);
        x[k] = min(x[k], cap);
      }

      // the warp's K steps, scanned at once, saturating at cap
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const unsigned y = __shfl_up_sync(kFullMask, x[k], off);
          if (lane >= off) x[k] = min(x[k] + y, cap);
        }
      }
      unsigned incl[K], excl[K];
      unsigned run = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const unsigned tot = __shfl_sync(kFullMask, x[k], 31);
        const unsigned before = __shfl_up_sync(kFullMask, x[k], 1);
        excl[k] = min(run + (lane ? before : 0u), cap);
        incl[k] = min(run + x[k], cap);
        run = min(run + tot, cap);
      }

      // the chunk's exclusive offset of this warp: the warp's total goes to
      // its slot, one barrier, then each warp scans the slots itself. The
      // two halves of warp_tot alternate, so a warp that runs ahead to the
      // next scan writes the half no warp still reads.
      unsigned* wt = warp_tot + phase * 32;
      phase ^= 1u;
      if (lane == 0) wt[warp] = run;
      __syncthreads();
      unsigned v = lane < nwarps ? wt[lane] : 0u;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(kFullMask, v, off);
        if (lane >= off) v = min(v + y, cap);
      }
      const unsigned before_lane = __shfl_up_sync(kFullMask, v, 1);
      unsigned off = __shfl_sync(kFullMask, lane ? before_lane : 0u, warp);
      const unsigned total = __shfl_sync(kFullMask, v, 31);
      off = min(carry + off, cap);

      // pass 2: place, store every lane's place, update the free plane
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int n = base + 32 * k;
        if (n < N) {
          const int place = static_cast<int>(min(off + incl[k], cap) - min(off + excl[k], cap));
          grow[n] = place;
          if (place != 0)
            for (int r = 0; r < R; ++r) fcap(n, r) -= mul_wrap(place, rq[r]);
        }
      }
      carry = min(carry + total, cap);
    }
    if (tid == 0) srow[g] = static_cast<int>(carry);
  }

  if (kFreeSmem) {
    __syncthreads();  // every thread's last updates are in
    int n = R > 0 ? tid / R : 0, r = R > 0 ? tid % R : 0;
    for (int i = tid; i < nr; i += nthreads) {
      fout[i] = free_s[r * np + n];
      n += qn;
      r += qr;
      if (r >= R) {
        r -= R;
        ++n;
      }
    }
  }
}

template <int K>
void* kernel_of(int free_in_smem, int mask_in_smem) {
  if (free_in_smem)
    return mask_in_smem ? reinterpret_cast<void*>(pack_batched_kernel<K, true, true>)
                        : reinterpret_cast<void*>(pack_batched_kernel<K, true, false>);
  return mask_in_smem ? reinterpret_cast<void*>(pack_batched_kernel<K, false, true>)
                      : reinterpret_cast<void*>(pack_batched_kernel<K, false, false>);
}

using KernelOf = void* (*)(int, int);
constexpr KernelOf kKernelOf[kMaxLanes - kMinLanes + 1] = {
    kernel_of<2>, kernel_of<3>, kernel_of<4>, kernel_of<5>, kernel_of<6>, kernel_of<7>, kernel_of<8>};

}  // namespace

// Per device, read or set once and reused by every later launch: the opt-in
// shared-memory limit (0 until read) and, per instantiation, the dynamic
// shared-memory size the kernel's attribute allows so far (raised only when
// a launch needs more).
constexpr int kMaxDevices = 64;
static std::mutex g_smem_mu;
static int g_max_smem[kMaxDevices];
static size_t g_smem_allowed[kMaxDevices][kMaxLanes + 1][4];

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

  // K lanes per thread and as few threads as cover the row with K lanes
  // each; a chunk is threads * K lanes
  int K, threads;
  row_shape(N, K, threads);

  size_t smem;
  void* kernel = nullptr;
  {
    std::lock_guard<std::mutex> lock(g_smem_mu);
    if (g_max_smem[dev] == 0) {
      err = cudaDeviceGetAttribute(&g_max_smem[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const size_t max_smem = static_cast<size_t>(g_max_smem[dev]);
    // the free plane first (R reads per lane and live group), then the mask
    const int free_in_smem = layout(G, N, R, 0, 1).end <= max_smem;
    const int mask_in_smem = layout(G, N, R, 1, free_in_smem).end <= max_smem;
    smem = layout(G, N, R, mask_in_smem, free_in_smem).end;
    if (smem > max_smem) return static_cast<int>(cudaErrorInvalidValue);
    kernel = kKernelOf[K - kMinLanes](free_in_smem, mask_in_smem);
    size_t& allowed = g_smem_allowed[dev][K][2 * free_in_smem + mask_in_smem];
    if (smem > allowed) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed = smem;
    }
  }

  void* args[] = {&free_in, &mask_bits, &req, &count, &order, &limit_one, &placed,
                  &free_after, &scheduled, &G, &N, &R};
  err = cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(B)), dim3(threads), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
