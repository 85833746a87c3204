// K2: segmented wavefront first-fit pack, hand-written for Hopper (sm_90a).
//
// Replaces kubernetes_autoscaler_tpu/ops/pallas/pack_kernel.py:_wavefront_kernel,
// the body of pack_groups_wavefront_pallas's pallas_call (via _wavefront_call).
// Same function: for each wave w of `waves` [W,S] (-1 = empty slot) and each
// slot with g = waves[w,s] >= 0, per node lane n, against the free capacity
// at the START of the wave
//     fit   = min over r with req[g,r] > 0 of max(free[n,r], 0) / req[g,r]
//     fit   = mask bit (word g>>5, bit g&31) ? fit : 0
//     fit   = limit_one[g] ? min(fit, 1) : fit
//     fit   = min(fit, count[g])            // before the scan: a zero-request
//                                            // group has fit 2^30 per lane
//     place = clip(count[g] - (inclusive_prefix(fit)[n] - fit), 0, fit)
//     delta[n,:] += place * req[g,:];  placed[g,:] = place
// and at the end of the wave free -= delta. A group occupies at most one slot
// of the plan, so its remaining count at its slot is its count. Rows of
// groups in no slot are zero; scheduled[g] = sum(placed[g,:]).
//
// What bounds it. The bytes are small (the placed writes, G*N int32, plus
// the free capacity in and out: about 1.7 MB at G=64, N=5120, R=8, a
// fraction of a microsecond of device memory time). The bound is serial
// depth, as for K1, but the plan cuts it: waves must go one after another,
// yet the slots of a wave are independent (each reads the wave-start
// capacity, and their updates are summed), so the depth is W waves instead
// of G groups.
//
// The design. One CTA of 32 warps. For each wave, warp 0 lists the live
// slots (a group with a count != 0; the others only zero their rows), and
// the warps are split into one team per live slot (32 / live warps each;
// more live slots than warps go in rounds). A team first stages its slot:
// its warps read the group's mask words 32 lanes at a time (coalesced) and
// keep one bit per lane in shared memory (one __ballot_sync per 32 lanes),
// and zero the group's `placed` row (coalesced). Then it runs K1's scan:
// each thread owns a contiguous run of node lanes, sums the fits of its
// feasible lanes (read from the staged bits, so a thread walks only the
// set bits; a negative count, whose fit is the count on every lane, walks
// them all), the team takes an exclusive scan of those sums (warp
// __shfl_up_sync in int64, then the team's warp totals in shared memory),
// and each thread walks its feasible lanes again from its offset, placing,
// until the running total reaches the count. Only non-zero places are
// stored. This keeps every wide access coalesced: a thread-owned run of
// lanes makes each warp-wide load or store touch 32 sectors, which one SM's
// load/store unit serialises, and that (not the arithmetic) was what a long
// run of lanes cost.
//
// The wave-start capacity. A fit reads the free capacity only on the
// slot's feasible lanes. So when the staged bits of a wave's slots are
// pairwise disjoint (checked per wave; always so for a plan built from a
// superset of the mask) every lane has at most one reader and one writer,
// and the placing thread subtracts place*req from the free plane at once.
// Otherwise (overlapping slots, a negative count, or more live slots than
// warps) the
// updates go into a delta plane [R][N] in device memory by integer
// atomicAdd, which is order-free, each placed lane is flagged, and after
// the wave's rounds the flagged lanes subtract and clear their delta,
// between two __syncthreads(). The free capacity lives in shared memory as
// [R][Np] (Np = N padded so a warp's transposing copy hits distinct banks)
// when it fits the opt-in limit with the metadata, else in the free_after
// buffer in device memory.
//
// Contract (checked by the Python wrapper): int32 tensors, contiguous,
// free [N,R], mask_bits [ceil(G/32),N], req [G,R], count/limit_one [G],
// waves [W,S] with every id in [-1,G) and no group in two slots; outputs
// placed [G,N], free_after [N,R], scheduled [G]; delta [R,N] is scratch
// (zeroed here). The staged bits and lane flags take 5 bytes of shared memory
// per lane, which bounds N at about 45,000; a launch beyond what shared memory
// holds is refused (cudaErrorInvalidValue). Launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ long long warp_inclusive_scan(long long x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    long long y = __shfl_up_sync(kFullMask, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// fit of node lane n for one group, after mask, one-per-node cap and count
// clamp; an infeasible lane reads nothing
__device__ __forceinline__ int lane_fit(const int* fcap, int sn, int sr, int n,
                                        const int* rq, int R, bool feasible,
                                        int lim, int cnt) {
  int fit = 0;
  if (feasible) {
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

// row stride of the [R][N] free plane in shared memory: N rounded up to
// 32/R (mod 32) when R divides 32, so that the R values of the lanes a warp
// copies in turn fall in distinct banks
__host__ __device__ inline int padded_lanes(int N, int R) {
  const int want = (R > 0 && 32 % R == 0) ? (32 / R) % 32 : 0;
  return N + ((want - N % 32) % 32 + 32) % 32;
}

// the bits of word c (lanes 32c .. 32c+31) that lie in [n0, n1)
__device__ __forceinline__ unsigned range_bits(int c, int n0, int n1) {
  const int lo = max(n0 - 32 * c, 0);
  const int hi = min(n1 - 32 * c, 32);
  if (hi <= lo) return 0u;
  const unsigned upto = hi == 32 ? kFullMask : ((1u << hi) - 1u);
  return upto & ~((1u << lo) - 1u);
}

// one block per SM: the kernel runs as a single CTA, so ptxas may give each
// thread the whole register file's share (64) instead of spilling
__global__ void __launch_bounds__(kThreads, 1)
wavefront_kernel(const int* __restrict__ free_in, const int* __restrict__ mask_bits,
                 const int* __restrict__ req, const int* __restrict__ count,
                 const int* __restrict__ limit_one, const int* __restrict__ waves,
                 int* __restrict__ placed, int* __restrict__ free_after,
                 int* __restrict__ scheduled, int* __restrict__ delta, int G, int N,
                 int R, int W, int S, int free_in_smem) {
  const int nwords = (N + 31) >> 5;
  const int np = padded_lanes(N, R);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* warp_tot = reinterpret_cast<long long*>(smem_raw);  // [32]
  int* req_s = reinterpret_cast<int*>(warp_tot + kWarps);       // [G*R]
  int* cnt_s = req_s + G * R;                                    // [G]
  int* lim_s = cnt_s + G;                                        // [G]
  int* sched_s = lim_s + G;                                      // [G]
  int* inplan_s = sched_s + G;                                   // [G]
  int* nlive_s = inplan_s + G;                                   // [2]
  int* ovl_s = nlive_s + 2;                                      // [1]
  int* live_s = ovl_s + 1;                                       // [2][S]
  unsigned* bits_s = reinterpret_cast<unsigned*>(live_s + 2 * S);  // [32][nwords]
  int* free_s = reinterpret_cast<int*>(bits_s + kWarps * nwords);  // [R][np] if in smem
  unsigned char* dirty_s = reinterpret_cast<unsigned char*>(     // [N] lane has a delta
      free_s + (free_in_smem ? np * R : 0));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nr = N * R;

  for (int i = tid; i < G * R; i += kThreads) req_s[i] = req[i];
  for (int i = tid; i < G; i += kThreads) {
    cnt_s[i] = count[i];
    lim_s[i] = limit_one[i];
    sched_s[i] = 0;
    inplan_s[i] = 0;
  }
  // element (n, r) of the working free capacity is fcap[n*sn + r*sr]
  int* fcap;
  int sn, sr;
  // element i = n*R + r of the [N,R] input, stepped by kThreads without a
  // division per element: (n, r) advance by (kThreads / R, kThreads % R)
  const int qn = R > 0 ? kThreads / R : 0;
  const int qr = R > 0 ? kThreads % R : 0;
  if (free_in_smem) {
    fcap = free_s;
    sn = 1;
    sr = np;
    int n = R > 0 ? tid / R : 0, r = R > 0 ? tid % R : 0;
    for (int i0 = tid; i0 < nr; i0 += 8 * kThreads) {  // 8 loads in flight
      int v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = i0 + j * kThreads;
        v[j] = i < nr ? free_in[i] : 0;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (i0 + j * kThreads < nr) free_s[r * np + n] = v[j];
        n += qn;
        r += qr;
        if (r >= R) {
          r -= R;
          ++n;
        }
      }
    }
  } else {
    fcap = free_after;
    sn = R;
    sr = 1;
    for (int i = tid; i < nr; i += kThreads) free_after[i] = free_in[i];
  }
  for (int i = tid; i < nr; i += kThreads) delta[i] = 0;
  for (int n = tid; n < N; n += kThreads) dirty_s[n] = 0;
  __syncthreads();
  for (int i = tid; i < W * S; i += kThreads) {
    const int g = waves[i];
    if (g >= 0) inplan_s[g] = 1;  // every writer writes 1
  }
  __syncthreads();
  // rows of groups in no slot are zero
  for (int g = warp; g < G; g += kWarps) {
    if (inplan_s[g]) continue;
    int* prow = placed + static_cast<size_t>(g) * N;
    for (int n = lane; n < N; n += 32) prow[n] = 0;
  }

  for (int w = 0; w < W; ++w) {
    const int* wrow = waves + static_cast<size_t>(w) * S;
    // the live-slot list alternates between two buffers from wave to wave,
    // so one wave's readers never race the next wave's writer (at least one
    // barrier lies between a buffer's reads and its next writes)
    int* live = live_s + (w & 1) * S;
    // dead slots (count 0) only zero their rows; warp 0 lists the live ones
    for (int s = warp; s < S; s += kWarps) {
      const int g = wrow[s];
      if (g >= 0 && cnt_s[g] == 0) {
        int* prow = placed + static_cast<size_t>(g) * N;
        for (int n = lane; n < N; n += 32) prow[n] = 0;
      }
    }
    if (warp == 0) {
      int nlive = 0;
      bool negative = false;
      for (int s0 = 0; s0 < S; s0 += 32) {
        const int s = s0 + lane;
        const int g = s < S ? wrow[s] : -1;
        const bool is_live = g >= 0 && cnt_s[g] != 0;
        const unsigned m = __ballot_sync(kFullMask, is_live);
        if (is_live) live[nlive + __popc(m & ((1u << lane) - 1u))] = g;
        nlive += __popc(m);
        negative |= __ballot_sync(kFullMask, is_live && cnt_s[g] < 0) != 0u;
      }
      if (lane == 0) {
        nlive_s[w & 1] = nlive;
        // rounds, or a negative count (which places on every lane, feasible
        // or not): take the delta path
        *ovl_s = nlive > kWarps || negative;
      }
    }
    __syncthreads();
    const int L = nlive_s[w & 1];
    if (L == 0) continue;  // block-uniform

    // one team of tw warps per live slot, `teams` slots per round
    const int tw = L >= kWarps ? 1 : kWarps / L;
    const int teams = kWarps / tw;
    const int team = warp / tw;
    const int first = team * tw;            // the team's first warp
    const int tt = tid - first * 32;        // thread index within the team
    const int k = (N + tw * 32 - 1) / (tw * 32);  // lanes per thread
    const int n0 = min(tt * k, N);
    const int n1 = min(n0 + k, N);
    unsigned* tbits = bits_s + team * nwords;
    bool direct = false;

    for (int base = 0; base < L; base += teams) {
      const int li = base + team;
      const bool active = team < teams && li < L;  // warp-uniform
      const int g = active ? live[li] : 0;
      const int cnt = cnt_s[g];
      const int lim = lim_s[g];
      const int* rq = req_s + g * R;
      int* prow = placed + static_cast<size_t>(g) * N;

      // stage: the slot's mask bits into shared memory, its row zeroed
      if (active) {
        const int* mword = mask_bits + static_cast<size_t>(g >> 5) * N;
        const int bit = g & 31;
        for (int c = warp - first; c < nwords; c += tw) {
          const int n = c * 32 + lane;
          const bool f = n < N && ((static_cast<unsigned>(mword[n]) >> bit) & 1u);
          const unsigned m = __ballot_sync(kFullMask, f);
          if (lane == 0) tbits[c] = m;
          if (n < N) prow[n] = 0;
        }
      }
      __syncthreads();
      if (L <= teams) {  // one round: are the wave's slots disjoint?
        for (int c = tid; c < nwords; c += kThreads) {
          unsigned seen = 0, twice = 0;
          for (int t = 0; t < L; ++t) {
            const unsigned b = bits_s[t * nwords + c];
            twice |= seen & b;
            seen |= b;
          }
          if (twice) *ovl_s = 1;  // every writer writes 1
        }
        __syncthreads();
        direct = !*ovl_s;
      }

      // pass 1: this thread's share of the slot's fits. With a count >= 0
      // an infeasible lane's fit is 0, so only the set bits are walked.
      long long local = 0;
      if (active && n0 < n1)
        for (int c = n0 >> 5; c <= (n1 - 1) >> 5; ++c) {
          const unsigned word = tbits[c];
          unsigned b = range_bits(c, n0, n1);
          if (cnt >= 0) b &= word;
          while (b) {
            const int i = __ffs(b) - 1;
            b &= b - 1;
            local += lane_fit(fcap, sn, sr, 32 * c + i, rq, R, (word >> i) & 1u, lim, cnt);
          }
        }

      // team-wide exclusive scan of the per-thread sums
      const long long incl = warp_inclusive_scan(local, lane);
      if (lane == 31) warp_tot[warp] = incl;
      __syncthreads();
      if (active && warp == first) {
        long long x = lane < tw ? warp_tot[first + lane] : 0;
        x = warp_inclusive_scan(x, lane);
        if (lane < tw) warp_tot[first + lane] = x;
      }
      __syncthreads();

      // pass 2: place along the thread's lanes in node order, until the
      // running total reaches the count (the row is already zero)
      if (active && n0 < n1) {
        long long run = (warp > first ? warp_tot[warp - 1] : 0) + incl - local;
        int psum = 0;
        for (int c = n0 >> 5; c <= (n1 - 1) >> 5 && !(cnt > 0 && run >= cnt); ++c) {
          const unsigned word = tbits[c];
          unsigned b = range_bits(c, n0, n1);
          if (cnt >= 0) b &= word;
          while (b && !(cnt > 0 && run >= cnt)) {
            const int i = __ffs(b) - 1;
            b &= b - 1;
            const int n = 32 * c + i;
            const int f = lane_fit(fcap, sn, sr, n, rq, R, (word >> i) & 1u, lim, cnt);
            run += f;
            long long x = static_cast<long long>(cnt) - (run - f);
            x = x < 0 ? 0 : x;
            const int place = static_cast<int>(x < f ? x : static_cast<long long>(f));
            if (place != 0) {
              prow[n] = place;
              if (direct) {  // this lane's only reader and writer in the wave
                for (int r = 0; r < R; ++r) fcap[n * sn + r * sr] -= place * rq[r];
              } else {
                for (int r = 0; r < R; ++r) {
                  const int d = place * rq[r];
                  if (d != 0) atomicAdd(&delta[r * N + n], d);
                }
                dirty_s[n] = 1;
              }
              psum += place;
            }
          }
        }
        if (psum != 0) atomicAdd(&sched_s[g], psum);
      }
      __syncthreads();  // warp_tot and the staged bits are reused next round
    }

    if (!direct) {
      for (int n = tid; n < N; n += kThreads) {  // free -= delta on the flagged lanes
        if (!dirty_s[n]) continue;
        dirty_s[n] = 0;
        for (int r = 0; r < R; ++r) {
          fcap[n * sn + r * sr] -= delta[r * N + n];
          delta[r * N + n] = 0;
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < G; i += kThreads) scheduled[i] = sched_s[i];
  if (free_in_smem) {
    int n = R > 0 ? tid / R : 0, r = R > 0 ? tid % R : 0;
    for (int i = tid; i < nr; i += kThreads) {
      free_after[i] = free_s[r * np + n];
      n += qn;
      r += qr;
      if (r >= R) {
        r -= R;
        ++n;
      }
    }
  }
}

}  // namespace

// Per device, read or set once and reused by every later launch: the opt-in
// shared-memory limit (0 until read) and the dynamic shared-memory size the
// kernel's attribute allows so far (raised only when a launch needs more).
constexpr int kMaxDevices = 64;
static std::mutex g_smem_mu;
static int g_max_smem[kMaxDevices];
static size_t g_smem_allowed[kMaxDevices];

extern "C" int ka_pack_groups_wavefront(const void* free_in, const void* mask_bits,
                                        const void* req, const void* count,
                                        const void* limit_one, const void* waves,
                                        void* placed, void* free_after, void* scheduled,
                                        void* delta, int G, int N, int R, int W, int S,
                                        void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);

  const size_t nwords = (static_cast<size_t>(N) + 31) / 32;
  const size_t meta = sizeof(long long) * kWarps +
                      sizeof(int) * (static_cast<size_t>(G) * R + 4 * static_cast<size_t>(G) +
                                     3 + 2 * static_cast<size_t>(S) + kWarps * nwords) +
                      static_cast<size_t>(N);  // the dirty-lane flags
  const size_t free_bytes = sizeof(int) * static_cast<size_t>(padded_lanes(N, R)) * R;
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
      err = cudaFuncSetAttribute(wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      g_smem_allowed[dev] = smem;
    }
  }

  wavefront_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(free_in), static_cast<const int*>(mask_bits),
      static_cast<const int*>(req), static_cast<const int*>(count),
      static_cast<const int*>(limit_one), static_cast<const int*>(waves),
      static_cast<int*>(placed), static_cast<int*>(free_after),
      static_cast<int*>(scheduled), static_cast<int*>(delta), G, N, R, W, S,
      free_in_smem);
  return static_cast<int>(cudaGetLastError());
}
