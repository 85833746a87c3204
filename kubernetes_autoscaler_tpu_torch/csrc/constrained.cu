// The constrained wave placer, hand-written for Hopper (sm_90a): B lanes,
// one CTA a lane, every wave of a lane on the device with no host read.
//
// Replaces XLA code with no pallas_call: the `lax.while_loop` of placement
// waves in kubernetes_autoscaler_tpu/ops/constrained.py:164-236
// (`place_group_constrained`, under vmap over options and drain lanes) and
// the `lax.scan` over groups at :239-290 (`pack_groups_constrained`, its
// `lax.cond(is_con[g], slow, fast)`). Two modes of one kernel:
//   kPlace: each lane places ONE group (its own req, want, limit_one and
//           constraints) by waves; a lane whose `active` byte is 0 writes
//           nothing, so the caller's output buffers keep what they hold.
//   kPack:  each lane walks the G groups in `order` (read on the device):
//           a constrained group by waves, any other by the one-shot first
//           fit of ops/pack (the reference's `fast`).
// A wave of a lane, in the reference's order, per node n of the lane:
//   fit  = min(fit_count(free[n], req), rem); 0 where infeasible; with
//          limit_one min(1 - (placed[n] > 0), fit)
//   positive affinity: the bootstrap seed (the first node that can take a
//          pod, gated by "some node can"), or resident-satisfied or opened
//          by the group's own placements (host, or zone via zone_placed[Z])
//   hostname spread: min(fit, max(min_h + skew - cnt[n], 0)), min_h a
//          block min over the eligible nodes and the base outside the set
//   zone caps: spread allowance and anti-self 1-per-zone per zone, less
//          what earlier nodes of the same zone take (an exclusive prefix in
//          node order within the zone); keyless nodes uncapped
//   the global first fit: place = clip(rem - exclusive_prefix, 0, fit_z)
//   then free -= place * req, placed += place, rem -= sum(place); the lane
//   stops when rem <= 0, a wave places nothing, or after max_waves waves.
// All arithmetic is int32 with the plain version's wrap-around (sums and
// products in unsigned), so the result is byte-equal to
// ops/kernels/constrained_kernel.py's plain version, not close to it.
//
// What bounds it. Not bytes: a lane reads its free plane once (160 KB at
// N = 5,120, R = 8) and its constraint rows once a wave from L1/L2. The
// bound is the dependent chain of waves (up to 128 a group, groups one
// after another in kPack), each wave a few block-wide steps over the lane's
// nodes with a barrier between them; a batch of one lane (the filter pack)
// leaves the other SMs idle.
//
// The design. One CTA of up to 1,024 threads runs one lane to its end
// (the grid is at most what the card holds at once, each CTA walking
// lanes b, b + grid, ...; an inactive drain lane costs one flag read);
// thread t owns the contiguous nodes [tK, tK + K), K = ceil(N / threads),
// so a node's free capacity and placed count are touched by one thread
// only and need no barrier. The lane's free plane ([R][N]), placed row and
// a fit row live in shared memory when they fit the opt-in limit (N up to
// about 5,700 at R = 8, cudaFuncSetAttribute above 48 KB); else the plane
// stays in the free_out buffer, the placed row in the output and the fit
// row in a scratch buffer in device memory, as csrc/wavefront.cu keeps
// free_after, with the same code. The zone prefix walks a zone-sorted
// permutation of the nodes (computed once a call by the wrapper, as
// ops/constrained._zone_segments does) with one segmented block scan, and
// is skipped where it can change nothing: no zone constraint and N * rem
// below the BIG cap, so no prefix reaches the cap. A wave costs 3 barriers
// (5 with zone caps): the min reductions, the global scan, the placed sum,
// and the segmented scan with its hand-over. No division: pack_row.cuh's
// multiply-high codes, computed once a group.
//
// Contract (checked by the Python wrapper): int32 and uint8 (bool)
// tensors; every lane input is [L, ...] with L = 1 or B and its lane
// stride in `ls` (0 for a row shared by every lane), its trailing dims
// contiguous; outputs free_out [B,N,R], placed [B,G,N] (G = 1 in kPlace),
// scratch [B,N] when the plane is in device memory, waves a u64 counter
// that each lane adds its wave count to. Launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>

#include <mutex>

#include "pack_row.cuh"

namespace {

using namespace ka;

enum Field {
  kFreeIn, kFreeOut, kPlaced, kFeas, kReq, kWant, kLimit, kActive, kOrder,
  kSKind, kSSkew, kSSelf, kSCnt, kSElig, kAKind, kASelf, kAAny, kAOk, kAnti,
  kCzb, kEzb, kMhb, kZcl, kZval, kPerm, kSkey, kScratch, kWaves, kNumFields
};

enum Mode { kPlace = 0, kPack = 1 };

constexpr int kConBig = 1 << 28;  // ops/constrained.BIG

struct Params {
  const void* ptr[kNumFields];
  long long ls[kNumFields];  // lane stride in elements; 0 = shared row
};

// byte offsets of the shared-memory arrays
struct Layout {
  size_t scan, sum, mins, segf, segs, zp, zc, czb, ezb, req, mul, sh, plane, placed, fit, end;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

__host__ __device__ inline Layout layout(int N, int R, int Z, bool smem_plane) {
  Layout l;
  l.scan = 0;                                  // u32 [2][32]
  l.sum = l.scan + 2 * 32 * 4;                 // u32 [2][32]
  l.mins = l.sum + 2 * 32 * 4;                 // i32 [2][2][32]
  l.segf = l.mins + 2 * 2 * 32 * 4;            // u32 [2][32]
  l.segs = l.segf + 2 * 32 * 4;                // u32 [2][32]
  l.zp = l.segs + 2 * 32 * 4;                  // i32 [Z] zone_placed
  l.zc = l.zp + static_cast<size_t>(Z) * 4;    // i32 [Z] zone_cap
  l.czb = l.zc + static_cast<size_t>(Z) * 4;   // i32 [Z] cnt_zone_base
  l.ezb = l.czb + static_cast<size_t>(Z) * 4;  // i32 [Z] elig_zone_base
  l.req = l.ezb + static_cast<size_t>(Z) * 4;  // i32 [2][R]
  l.mul = l.req + 2 * static_cast<size_t>(R) * 4;  // u32 [2][R]
  l.sh = l.mul + 2 * static_cast<size_t>(R) * 4;   // i32 [2][R]
  l.plane = align16(l.sh + 2 * static_cast<size_t>(R) * 4);
  const size_t n4 = static_cast<size_t>(N) * 4;
  l.placed = l.plane + (smem_plane ? n4 * R : 0);
  l.fit = l.placed + (smem_plane ? n4 : 0);
  l.end = l.fit + (smem_plane ? n4 : 0);
  return l;
}

// as many threads as cover N (a multiple of 32, at most 1,024)
inline int con_threads(int N) {
  int t = ((N + 31) / 32) * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

// a + b and a - b in int32 with the wrap-around of the plain version's
// int32 tensors
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ unsigned warp_incl(unsigned x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(kFullMask, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// Block-wide helpers. Each has its own double-buffered slots and phase: a
// warp that runs ahead to the helper's next call writes the other half,
// and the call after that comes only after a barrier every warp passed
// once it had read this call's values.
struct Block {
  unsigned* scan;  // [2][32]
  unsigned* sum;   // [2][32]
  int* mins;       // [2][2][32]
  unsigned* segf;  // [2][32]
  unsigned* segs;  // [2][32]
  unsigned p_scan = 0, p_sum = 0, p_min = 0, p_seg = 0;
  int lane, warp, nwarps;

  // exclusive prefix of x over the threads (wrap-around); `total` the sum
  __device__ unsigned excl(unsigned x, unsigned& total) {
    const unsigned inc = warp_incl(x, lane);
    unsigned* s = scan + (p_scan++ & 1u) * 32;
    if (lane == 31) s[warp] = inc;
    __syncthreads();
    const unsigned v = lane < nwarps ? s[lane] : 0u;
    const unsigned vinc = warp_incl(v, lane);
    const unsigned before = __shfl_sync(kFullMask, vinc - v, warp);
    total = __shfl_sync(kFullMask, vinc, 31);
    return before + inc - x;
  }

  // the sum of x over the threads (wrap-around), on every thread
  __device__ unsigned total(unsigned x) {
    x = __reduce_add_sync(kFullMask, x);
    unsigned* s = sum + (p_sum++ & 1u) * 32;
    if (lane == 0) s[warp] = x;
    __syncthreads();
    return __reduce_add_sync(kFullMask, lane < nwarps ? s[lane] : 0u);
  }

  // the minima of a and b over the threads, on every thread
  __device__ void min2(int& a, int& b) {
    a = __reduce_min_sync(kFullMask, a);
    b = __reduce_min_sync(kFullMask, b);
    int* s = mins + (p_min++ & 1u) * 64;
    if (lane == 0) {
      s[warp] = a;
      s[32 + warp] = b;
    }
    __syncthreads();
    a = __reduce_min_sync(kFullMask, lane < nwarps ? s[lane] : INT_MAX);
    b = __reduce_min_sync(kFullMask, lane < nwarps ? s[32 + lane] : INT_MAX);
  }

  // segmented scan: each thread's (f, s) is "a segment starts in my range"
  // and the sum since my last start (or of my whole range). Returns the sum
  // of the values of earlier threads since the last start before mine.
  __device__ unsigned seg_carry(unsigned f, unsigned s) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned yf = __shfl_up_sync(kFullMask, f, off);
      const unsigned ys = __shfl_up_sync(kFullMask, s, off);
      if (lane >= off) {
        s = f ? s : ys + s;
        f |= yf;
      }
    }
    // this thread's exclusive pair within the warp
    unsigned ef = __shfl_up_sync(kFullMask, f, 1);
    unsigned es = __shfl_up_sync(kFullMask, s, 1);
    if (lane == 0) ef = es = 0u;
    const unsigned ph = p_seg++ & 1u;
    unsigned* sf = segf + ph * 32;
    unsigned* ss = segs + ph * 32;
    if (lane == 31) {
      sf[warp] = f;
      ss[warp] = s;
    }
    __syncthreads();
    unsigned wf = lane < nwarps ? sf[lane] : 0u;
    unsigned ws = lane < nwarps ? ss[lane] : 0u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned yf = __shfl_up_sync(kFullMask, wf, off);
      const unsigned ys = __shfl_up_sync(kFullMask, ws, off);
      if (lane >= off) {
        ws = wf ? ws : ys + ws;
        wf |= yf;
      }
    }
    // the carry of the warps before this one
    unsigned cs = __shfl_sync(kFullMask, ws, (warp + 31) & 31);
    if (warp == 0) cs = 0u;
    return ef ? es : cs + es;
  }
};

template <typename T>
__device__ __forceinline__ const T* at(const Params& p, Field f, int b, long long off = 0) {
  return static_cast<const T*>(p.ptr[f]) + p.ls[f] * b + off;
}

template <bool kSmem>
__global__ void __launch_bounds__(kMaxThreads, 1)
constrained_kernel(Params p, int mode, int B, int G, int N, int R, int Z, int max_waves) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned char* active = static_cast<const unsigned char*>(p.ptr[kActive]);
  const Layout L = layout(N, R, Z, kSmem);
  Block blk;
  blk.scan = reinterpret_cast<unsigned*>(smem_raw + L.scan);
  blk.sum = reinterpret_cast<unsigned*>(smem_raw + L.sum);
  blk.mins = reinterpret_cast<int*>(smem_raw + L.mins);
  blk.segf = reinterpret_cast<unsigned*>(smem_raw + L.segf);
  blk.segs = reinterpret_cast<unsigned*>(smem_raw + L.segs);
  int* zone_placed = reinterpret_cast<int*>(smem_raw + L.zp);
  int* zone_cap = reinterpret_cast<int*>(smem_raw + L.zc);
  int* czb_s = reinterpret_cast<int*>(smem_raw + L.czb);
  int* ezb_s = reinterpret_cast<int*>(smem_raw + L.ezb);
  int* req_s = reinterpret_cast<int*>(smem_raw + L.req);
  unsigned* mul_s = reinterpret_cast<unsigned*>(smem_raw + L.mul);
  int* sh_s = reinterpret_cast<int*>(smem_raw + L.sh);

  const int tid = threadIdx.x;
  const int T = blockDim.x;
  blk.lane = tid & 31;
  blk.warp = tid >> 5;
  blk.nwarps = T >> 5;
  const int K = (N + T - 1) / T;
  const int n0 = min(tid * K, N);
  const int n1 = min(n0 + K, N);

  // the CTAs walk the lanes; an inactive lane costs a flag read
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    if (mode == kPlace && active != nullptr && !active[b]) continue;  // block-uniform

    const size_t NR = static_cast<size_t>(N) * R;
    int* fout = static_cast<int*>(const_cast<void*>(p.ptr[kFreeOut])) + b * NR;
    int* plane = kSmem ? reinterpret_cast<int*>(smem_raw + L.plane) : fout;
    int* scratch = static_cast<int*>(const_cast<void*>(p.ptr[kScratch]));
    int* fit =
        kSmem ? reinterpret_cast<int*>(smem_raw + L.fit) : scratch + static_cast<size_t>(b) * N;
    int* placed_out = static_cast<int*>(const_cast<void*>(p.ptr[kPlaced]));
    // free capacity of node n, resource r: [R][N] in shared memory, [N][R] in
    // device memory (the free_out buffer)
    auto F = [&](int n, int r) -> int& {
      return kSmem ? plane[static_cast<size_t>(r) * N + n] : plane[static_cast<size_t>(n) * R + r];
    };

    {
      const int* fin = at<int>(p, kFreeIn, b);
      for (int n = n0; n < n1; ++n)
        for (int r = 0; r < R; ++r) F(n, r) = fin[static_cast<size_t>(n) * R + r];
    }
    const int* zcl = at<int>(p, kZcl, b);
    const unsigned char* zval = at<unsigned char>(p, kZval, b);
    const int* perm = at<int>(p, kPerm, b);
    const int* skey = at<int>(p, kSkey, b);
    const int* order = static_cast<const int*>(p.ptr[kOrder]);
    unsigned long long* wave_counter =
        static_cast<unsigned long long*>(const_cast<void*>(p.ptr[kWaves]));
    auto zone_of = [&](int n) { return min(max(zcl[n], 0), Z - 1); };

    for (int it = 0; it < G; ++it) {
      const int g = order != nullptr ? order[it] : it;
      const long long gn = static_cast<long long>(g) * N;
      int* prow = placed_out + (static_cast<size_t>(b) * G + g) * N;
      const unsigned char* feas = at<unsigned char>(p, kFeas, b, gn);
      const int cnt = *at<int>(p, kWant, b, g);
      const bool lim = *at<unsigned char>(p, kLimit, b, g) != 0;
      const int s_kind = *at<int>(p, kSKind, b, g);
      const int a_kind = *at<int>(p, kAKind, b, g);
      const bool anti = *at<unsigned char>(p, kAnti, b, g) != 0;
      const bool con = mode == kPlace || s_kind > 0 || a_kind > 0 || anti;

      // this group's request and its division codes (double-buffered: the
      // barrier below separates a group's writes from the previous reads)
      int* rq = req_s + (it & 1) * R;
      unsigned* mu = mul_s + (it & 1) * R;
      int* sh = sh_s + (it & 1) * R;
      if (tid < R) {
        const int d = at<int>(p, kReq, b, static_cast<long long>(g) * R)[tid];
        unsigned m;
        int s;
        divisor(d, m, s);
        rq[tid] = d;
        mu[tid] = m;
        sh[tid] = s;
      }
      int* P = kSmem ? reinterpret_cast<int*>(smem_raw + L.placed) : prow;
      if (con) {
        for (int n = n0; n < n1; ++n) P[n] = 0;
        if (tid < Z) {
          zone_placed[tid] = 0;
          czb_s[tid] = at<int>(p, kCzb, b, static_cast<long long>(g) * Z)[tid];
          ezb_s[tid] = at<unsigned char>(p, kEzb, b, static_cast<long long>(g) * Z)[tid];
        }
      }
      __syncthreads();

      // fit_count of node n: per requested resource max(free, 0) / req, the
      // BIG of ops/pack for a resource the group does not request
      auto fit_count = [&](int n) -> int {
        unsigned fc = UINT_MAX;
        for (int r = 0; r < R; ++r) {
          const int s = sh[r];
          const unsigned q =
              s == kNoLimit ? static_cast<unsigned>(kBig) : quotient(F(n, r), mu[r], s);
          fc = min(fc, q);
        }
        return static_cast<int>(fc);
      };
      auto take = [&](int n, int place) {
        for (int r = 0; r < R; ++r) F(n, r) -= mul_wrap(place, rq[r]);
      };

      if (!con) {  // the one-shot first fit (ops/pack.pack_groups' arithmetic)
        unsigned tsum = 0;
        for (int n = n0; n < n1; ++n) {
          int c = feas[n] ? fit_count(n) : 0;
          if (lim) c = min(c, 1);
          c = min(c, cnt);
          fit[n] = c;
          tsum += static_cast<unsigned>(c);
        }
        unsigned total;
        unsigned ex = blk.excl(tsum, total);
        for (int n = n0; n < n1; ++n) {
          const int c = fit[n];
          const int place = min(max(wsub(cnt, static_cast<int>(ex)), 0), c);
          ex += static_cast<unsigned>(c);
          prow[n] = place;
          if (place != 0) take(n, place);
        }
        continue;
      }

      // the wave placer
      const int skew = *at<int>(p, kSSkew, b, g);
      const bool s_self = *at<unsigned char>(p, kSSelf, b, g) != 0;
      const bool a_self = *at<unsigned char>(p, kASelf, b, g) != 0;
      const bool a_any = *at<unsigned char>(p, kAAny, b, g) != 0;
      const int mhb = *at<int>(p, kMhb, b, g);
      const int* s_cnt = at<int>(p, kSCnt, b, gn);
      const unsigned char* s_elig = at<unsigned char>(p, kSElig, b, gn);
      const unsigned char* a_ok = at<unsigned char>(p, kAOk, b, gn);
      const bool boot_kind = a_kind > 0 && a_self && !a_any;
      const bool zone_kind = s_kind == 2 || anti;

      int rem = cnt;
      bool done = false;
      int waves = 0;
      unsigned placed_total = 0;
      auto cnt_at = [&](int n) { return wadd(s_cnt[n], s_self ? P[n] : 0); };
      while (rem > 0 && !done && waves < max_waves) {  // block-uniform
        // no zone prefix can reach the BIG cap when no zone constraint binds
        // and N * rem (the most the fits can sum to) stays below it
        const bool zone_pass = zone_kind || static_cast<long long>(N) * rem > kConBig;

        // 1. the zone caps of this wave (read after the barrier of step 2)
        if (zone_pass && tid < Z) {
          int mz = INT_MAX;
          for (int z = 0; z < Z; ++z) {
            const int cz = wadd(czb_s[z], s_self ? zone_placed[z] : 0);
            mz = min(mz, ezb_s[z] ? cz : kConBig);
          }
          if (mz >= kConBig) mz = 0;
          const int zp = zone_placed[tid];
          const int cz = wadd(czb_s[tid], s_self ? zp : 0);
          int cap = kConBig;
          if (s_kind == 2) cap = max(wsub(wadd(mz, skew), cz), 0);
          if (anti) cap = min(cap, max(wsub(1, zp), 0));
          zone_cap[tid] = cap;
        }

        // 2. fit, feasibility, limit_one; the first node that can take a pod
        // and the hostname-spread minimum
        int first = INT_MAX, mh = INT_MAX;
        for (int n = n0; n < n1; ++n) {
          const bool fe = feas[n] != 0;
          int f = fe ? min(fit_count(n), rem) : 0;
          if (lim) f = min(1 - (P[n] > 0 ? 1 : 0), f);
          if (fe && f > 0) first = min(first, n);
          if (s_kind == 1) mh = min(mh, s_elig[n] ? cnt_at(n) : kConBig);
          fit[n] = f;
        }
        blk.min2(first, mh);

        // 3. positive affinity and the hostname-spread allowance
        const bool boot = boot_kind && placed_total == 0u;
        const bool any = first != INT_MAX;
        int min_h = 0;
        if (s_kind == 1) {
          min_h = min(mh, mhb);
          if (min_h >= kConBig) min_h = 0;
        }
        for (int n = n0; n < n1; ++n) {
          int f = fit[n];
          bool ok = true;
          if (boot) {
            ok = any && n == first;
          } else if (a_kind > 0) {
            const bool open =
                a_kind == 1 ? P[n] > 0 : (zval[n] != 0 && zone_placed[zone_of(n)] > 0);
            ok = a_ok[n] != 0 || (a_self && open);
          }
          if (!ok) f = 0;
          if (s_kind == 1) {
            f = min(f, max(wsub(wadd(min_h, skew), cnt_at(n)), 0));
          }
          fit[n] = f;
        }

        // 4. the zone caps, less the exclusive prefix within the zone: the
        // thread's positions [n0, n1) of the zone-sorted order, one segmented
        // scan (a segment per zone, the keyless nodes last)
        if (zone_pass) {
          __syncthreads();  // every fit is in
          unsigned sf = 0u, ss = 0u;
          for (int q = n0; q < n1; ++q) {
            const unsigned v = static_cast<unsigned>(fit[perm[q]]);
            if (q == 0 || skey[q - 1] != skey[q]) {
              sf = 1u;
              ss = v;
            } else {
              ss += v;
            }
          }
          unsigned run = blk.seg_carry(sf, ss);
          for (int q = n0; q < n1; ++q) {
            const int key = skey[q];
            const int m = perm[q];
            if (q == 0 || skey[q - 1] != key) run = 0u;
            const int v = fit[m];
            if (key < Z) {
              fit[m] = min(v, max(wsub(zone_cap[key], static_cast<int>(run)), 0));
            }
            run += static_cast<unsigned>(v);
          }
          __syncthreads();  // every capped fit is in
        }

        // 5. the global first fit in node order and the update
        unsigned tsum = 0;
        for (int n = n0; n < n1; ++n) tsum += static_cast<unsigned>(fit[n]);
        unsigned total;
        unsigned ex = blk.excl(tsum, total);
        unsigned mine = 0;
        for (int n = n0; n < n1; ++n) {
          const int v = fit[n];
          const int place = min(max(wsub(rem, static_cast<int>(ex)), 0), v);
          ex += static_cast<unsigned>(v);
          if (place != 0) {
            take(n, place);
            P[n] += place;
            if (zval[n]) atomicAdd(&zone_placed[zone_of(n)], place);
            mine += static_cast<unsigned>(place);
          }
        }
        const unsigned n_placed = blk.total(mine);  // its barrier publishes zone_placed
        rem = wsub(rem, static_cast<int>(n_placed));
        placed_total += n_placed;
        done = n_placed == 0u;
        ++waves;
      }
      if (kSmem)
        for (int n = n0; n < n1; ++n) prow[n] = P[n];
      if (tid == 0 && waves > 0) atomicAdd(wave_counter, static_cast<unsigned long long>(waves));
    }

    if (kSmem)
      for (int n = n0; n < n1; ++n)
        for (int r = 0; r < R; ++r) fout[static_cast<size_t>(n) * R + r] = F(n, r);
    __syncthreads();  // the next lane reuses the shared arrays
  }
}

}  // namespace

// Per device, read once: the opt-in shared-memory limit; per instantiation
// the dynamic shared-memory size its attribute allows so far.
constexpr int kMaxDevices = 64;
static std::mutex g_mu;
static int g_max_smem[kMaxDevices];
static size_t g_allowed[kMaxDevices][2];

// Where the lane's plane lives for (N, R, Z): 1 = shared memory, 0 = device
// memory (the caller then passes a [B, N] int32 scratch), -1 = error.
extern "C" int ka_constrained_plane(int N, int R, int Z) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return -1;
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_max_smem[dev] == 0 &&
      cudaDeviceGetAttribute(&g_max_smem[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return -1;
  const size_t max_smem = static_cast<size_t>(g_max_smem[dev]);
  if (layout(N, R, Z, true).end <= max_smem) return 1;
  return layout(N, R, Z, false).end <= max_smem ? 0 : -1;
}

extern "C" int ka_constrained(int mode, const void* const* ptrs, const long long* strides, int B,
                              int G, int N, int R, int Z, int max_waves, int smem_plane,
                              void* stream) {
  if (B <= 0) return 0;
  if (N <= 0 || R <= 0 || Z <= 0 || Z > kMaxThreads || R > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);

  Params p;
  for (int i = 0; i < kNumFields; ++i) {
    p.ptr[i] = ptrs[i];
    p.ls[i] = strides[i];
  }
  const size_t smem = layout(N, R, Z, smem_plane != 0).end;
  void* kernel = smem_plane ? reinterpret_cast<void*>(constrained_kernel<true>)
                            : reinterpret_cast<void*>(constrained_kernel<false>);
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (g_max_smem[dev] == 0) {
      err = cudaDeviceGetAttribute(&g_max_smem[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (smem > static_cast<size_t>(g_max_smem[dev])) return static_cast<int>(cudaErrorInvalidValue);
    size_t& allowed = g_allowed[dev][smem_plane ? 1 : 0];
    if (smem > allowed) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed = smem;
    }
  }
  // no more CTAs than the card holds at once: each walks its share of the
  // lanes, so a batch of mostly inactive lanes (a drain slot) costs no CTA
  // launch per lane
  const int threads = con_threads(N);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = B < sms * max(per_sm, 1) ? B : sms * max(per_sm, 1);
  void* args[] = {&p, &mode, &B, &G, &N, &R, &Z, &max_waves};
  err = cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(grid)), dim3(threads), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
