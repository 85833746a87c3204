// Device code shared by the constrained wave placer (constrained.cu) and the
// drain sweep's topology mode (drain.cu): the block-wide helpers and the
// `lax.while_loop` of placement waves of one lane
// (kubernetes_autoscaler_tpu/ops/constrained.py:164-236,
// `place_group_constrained`).
//
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
// products in unsigned).
//
// Where the lane's free capacity and placed counts live is the caller's:
// `place_waves` reaches them through a Lane object (the constrained kernel's
// [R][N] plane in shared memory or its [N][R] plane in device memory; the
// drain's shared free plane less a candidate's debit rows). Thread t owns the
// contiguous nodes [n0, n1), so a node's capacity and placed count are
// touched by one thread only. The zone prefix walks a zone-sorted
// permutation of the nodes (`perm`, its keys `skey`: zone, Z for keyless)
// with one segmented block scan, and is skipped where it can change
// nothing: no zone constraint and N * rem below the BIG cap. A wave costs 3
// barriers (5 with zone caps).

#pragma once

#include <cuda_runtime.h>
#include <limits.h>

#include "pack_row.cuh"

namespace ka {

constexpr int kConBig = 1 << 28;  // ops/constrained.BIG

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

// shared-memory words the Block helpers take: scan, sum, segf, segs [2][32]
// and mins [2][2][32]
constexpr int kBlockWords = 6 * 2 * 32;

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

  // the helpers' slots in `words` (kBlockWords words of shared memory)
  __device__ Block(unsigned* words) {
    scan = words;
    sum = words + 64;
    mins = reinterpret_cast<int*>(words + 128);
    segf = words + 256;
    segs = words + 320;
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    nwarps = blockDim.x >> 5;
  }

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

// The group's scalars of one lane's wave loop.
struct WaveGroup {
  int cnt;       // pods to place
  bool lim;      // limit_one
  int s_kind;    // 0 none, 1 hostname, 2 zone spread
  int skew;
  bool s_self;   // own placements count toward the spread
  int a_kind;    // 0 none, 1 hostname, 2 zone affinity
  bool a_self;
  bool a_any;
  bool anti;     // anti-self 1-per-zone
  int mhb;       // min_host_base
};

// The waves of one lane; returns the number of waves run. Every thread of
// the CTA calls it (block-uniform). On entry zone_placed[Z] is 0 and
// czb[Z], ezb[Z] hold the lane's cnt_zone_base and elig_zone_base, all
// visible to every thread (a barrier since they were written), and the
// lane's placed count is 0 on every node. `fit` is an [N] scratch row in
// shared memory, `zone_cap` [Z]. Lane provides, for a node n of the
// calling thread's range (or, for zval and zone_of, any node):
//   feas(n), fit_count(n), placed(n), place(n, v) (free -= v * req,
//   placed += v), s_cnt(n), s_elig(n), a_ok(n), zval(n), zone_of(n).
template <class Lane>
__device__ int place_waves(Block& blk, Lane& L, const WaveGroup& g, int N, int Z, int n0,
                           int n1, int max_waves, int* fit, int* zone_placed, int* zone_cap,
                           const int* czb, const int* ezb, const int* perm, const int* skey) {
  const int tid = threadIdx.x;
  const bool boot_kind = g.a_kind > 0 && g.a_self && !g.a_any;
  const bool zone_kind = g.s_kind == 2 || g.anti;

  int rem = g.cnt;
  bool done = false;
  int waves = 0;
  unsigned placed_total = 0;
  auto cnt_at = [&](int n) { return wadd(L.s_cnt(n), g.s_self ? L.placed(n) : 0); };
  while (rem > 0 && !done && waves < max_waves) {  // block-uniform
    // no zone prefix can reach the BIG cap when no zone constraint binds
    // and N * rem (the most the fits can sum to) stays below it
    const bool zone_pass = zone_kind || static_cast<long long>(N) * rem > kConBig;

    // 1. the zone caps of this wave (read after the barrier of step 2)
    if (zone_pass && tid < Z) {
      int mz = INT_MAX;
      for (int z = 0; z < Z; ++z) {
        const int cz = wadd(czb[z], g.s_self ? zone_placed[z] : 0);
        mz = min(mz, ezb[z] ? cz : kConBig);
      }
      if (mz >= kConBig) mz = 0;
      const int zp = zone_placed[tid];
      const int cz = wadd(czb[tid], g.s_self ? zp : 0);
      int cap = kConBig;
      if (g.s_kind == 2) cap = max(wsub(wadd(mz, g.skew), cz), 0);
      if (g.anti) cap = min(cap, max(wsub(1, zp), 0));
      zone_cap[tid] = cap;
    }

    // 2. fit, feasibility, limit_one; the first node that can take a pod
    // and the hostname-spread minimum
    int first = INT_MAX, mh = INT_MAX;
    for (int n = n0; n < n1; ++n) {
      const bool fe = L.feas(n);
      int f = fe ? min(L.fit_count(n), rem) : 0;
      if (g.lim) f = min(1 - (L.placed(n) > 0 ? 1 : 0), f);
      if (fe && f > 0) first = min(first, n);
      if (g.s_kind == 1) mh = min(mh, L.s_elig(n) ? cnt_at(n) : kConBig);
      fit[n] = f;
    }
    blk.min2(first, mh);

    // 3. positive affinity and the hostname-spread allowance
    const bool boot = boot_kind && placed_total == 0u;
    const bool any = first != INT_MAX;
    int min_h = 0;
    if (g.s_kind == 1) {
      min_h = min(mh, g.mhb);
      if (min_h >= kConBig) min_h = 0;
    }
    for (int n = n0; n < n1; ++n) {
      int f = fit[n];
      bool ok = true;
      if (boot) {
        ok = any && n == first;
      } else if (g.a_kind > 0) {
        const bool open =
            g.a_kind == 1 ? L.placed(n) > 0 : (L.zval(n) && zone_placed[L.zone_of(n)] > 0);
        ok = L.a_ok(n) || (g.a_self && open);
      }
      if (!ok) f = 0;
      if (g.s_kind == 1) {
        f = min(f, max(wsub(wadd(min_h, g.skew), cnt_at(n)), 0));
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
        L.place(n, place);
        if (L.zval(n)) atomicAdd(&zone_placed[L.zone_of(n)], place);
        mine += static_cast<unsigned>(place);
      }
    }
    const unsigned n_placed = blk.total(mine);  // its barrier publishes zone_placed
    rem = wsub(rem, static_cast<int>(n_placed));
    placed_total += n_placed;
    done = n_placed == 0u;
    ++waves;
  }
  return waves;
}

}  // namespace ka
