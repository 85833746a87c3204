// Device code shared by the constrained wave placer (constrained.cu) and the
// drain sweep's topology mode (drain.cu): the helpers that combine values
// over a lane's threads, and the `lax.while_loop` of placement waves of one
// lane (kubernetes_autoscaler_tpu/ops/constrained.py:164-236,
// `place_group_constrained`).
//
// A wave of a lane, in the reference's order, per node n of the lane:
//   fit  = min(fit_count(free[n], req), rem); 0 where infeasible; with
//          limit_one min(1 - (placed[n] > 0), fit)
//   positive affinity: the bootstrap seed (the first node that can take a
//          pod, gated by "some node can"), or resident-satisfied or opened
//          by the group's own placements (host, or zone via zone_placed[Z])
//   hostname spread: min(fit, max(min_h + skew - cnt[n], 0)), min_h a
//          min over the eligible nodes and the base outside the set
//   zone caps: spread allowance and anti-self 1-per-zone per zone, less
//          what earlier nodes of the same zone take (an exclusive prefix in
//          node order within the zone); keyless nodes uncapped
//   the global first fit: place = clip(rem - exclusive_prefix, 0, fit_z)
//   then free -= place * req, placed += place, rem -= sum(place); the lane
//   stops when rem <= 0, a wave places nothing, or after max_waves waves.
// All arithmetic is int32 with the plain version's wrap-around (sums and
// products in unsigned).
//
// A lane runs on one CTA (`Block`: the drain's candidate) or on a
// thread-block cluster (`Cluster`: the constrained kernel's lane, each CTA
// a contiguous slice of the nodes). `place_waves` is written once against
// the helpers' common interface: `gather3` (a sum and two minima over the
// lane), `excl` (an exclusive prefix in node order over the lane),
// `seg_carry` (a segmented scan over the CTA), the zone carry (each zone's
// total over the CTAs before this one: none in one CTA) and `zone_add` (a
// placement's count into every CTA's zone_placed).
//
// Where the lane's free capacity and placed counts live is the caller's:
// `place_waves` reaches them through a Lane object. Thread t owns the
// contiguous nodes [n0, n1) of its CTA's slice, so a node's capacity,
// placed count and fit are touched by one thread only. The zone prefix
// walks a permutation of the CTA's own nodes sorted by zone (`perm`, its
// keys `skey`: zone, Z for keyless; positions [qb, qe) are the CTA's) with
// one segmented scan over the CTA, plus each zone's total in the CTAs
// before; it is skipped where it can change nothing: no zone constraint
// and N * rem below the BIG cap. A wave takes one exchange: the first
// fit's prefix, or, with the zone prefix, the zone totals, from which a
// cluster's CTAs also work out the first fit's prefix where no sum can
// wrap (a fused wave); the minima take one more only where something
// reads them (`place_waves` says when), and that exchange also brings the
// last wave's placed sum, which is otherwise min(rem, the first fit's
// total).

#pragma once

#include <cooperative_groups.h>
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

// shared-memory words the Block helpers take: scan, segf, segs [2][32] and
// the gather's [2][3][32]
constexpr int kBlockWords = 3 * 2 * 32 + 2 * 3 * 32;

// Helpers over one CTA. Each has its own double-buffered slots and phase: a
// warp that runs ahead to the helper's next call writes the other half,
// and the call after that comes only after a barrier every warp passed
// once it had read this call's values.
struct Block {
  static constexpr bool kCluster = false;
  unsigned* scan;  // [2][32]
  unsigned* segf;  // [2][32]
  unsigned* segs;  // [2][32]
  unsigned* red;   // [2][3][32]
  unsigned p_scan = 0, p_seg = 0, p_red = 0;
  int lane, warp, nwarps;

  // the helpers' slots in `words` (kBlockWords words of shared memory)
  __device__ explicit Block(unsigned* words) {
    scan = words;
    segf = words + 64;
    segs = words + 128;
    red = words + 192;
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    nwarps = blockDim.x >> 5;
  }

  __device__ void init() const {}
  __device__ void sync() const { __syncthreads(); }
  __device__ void sync_all() const { __syncthreads(); }

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

  // the sum of s (wrap-around) and the minima of a and b over the threads,
  // on every thread
  __device__ void gather3(unsigned& s, int& a, int& b) {
    s = __reduce_add_sync(kFullMask, s);
    a = __reduce_min_sync(kFullMask, a);
    b = __reduce_min_sync(kFullMask, b);
    unsigned* r = red + (p_red++ & 1u) * 96;
    if (lane == 0) {
      r[warp] = s;
      r[32 + warp] = static_cast<unsigned>(a);
      r[64 + warp] = static_cast<unsigned>(b);
    }
    __syncthreads();
    s = __reduce_add_sync(kFullMask, lane < nwarps ? r[lane] : 0u);
    a = __reduce_min_sync(kFullMask, lane < nwarps ? static_cast<int>(r[32 + lane]) : INT_MAX);
    b = __reduce_min_sync(kFullMask, lane < nwarps ? static_cast<int>(r[64 + lane]) : INT_MAX);
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

  // one CTA holds the whole lane: no zone carry from other CTAs (and no
  // fused wave: see Cluster)
  __device__ void zone_begin() const {}
  __device__ void zone_push(int, unsigned) const {}
  __device__ void zone_sync() const {}
  template <class CapFn>
  __device__ void zone_columns(CapFn, bool) const {}
  __device__ unsigned zone_carry(int) const { return 0u; }
  __device__ void zone_add(int* zone_placed, int z, int v) const { atomicAdd(&zone_placed[z], v); }
  __device__ int zp(const int* zone_placed, int z) const { return zone_placed[z]; }
  __device__ void wave_end(int*) const {}
  // a group's start: no placement (the caller's barrier follows)
  __device__ void zone_reset(int* zone_placed, int Z) const {
    for (int z = threadIdx.x; z < Z; z += blockDim.x) zone_placed[z] = 0;
  }
};

// Helpers over a thread-block cluster of CS CTAs, one lane. An exchange:
// each warp's partial, reduced over the warp, stored into every CTA's
// shared memory by `st.async`, each store counted off the receiving CTA's
// mbarrier (which its thread 0 has told how many bytes to expect), then
// every thread of every CTA waits on its own CTA's mbarrier: no cluster
// barrier, no fence wider than the stores. Every warp then reads the CS x
// nwarps partials from its own CTA. Each kind of exchange alternates two
// buffers and two mbarriers: a warp stores into a buffer only after its
// CTA's wait on the exchange before, which needs every warp of every CTA
// to have stored into that one, which each does only once it has read the
// buffer's last values. The zone exchange sends each CTA's zone totals
// (its keyless total last) into every CTA: from them each CTA has the zone
// carry of its own nodes and, where no sum can wrap, every CTA's capped
// total, so the first fit's prefix across CTAs needs no exchange of its
// own.
struct Cluster {
  static constexpr bool kCluster = true;
  Block cta;
  uint4* xbuf;               // [2][CS * nwarps] the warps' partials
  unsigned* zbuf;            // [2][CS][Zp] each CTA's zone and keyless totals
  unsigned* zt;              // [Zp] this CTA's, as they are sent
  unsigned long long* mb;    // [4] mbarriers: the partials' two, the zones' two
  unsigned* cols;            // [Z + 1][CS] each CTA's capped zone totals of a fused wave
  unsigned* carry;           // [Z + 1] this CTA's zone carries
  int* zd;                   // [2][Z] zone placements of the last wave and this one
  int CS, rank, Z, Zp;
  unsigned px = 0, pz = 0, phases = 0, zpar = 0;
  int lane, warp, nwarps;

  // `words` as Block's; `x`, `zb`, `t` the exchange buffers (16-byte
  // aligned) and `m` four mbarriers, which `init` sets up before the
  // cluster's first barrier; `c` (Z + 1) x 17 words (the columns at CS up
  // to 16, then the carries); `d` [2][Z]. Zp is Z + 1 rounded up to 4.
  __device__ Cluster(unsigned* words, uint4* x, unsigned* zb, unsigned* t,
                     unsigned long long* m, unsigned* c, int* d, int zones)
      : cta(words), xbuf(x), zbuf(zb), zt(t), mb(m), cols(c), carry(c + (zones + 1) * 16),
        zd(d), Z(zones), Zp((zones + 4) & ~3) {
    cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
    CS = static_cast<int>(cl.num_blocks());
    rank = static_cast<int>(cl.block_rank());
    lane = cta.lane;
    warp = cta.warp;
    nwarps = cta.nwarps;
  }

  __device__ static unsigned saddr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
  }
  // the shared::cluster address of local address `a` in CTA r
  __device__ static unsigned at_rank(unsigned a, int r) {
    unsigned out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(a), "r"(r));
    return out;
  }
  __device__ static void st_async(unsigned addr, uint4 v, unsigned bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
        "[%5];" ::"r"(addr),
        "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
        : "memory");
  }
  __device__ static void expect(unsigned bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                 : "memory");
  }
  // waits for mbarrier `i`'s current phase; an exchange that never
  // completes is a fault (a trap), not a hang
  __device__ void wait(int i) {
    const unsigned bar = saddr(mb + i), parity = (phases >> i) & 1u;
    unsigned done = 0;
    long long spins = 0;
    do {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
      if (++spins > (1ll << 26)) __trap();
    } while (!done);
    phases ^= 1u << i;
  }
  // thread 0 sets up the mbarriers (one arrival a phase: its own); the
  // caller's cluster barrier follows
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < 4; ++i)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(mb + i)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }

  __device__ void sync() const { __syncthreads(); }
  __device__ void sync_all() const { cluster_sync(); }

  __device__ static void cluster_sync() {
    __syncwarp();
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }

  // lane r < CS stores this warp's partial into CTA r's buffer; then the
  // wait; returns this exchange's buffer
  __device__ const uint4* exchange(uint4 v) {
    const int par = static_cast<int>(px++ & 1u);
    uint4* buf = xbuf + par * (CS * nwarps);
    // the CTA's zone_add stores so far reach every CTA before its stores
    // of this exchange (the barrier, then their release)
    __syncthreads();
    if (threadIdx.x == 0) expect(saddr(mb + par), static_cast<unsigned>(CS * nwarps) * 16u);
    if (lane < CS)
      st_async(at_rank(saddr(buf + rank * nwarps + warp), lane), v, at_rank(saddr(mb + par), lane));
    wait(par);
    return buf;
  }

  __device__ unsigned excl(unsigned x, unsigned& total) {
    const unsigned inc = warp_incl(x, lane);
    const unsigned wsum = __shfl_sync(kFullMask, inc, 31);
    const uint4* e = exchange(make_uint4(wsum, 0u, 0u, 0u));
    const int me = rank * nwarps + warp;
    unsigned before = 0u, all = 0u;
    for (int i = lane; i < CS * nwarps; i += 32) {
      const unsigned v = e[i].x;
      all += v;
      if (i < me) before += v;
    }
    total = __reduce_add_sync(kFullMask, all);
    return __reduce_add_sync(kFullMask, before) + inc - x;
  }

  __device__ void gather3(unsigned& s, int& a, int& b) {
    s = __reduce_add_sync(kFullMask, s);
    a = __reduce_min_sync(kFullMask, a);
    b = __reduce_min_sync(kFullMask, b);
    const uint4* e =
        exchange(make_uint4(s, static_cast<unsigned>(a), static_cast<unsigned>(b), 0u));
    unsigned ss = 0u;
    int aa = INT_MAX, bb = INT_MAX;
    for (int i = lane; i < CS * nwarps; i += 32) {
      const uint4 v = e[i];
      ss += v.x;
      aa = min(aa, static_cast<int>(v.y));
      bb = min(bb, static_cast<int>(v.z));
    }
    s = __reduce_add_sync(kFullMask, ss);
    a = __reduce_min_sync(kFullMask, aa);
    b = __reduce_min_sync(kFullMask, bb);
  }

  __device__ unsigned seg_carry(unsigned f, unsigned s) { return cta.seg_carry(f, s); }

  // the zone step's start: no zone total yet (before a CTA barrier)
  __device__ void zone_begin() const {
    for (int z = threadIdx.x; z < Zp; z += blockDim.x) zt[z] = 0u;
  }
  // zone `key`'s total over this CTA's positions (key Z: its keyless nodes)
  __device__ void zone_push(int key, unsigned total) const { zt[key] = total; }
  // the zone exchange: every CTA's totals into every CTA (a CTA barrier,
  // then warp 0 stores, then the wait)
  __device__ void zone_sync() {
    const int par = 2 + static_cast<int>(pz & 1u);
    unsigned* buf = zbuf + (pz++ & 1u) * (CS * Zp);
    __syncthreads();  // every total is in zt
    if (threadIdx.x == 0) expect(saddr(mb + par), static_cast<unsigned>(CS * Zp) * 4u);
    if (warp == 0) {
      // a lane reads its chunk before it stores it anywhere: no thread
      // passes this CTA's wait (and clears zt in the next wave) before
      // every chunk has reached this CTA
      const uint4* src = reinterpret_cast<const uint4*>(zt);
      for (int c = lane; c < Zp / 4; c += 32) {
        const uint4 v = src[c];
        for (int d = 0; d < CS; ++d)
          st_async(at_rank(saddr(buf + rank * Zp + 4 * c), d), v, at_rank(saddr(mb + par), d));
      }
    }
    wait(par);
    zcur = buf;
  }
  unsigned* zcur = nullptr;  // the last zone exchange's buffer
  // CTA k's total of zone `key` in the last zone exchange
  __device__ unsigned zone_total(int k, int key) const { return zcur[k * Zp + key]; }
  // After the zone exchange: each warp takes zones z = warp, warp + nwarps,
  // ..., each lane k < CS CTA k's total T of z and, by a warp scan, the
  // earlier CTAs' total C: this CTA's carry of z, and, for a fused wave
  // (where no sum wraps), CTA k's capped total of z: its fits of z run from
  // C over T and the cap keeps min(T, max(cap - C, 0)) of them (keyless
  // fits uncapped). One CTA barrier.
  template <class CapFn>
  __device__ void zone_columns(CapFn cap_of, bool fused) {
    for (int z = warp; z <= Z; z += nwarps) {
      const unsigned T = lane < CS ? zone_total(lane, z) : 0u;
      const unsigned C = warp_incl(T, lane) - T;
      if (lane == rank) carry[z] = C;
      if (fused && lane < CS)
        cols[z * CS + lane] =
            z == Z ? T : min(T, static_cast<unsigned>(max(wsub(cap_of(z), static_cast<int>(C)), 0)));
    }
    __syncthreads();
  }
  // the sum of zone `key`'s totals over the CTAs before this one
  __device__ unsigned zone_carry(int key) const { return carry[key]; }
  // a fused wave's capped total of the CTAs before this one; `total` the
  // lane's
  __device__ unsigned capped_before(unsigned& total) const {
    unsigned mine = 0u;
    if (lane < CS)
      for (int z = 0; z <= Z; ++z) mine += cols[z * CS + lane];
    total = __reduce_add_sync(kFullMask, mine);
    return __reduce_add_sync(kFullMask, lane < rank ? mine : 0u);
  }
  // Every CTA keeps the lane's zone placements: zone_placed through the
  // wave before last, and each wave's own in zd[wave & 1], into which a
  // placement adds in every CTA. A wave reads zone_placed plus the last
  // wave's zd, which no CTA writes during it (a fused wave has no barrier
  // between one CTA's reads and another's placements), and at its end
  // folds that zd into zone_placed for the next wave to write.
  // (ordered before the CTA's next exchange by a fence here, then the
  // exchange's CTA barrier and its stores' release)
  __device__ void zone_add(int*, int z, int v) const {
    int* dst = zd + zpar * Z + z;
    for (int d = 0; d < CS; ++d)
      atomicAdd(cooperative_groups::this_cluster().map_shared_rank(dst, d), v);
    asm volatile("fence.acq_rel.cluster;" ::: "memory");
  }
  __device__ int zp(const int* zone_placed, int z) const {
    return wadd(zone_placed[z], zd[(zpar ^ 1u) * Z + z]);
  }
  // after every thread's reads of the wave (a barrier since them)
  __device__ void wave_end(int* zone_placed) {
    const unsigned last = zpar ^ 1u;
    for (int z = threadIdx.x; z < Z; z += blockDim.x) {
      zone_placed[z] = wadd(zone_placed[z], zd[last * Z + z]);
      zd[last * Z + z] = 0;
    }
    zpar = last;
  }
  // a group's start: no placement (the caller's barrier follows)
  __device__ void zone_reset(int* zone_placed, int) {
    for (int z = threadIdx.x; z < Z; z += blockDim.x) zone_placed[z] = zd[z] = zd[Z + z] = 0;
    zpar = 0;
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
// the lane calls it (lane-uniform). On entry zone_placed[Z] is 0 and
// czb[Z], ezb[Z] hold the lane's cnt_zone_base and elig_zone_base, all
// visible to every thread of the CTA (a barrier since they were written),
// and the lane's placed count is 0 on every node. `fit` is a row indexed
// by node; `perm` and `skey` are indexed by position, the CTA's positions
// [qb, qe) holding its own nodes. Lane provides, for a node n of the
// calling thread's range:
//   feas(n), fit_count(n), placed(n), place(n, v) (free -= v * req,
//   placed += v), s_cnt(n), s_elig(n), a_ok(n), zval(n), zone_of(n).
//
// The exchanges a wave needs. The last wave's placed sum is min(rem,
// total of the fits) wherever no prefix can wrap (N * rem < 2^31: every
// fit is at most rem), so the first fit's own exchange gives it; an
// exchange of the minima (`gather3`, which brings the sum too) runs only
// for what reads them or what the sum cannot stand for: the first wave of
// a bootstrap group (the seed node), every wave of a hostname spread (its
// minimum), every wave of a zone affinity after the first (its open zones
// read zone_placed, which a barrier must publish), and a wave whose prefix
// could wrap. The zone caps read zone_placed after the zone prefix's own
// barriers, each warp taking the minimum over the zones itself.
template <class Helper, class Lane>
__device__ int place_waves(Helper& blk, Lane& L, const WaveGroup& g, int N, int Z, int n0,
                           int n1, int qb, int qe, int max_waves, int* fit, int* zone_placed,
                           const int* czb, const int* ezb, const int* perm, const int* skey) {
  const int lane = threadIdx.x & 31;
  const bool boot_kind = g.a_kind > 0 && g.a_self && !g.a_any;
  const bool zone_kind = g.s_kind == 2 || g.anti;

  int rem = g.cnt;
  if (rem <= 0 || max_waves <= 0) return 0;  // lane-uniform
  bool done = false;
  int waves = 0;
  unsigned placed_total = 0, mine = 0, sum = 0;
  bool sum_known = true, minima = false;
  auto cnt_at = [&](int n) { return wadd(L.s_cnt(n), g.s_self ? L.placed(n) : 0); };
  auto cz_of = [&](int z) { return wadd(czb[z], g.s_self ? blk.zp(zone_placed, z) : 0); };
  while (true) {
    // 2. each node's fit before the wave's clips (0 where infeasible); the
    // first node that can take a pod and the hostname-spread minimum
    minima = waves == 0 ? boot_kind || g.s_kind == 1
                                   : g.s_kind == 1 || g.a_kind == 2 || !sum_known;
    int first = INT_MAX, mh = INT_MAX;
    for (int n = n0; n < n1; ++n) {
      const int f = L.feas(n) ? L.fit_count(n) : 0;
      if (f > 0 && (!g.lim || L.placed(n) == 0)) first = min(first, n);
      if (g.s_kind == 1) mh = min(mh, L.s_elig(n) ? cnt_at(n) : kConBig);
      fit[n] = f;
    }
    unsigned n_placed = sum;
    if (minima) {  // lane-uniform
      n_placed = mine;
      blk.gather3(n_placed, first, mh);  // its barrier publishes zone_placed
    }
    if (waves > 0) {
      rem = wsub(rem, static_cast<int>(n_placed));
      placed_total += n_placed;
      done = n_placed == 0u;
    }
    if (rem <= 0 || done || waves >= max_waves) break;  // lane-uniform

    // 3. the fit and limit_one, positive affinity and the hostname-spread
    // allowance
    bool fused = false;
    unsigned before_cta = 0u, fused_total = 0u;
    const bool boot = boot_kind && placed_total == 0u;
    const bool any = first != INT_MAX;
    int min_h = 0;
    if (g.s_kind == 1) {
      min_h = min(mh, g.mhb);
      if (min_h >= kConBig) min_h = 0;
    }
    for (int n = n0; n < n1; ++n) {
      int f = min(fit[n], rem);
      if (g.lim) f = min(1 - (L.placed(n) > 0 ? 1 : 0), f);
      bool ok = true;
      if (boot) {
        ok = any && n == first;
      } else if (g.a_kind > 0) {
        const bool open =
            g.a_kind == 1 ? L.placed(n) > 0 : (L.zval(n) && blk.zp(zone_placed, L.zone_of(n)) > 0);
        ok = L.a_ok(n) || (g.a_self && open);
      }
      if (!ok) f = 0;
      if (g.s_kind == 1) {
        f = min(f, max(wsub(wadd(min_h, g.skew), cnt_at(n)), 0));
      }
      fit[n] = f;
    }

    // 4. the zone caps (spread allowance and anti-self 1-per-zone), less
    // the exclusive prefix within the zone: the thread's positions [n0, n1)
    // of the CTA's zone-sorted order, one segmented scan (a segment per
    // zone, the keyless nodes last), plus the zone's total in the CTAs
    // before this one. No zone prefix can reach the BIG cap when no zone
    // constraint binds and N * rem (the most the fits can sum to) stays
    // below it.
    if (zone_kind || static_cast<long long>(N) * rem > kConBig) {  // lane-uniform
      blk.zone_begin();
      blk.sync();  // every fit is in
      unsigned sf = 0u, ss = 0u;
      for (int q = n0; q < n1; ++q) {
        const unsigned v = static_cast<unsigned>(fit[perm[q]]);
        if (q == qb || skey[q - 1] != skey[q]) {
          sf = 1u;
          ss = v;
        } else {
          ss += v;
        }
      }
      unsigned run = blk.seg_carry(sf, ss);
      if constexpr (Helper::kCluster) {
        unsigned r = run;
        for (int q = n0; q < n1; ++q) {
          const int key = skey[q];
          if (q == qb || skey[q - 1] != key) r = 0u;
          r += static_cast<unsigned>(fit[perm[q]]);
          if (q == qe - 1 || skey[q + 1] != key) blk.zone_push(key, r);
        }
        blk.zone_sync();
      }
      // the spread's minimum over the eligible zones, in every warp
      int mz = kConBig;
      if (g.s_kind == 2) {
        for (int z = lane; z < Z; z += 32)
          if (ezb[z]) mz = min(mz, cz_of(z));
        mz = __reduce_min_sync(kFullMask, mz);
        if (mz >= kConBig) mz = 0;
      }
      auto cap_of = [&](int z) {
        int cap = kConBig;
        if (g.s_kind == 2) cap = max(wsub(wadd(mz, g.skew), cz_of(z)), 0);
        if (g.anti) cap = min(cap, max(wsub(1, blk.zp(zone_placed, z)), 0));
        return cap;
      };
      // a fused wave: every CTA's capped total from the zone totals, so the
      // first fit's prefix across CTAs takes no exchange
      fused = Helper::kCluster && static_cast<long long>(N) * rem <= INT_MAX;
      blk.zone_columns(cap_of, fused);
      for (int q = n0; q < n1; ++q) {
        const int key = skey[q];
        const int m = perm[q];
        if (q == qb || skey[q - 1] != key) run = 0u;
        const int v = fit[m];
        if (key < Z) {
          const unsigned before = run + blk.zone_carry(key);
          fit[m] = min(v, max(wsub(cap_of(key), static_cast<int>(before)), 0));
        }
        run += static_cast<unsigned>(v);
      }
      if constexpr (Helper::kCluster) {
        if (fused) before_cta = blk.capped_before(fused_total);
      }
      blk.sync();  // every capped fit is in
    }

    // 5. the global first fit in node order and the update
    unsigned tsum = 0;
    for (int n = n0; n < n1; ++n) tsum += static_cast<unsigned>(fit[n]);
    unsigned total;
    unsigned ex;
    if constexpr (Helper::kCluster) {
      if (fused) {  // lane-uniform
        ex = before_cta + blk.cta.excl(tsum, total);
        total = fused_total;
      } else {
        ex = blk.excl(tsum, total);
      }
    } else {
      ex = blk.excl(tsum, total);
    }
    mine = 0;
    for (int n = n0; n < n1; ++n) {
      const int v = fit[n];
      const int place = min(max(wsub(rem, static_cast<int>(ex)), 0), v);
      ex += static_cast<unsigned>(v);
      if (place != 0) {
        L.place(n, place);
        if (L.zval(n)) blk.zone_add(zone_placed, L.zone_of(n), place);
        mine += static_cast<unsigned>(place);
      }
    }
    // every fit is at most rem: below 2^31 the prefix cannot wrap, and the
    // wave places min(rem, total)
    sum_known = static_cast<long long>(N) * rem <= INT_MAX;
    sum = min(static_cast<unsigned>(rem), total);
    blk.wave_end(zone_placed);
    ++waves;
  }
  // a wave's zone_add stores reach every CTA before its next barrier: the
  // caller's next group may clear zone_placed only after one
  if (!minima) blk.sync_all();
  return waves;
}

}  // namespace ka
