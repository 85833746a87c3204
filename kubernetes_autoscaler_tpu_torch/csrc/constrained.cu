// The constrained wave placer, hand-written for Hopper (sm_90a): B lanes,
// one thread-block cluster a lane, every wave of a lane on the device with
// no host read. Two entries: `ka_constrained` packs a lane's G groups
// (`pack_lanes`), `ka_constrained_place` places one group a lane by waves
// (`place_lanes`, the reference's `place_group_constrained` under vmap:
// G = 1, every group by waves whatever its constraints, the count,
// request, limit_one and constraints per lane through the lane strides,
// and a lane whose `active` byte is 0 returns at once, its outputs left
// as the caller holds them).
//
// Replaces XLA code with no pallas_call: the `lax.scan` over groups at
// kubernetes_autoscaler_tpu/ops/constrained.py:239-290
// (`pack_groups_constrained`, under vmap over options; its
// `lax.cond(is_con[g], slow, fast)`) and the `lax.while_loop` of placement
// waves at :164-236 (`place_group_constrained`, the slow branch). Each lane
// walks the G groups in `order` (read on the device): a constrained group
// by waves, any other by the one-shot first fit of ops/pack (the
// reference's `fast`). A wave is csrc/waves.cuh's `place_waves` (shared
// with the drain sweep's topology mode, csrc/drain.cu), whose header gives
// its steps. All arithmetic is int32 with the plain version's wrap-around
// (sums and products in unsigned), so the result is byte-equal to
// ops/kernels/constrained_kernel.py's plain version, not close to it.
//
// What bounds it. Not bytes: a lane reads its free plane once (160 KB at
// N = 5,120, R = 8) and a group's constraint rows once. The bound is the
// dependent chain of waves (up to 128 a group, groups one after another),
// each a few lane-wide exchanges; a batch of one lane (the filter pack)
// has nothing else to run beside it.
//
// The design. A lane is a cluster of CS CTAs (CS up to 16, the
// non-portable size, chosen so that B x CS stays within the card's SMs and
// a CTA keeps at least 256 nodes; a lane of up to 1,024 nodes, which 512
// threads cover at 2 a thread, stays one CTA with the CTA's own helpers,
// whose exchanges are CTA barriers: there a cluster barrier costs more
// than the work it would split, tools/torch_constrained_trace.py
// --clusters); CTA k owns the contiguous nodes
// [k Ns, (k + 1) Ns), Ns = ceil(N / CS), and its threads own K = ceil(Ns /
// threads) contiguous nodes each. Each CTA keeps its slice of the lane's
// free plane ([R][Ns]), placed row, fit row and a fit cache in shared
// memory, and stages its slice of the lane's zone rows and positions once
// and of a group's constraint rows once a group: each thread stages and
// reads its own nodes, so staging takes no barrier. The fit cache holds
// each node's fit_count (0 where infeasible), computed once a group and
// again only where a wave placed pods, by the node's thread. The lane-wide
// steps of a wave are exchanges of the cluster helper (csrc/waves.cuh
// `Cluster`): each warp's partial stored into every CTA's shared memory by
// st.async, counted off the receiving CTA's mbarrier, each warp combining
// the CS x warps partials from its own CTA once its mbarrier completes (no
// cluster barrier a wave). The zone prefix runs on a permutation of each
// CTA's own nodes sorted by zone, node order kept (a counting sort each CTA
// runs once a launch, `sort_slice`), one segmented CTA scan, plus each
// zone's total in the
// earlier CTAs, pushed by the thread where the zone's run ends: a zone
// whose nodes span CTAs reads its earlier part in that one exchange, and
// no thread reads another CTA's fits. From the same totals each CTA works
// out every CTA's capped total, so a wave with zone caps also takes its
// first fit's prefix across CTAs from them: one exchange a wave, where no
// sum can wrap, and one more where the hostname-spread minimum or a zone
// affinity's open zones are read (waves.cuh says when). Where the slices do
// not fit in shared memory (N past ≈ 3,500 a CTA at R = 8), the plane
// stays in the free_out buffer, the placed row in the output, the fit row
// and fit cache in a scratch buffer and the rows in device memory, with
// the same code. No division: pack_row.cuh's multiply-high codes, computed
// once a group.
//
// Contract (checked by the Python wrapper): int32 and uint8 (bool)
// tensors; every lane input is [L, ...] with L = 1 or B and its lane
// stride in `ls` (0 for a row shared by every lane), its trailing dims
// contiguous; outputs free_out [B,N,R], placed [B,G,N], scratch [B,4,N]
// when the slices are in device memory (ka_constrained_config),
// waves a u64 counter that each lane adds its wave count to, active (the
// place entry's) u8[B] or null. Launches on
// the given stream and returns the CUDA error: a cluster the card cannot
// schedule is an error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>

#include <mutex>

#include "pack_row.cuh"
#include "waves.cuh"

namespace {

using namespace ka;

enum Field {
  kFreeIn, kFreeOut, kPlaced, kFeas, kReq, kWant, kLimit, kOrder,
  kSKind, kSSkew, kSSelf, kSCnt, kSElig, kAKind, kASelf, kAAny, kAOk, kAnti,
  kCzb, kEzb, kMhb, kZcl, kZval, kScratch, kWaves, kActive, kNumFields
};

struct Params {
  const void* ptr[kNumFields];
  long long ls[kNumFields];  // lane stride in elements; 0 = shared row
};

constexpr int kMaxCluster = 16;     // non-portable: needs 16 SMs of one GPC free
constexpr int kPortableCluster = 8;
constexpr int kMinSlice = 256;      // nodes a CTA keeps at least
constexpr int kConThreads = 512;

// byte offsets of the shared-memory arrays of a CTA (Ns nodes, W warps)
struct Layout {
  size_t blk, xbuf, mb, zbuf, zt, cols, zd, zp, czb, ezb, req, mul, sh, plane, placed, fit, fc, s_cnt, zcl,
      perm, skey, feas, s_elig, a_ok, zval, end;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

__host__ __device__ inline Layout layout(int Ns, int R, int Z, int CS, int W, bool smem) {
  Layout l;
  const size_t z4 = static_cast<size_t>(Z) * 4, r4 = static_cast<size_t>(R) * 4;
  l.blk = 0;                                                  // u32 [kBlockWords]
  l.xbuf = align16(l.blk + kBlockWords * 4);                  // uint4 [2][CS * W]
  const size_t zp4 = static_cast<size_t>((Z + 4) & ~3) * 4;    // Zp words
  l.mb = l.xbuf + 2 * static_cast<size_t>(CS) * W * 16;       // u64 [4] mbarriers
  l.zbuf = l.mb + 4 * 8;                                      // u32 [2][CS][Zp]
  l.zt = l.zbuf + 2 * static_cast<size_t>(CS) * zp4;          // u32 [Zp]
  l.cols = l.zt + zp4;                                        // u32 [Z + 1][17]
  l.zd = l.cols + static_cast<size_t>(Z + 1) * 17 * 4;        // i32 [2][Z]
  l.zp = l.zd + 2 * z4;                                       // i32 [Z] zone_placed
  l.czb = l.zp + z4;                                          // i32 [Z] cnt_zone_base
  l.ezb = l.czb + z4;                                         // i32 [Z] elig_zone_base
  l.req = l.ezb + z4;                                         // i32 [2][R]
  l.mul = l.req + 2 * r4;                                     // u32 [2][R]
  l.sh = l.mul + 2 * r4;                                      // i32 [2][R]
  l.plane = align16(l.sh + 2 * r4);
  const size_t n4 = smem ? static_cast<size_t>(Ns) * 4 : 0, n1 = smem ? Ns : 0;
  l.placed = l.plane + n4 * R;  // i32 [R][Ns] plane, then i32 [Ns] each:
  l.fit = l.placed + n4;        //   placed, fit, fit cache, s_cnt, zone,
  l.fc = l.fit + n4;            //   perm, skey
  l.s_cnt = l.fc + n4;
  l.zcl = l.s_cnt + n4;
  l.perm = l.zcl + n4;
  l.skey = l.perm + n4;
  l.feas = l.skey + n4;         // u8 [Ns] each: feas, s_elig, a_ok, zval
  l.s_elig = l.feas + n1;
  l.a_ok = l.s_elig + n1;
  l.zval = l.a_ok + n1;
  l.end = align16(l.zval + n1);
  return l;
}

template <typename T>
__device__ __forceinline__ const T* at(const Params& p, Field f, int b, long long off = 0) {
  return static_cast<const T*>(p.ptr[f]) + p.ls[f] * b + off;
}

template <typename T>
__device__ __forceinline__ T* shifted(unsigned char* base, size_t off, int s0) {
  return reinterpret_cast<T*>(base + off) - s0;
}

// One lane's CTA slice as csrc/waves.cuh's `place_waves` sees it. Every
// per-node pointer is indexed by the global node index (shared-memory
// slices are offset by the slice's first node); the plane is
// plane[n * sn + r * sr] ([R][Ns] in shared memory, [N][R] in free_out).
struct ConLane {
  int* plane;
  long long sn, sr;
  int* P;   // the group's placed row
  int* fc;  // the fit cache
  int R, Z;
  const int* rq;
  const unsigned* mu;
  const int* sh;
  const unsigned char* feas_;
  const int* s_cnt_;
  const unsigned char* s_elig_;
  const unsigned char* a_ok_;
  const unsigned char* zval_;
  const int* zcl;

  __device__ int& F(int n, int r) const { return plane[n * sn + r * sr]; }
  // per requested resource max(free, 0) / req, the BIG of ops/pack for a
  // resource the group does not request
  __device__ int raw_fit(int n) const {
    unsigned fc_ = UINT_MAX;
    for (int r = 0; r < R; ++r) {
      const int s = sh[r];
      const unsigned q = s == kNoLimit ? static_cast<unsigned>(kBig) : quotient(F(n, r), mu[r], s);
      fc_ = min(fc_, q);
    }
    return static_cast<int>(fc_);
  }
  __device__ void take(int n, int place) const {
    for (int r = 0; r < R; ++r) F(n, r) -= mul_wrap(place, rq[r]);
  }
  __device__ bool feas(int n) const { return feas_[n] != 0; }
  __device__ int fit_count(int n) const { return fc[n]; }
  __device__ int placed(int n) const { return P[n]; }
  __device__ void place(int n, int v) const {
    take(n, v);
    P[n] += v;
    fc[n] = raw_fit(n);  // a node that took a pod is feasible
  }
  __device__ int s_cnt(int n) const { return s_cnt_[n]; }
  __device__ bool s_elig(int n) const { return s_elig_[n] != 0; }
  __device__ bool a_ok(int n) const { return a_ok_[n] != 0; }
  __device__ bool zval(int n) const { return zval_[n] != 0; }
  __device__ int zone_of(int n) const { return min(max(zcl[n], 0), Z - 1); }
};

// The lane's helper: a cluster's (kClu) or, for a lane of one CTA, the
// CTA's own, whose exchanges are CTA barriers
template <bool kClu>
__device__ auto make_helper(unsigned char* smem_raw, const Layout& L, int Z) {
  if constexpr (kClu)
    return Cluster(reinterpret_cast<unsigned*>(smem_raw + L.blk),
                   reinterpret_cast<uint4*>(smem_raw + L.xbuf),
                   reinterpret_cast<unsigned*>(smem_raw + L.zbuf),
                   reinterpret_cast<unsigned*>(smem_raw + L.zt),
                   reinterpret_cast<unsigned long long*>(smem_raw + L.mb),
                   reinterpret_cast<unsigned*>(smem_raw + L.cols),
                   reinterpret_cast<int*>(smem_raw + L.zd), Z);
  else
    return Block(reinterpret_cast<unsigned*>(smem_raw + L.blk));
}

// This CTA's nodes [s0, s1) sorted by zone (keyless nodes, key Z, last),
// node order kept within a zone, into its positions [s0, s1): perm[q] the
// node and skey[q] its key. A counting sort over the Z + 1 keys: each warp
// counts each key over its threads' nodes (a ballot a node slot), one warp
// scans the counts in (key, warp) order, and a node's position is its
// key's and warp's offset plus the nodes of its key before it in the warp.
// `wt` holds (Z + 1) x warps words. Three CTA barriers, once a launch.
__device__ void sort_slice(const ConLane& L, int* perm, int* skey, unsigned* wt, int Z, int K,
                           int n0, int n1, int s0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  auto key_of = [&](int i) {
    const int n = n0 + i;
    return n < n1 ? (L.zval(n) ? L.zone_of(n) : Z) : -1;
  };
  for (int v = 0; v <= Z; ++v) {
    unsigned c = 0u;
    for (int i = 0; i < K; ++i) c += __popc(__ballot_sync(kFullMask, key_of(i) == v));
    if (lane == 0) wt[v * nw + warp] = c;
  }
  __syncthreads();
  if (warp == 0) {  // the exclusive scan in (key, warp) order
    const int len = (Z + 1) * nw;
    unsigned carry = 0u;
    for (int base = 0; base < len; base += 32) {
      const unsigned x = base + lane < len ? wt[base + lane] : 0u;
      const unsigned inc = warp_incl(x, lane);
      if (base + lane < len) wt[base + lane] = carry + inc - x;
      carry += __shfl_sync(kFullMask, inc, 31);
    }
  }
  __syncthreads();
  for (int v = 0; v <= Z; ++v) {
    unsigned pos = wt[v * nw + warp];
    for (int i = 0; i < K; ++i) pos += __popc(__ballot_sync(kFullMask, key_of(i) == v) & below);
    for (int i = 0; i < K; ++i)
      if (key_of(i) == v) {
        perm[s0 + pos] = n0 + i;
        skey[s0 + pos] = v;
        ++pos;
      }
  }
  __syncthreads();
}

template <bool kSmem, bool kClu>
__global__ void __launch_bounds__(kConThreads, 1)
constrained_kernel(Params p, int B, int G, int N, int R, int Z, int max_waves, int Ns,
                   int place) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int CS = 1, rank = 0;
  if constexpr (kClu) {
    CS = static_cast<int>(cooperative_groups::this_cluster().num_blocks());
    rank = static_cast<int>(cooperative_groups::this_cluster().block_rank());
  }
  const int b = blockIdx.x / CS;
  // an inactive lane of `place`: every CTA of its cluster leaves here,
  // before any barrier
  const unsigned char* active = static_cast<const unsigned char*>(p.ptr[kActive]);
  if (place && active != nullptr && active[b] == 0) return;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const Layout L = layout(Ns, R, Z, CS, T >> 5, kSmem);
  auto clu = make_helper<kClu>(smem_raw, L, Z);
  int* zone_placed = reinterpret_cast<int*>(smem_raw + L.zp);
  int* czb_s = reinterpret_cast<int*>(smem_raw + L.czb);
  int* ezb_s = reinterpret_cast<int*>(smem_raw + L.ezb);
  int* req_s = reinterpret_cast<int*>(smem_raw + L.req);
  unsigned* mul_s = reinterpret_cast<unsigned*>(smem_raw + L.mul);
  int* sh_s = reinterpret_cast<int*>(smem_raw + L.sh);

  // this CTA's slice [s0, s1) and this thread's nodes [n0, n1)
  const int s0 = min(rank * Ns, N);
  const int s1 = min(s0 + Ns, N);
  const int K = (Ns + T - 1) / T;
  const int n0 = min(s0 + tid * K, s1);
  const int n1 = min(n0 + K, s1);

  const size_t NR = static_cast<size_t>(N) * R;
  int* fout = static_cast<int*>(const_cast<void*>(p.ptr[kFreeOut])) + b * NR;
  int* placed_out = static_cast<int*>(const_cast<void*>(p.ptr[kPlaced]));
  int* scratch = static_cast<int*>(const_cast<void*>(p.ptr[kScratch])) +
                 (kSmem ? 0 : static_cast<size_t>(b) * 4 * N);
  const int* fin = at<int>(p, kFreeIn, b);
  const int* zcl_g = at<int>(p, kZcl, b);
  const unsigned char* zval_g = at<unsigned char>(p, kZval, b);

  ConLane lane;
  lane.R = R;
  lane.Z = Z;
  int* fit;
  int* perm;
  int* skey;
  if (kSmem) {
    lane.plane = shifted<int>(smem_raw, L.plane, 0);
    lane.plane -= s0;  // [R][Ns]: node n at column n - s0
    lane.sn = 1;
    lane.sr = Ns;
    fit = shifted<int>(smem_raw, L.fit, s0);
    lane.fc = shifted<int>(smem_raw, L.fc, s0);
    int* zcl_s = shifted<int>(smem_raw, L.zcl, s0);
    unsigned char* zval_s = shifted<unsigned char>(smem_raw, L.zval, s0);
    for (int n = n0; n < n1; ++n) {
      for (int r = 0; r < R; ++r) lane.F(n, r) = fin[static_cast<size_t>(n) * R + r];
      zcl_s[n] = zcl_g[n];
      zval_s[n] = zval_g[n];
    }
    lane.zcl = zcl_s;
    lane.zval_ = zval_s;
    perm = shifted<int>(smem_raw, L.perm, s0);
    skey = shifted<int>(smem_raw, L.skey, s0);
  } else {
    lane.plane = fout;
    lane.sn = R;
    lane.sr = 1;
    fit = scratch;
    lane.fc = scratch + N;
    perm = scratch + 2 * static_cast<size_t>(N);
    skey = scratch + 3 * static_cast<size_t>(N);
    for (int n = n0; n < n1; ++n)
      for (int r = 0; r < R; ++r) fout[static_cast<size_t>(n) * R + r] = fin[static_cast<size_t>(n) * R + r];
    lane.zcl = zcl_g;
    lane.zval_ = zval_g;
  }
  sort_slice(lane, perm, skey, reinterpret_cast<unsigned*>(smem_raw + L.cols), Z, K, n0, n1,
             s0);
  // every CTA of the cluster has started (and set up its mbarriers)
  // before any CTA stores into another's shared memory
  clu.init();
  clu.sync_all();

  const int* order = static_cast<const int*>(p.ptr[kOrder]);
  unsigned long long* wave_counter =
      static_cast<unsigned long long*>(const_cast<void*>(p.ptr[kWaves]));
  unsigned long long lane_waves = 0;

  // the next group's index is read a group ahead: a group's scalars then
  // wait for one load, not two
  int g_next = G > 0 ? order[0] : 0;
  for (int it = 0; it < G; ++it) {
    const int g = g_next;
    if (it + 1 < G) g_next = order[it + 1];
    const long long gn = static_cast<long long>(g) * N;
    int* prow = placed_out + (static_cast<size_t>(b) * G + g) * N;
    const unsigned char* feas_g = at<unsigned char>(p, kFeas, b, gn);
    const int cnt = *at<int>(p, kWant, b, g);
    const bool lim = *at<unsigned char>(p, kLimit, b, g) != 0;
    const int s_kind = *at<int>(p, kSKind, b, g);
    const int a_kind = *at<int>(p, kAKind, b, g);
    const bool anti = *at<unsigned char>(p, kAnti, b, g) != 0;
    const bool con = place || s_kind > 0 || a_kind > 0 || anti;

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
    lane.rq = rq;
    lane.mu = mu;
    lane.sh = sh;
    lane.P = kSmem ? shifted<int>(smem_raw, L.placed, s0) : prow;
    if (kSmem) {
      // the group's rows of this thread's nodes (each thread reads only its
      // own nodes' rows: no barrier)
      unsigned char* feas_s = shifted<unsigned char>(smem_raw, L.feas, s0);
      for (int n = n0; n < n1; ++n) feas_s[n] = feas_g[n];
      lane.feas_ = feas_s;
      if (con) {
        const int* s_cnt_g = at<int>(p, kSCnt, b, gn);
        const unsigned char* s_elig_g = at<unsigned char>(p, kSElig, b, gn);
        const unsigned char* a_ok_g = at<unsigned char>(p, kAOk, b, gn);
        int* s_cnt_s = shifted<int>(smem_raw, L.s_cnt, s0);
        unsigned char* s_elig_s = shifted<unsigned char>(smem_raw, L.s_elig, s0);
        unsigned char* a_ok_s = shifted<unsigned char>(smem_raw, L.a_ok, s0);
        for (int n = n0; n < n1; ++n) {
          s_cnt_s[n] = s_cnt_g[n];
          s_elig_s[n] = s_elig_g[n];
          a_ok_s[n] = a_ok_g[n];
        }
        lane.s_cnt_ = s_cnt_s;
        lane.s_elig_ = s_elig_s;
        lane.a_ok_ = a_ok_s;
      }
    } else {
      lane.feas_ = feas_g;
      lane.s_cnt_ = at<int>(p, kSCnt, b, gn);
      lane.s_elig_ = at<unsigned char>(p, kSElig, b, gn);
      lane.a_ok_ = at<unsigned char>(p, kAOk, b, gn);
    }
    if (con) {
      for (int n = n0; n < n1; ++n) lane.P[n] = 0;
      clu.zone_reset(zone_placed, Z);
      for (int z = tid; z < Z; z += T) {
        czb_s[z] = at<int>(p, kCzb, b, static_cast<long long>(g) * Z)[z];
        ezb_s[z] = at<unsigned char>(p, kEzb, b, static_cast<long long>(g) * Z)[z];
      }
    }
    __syncthreads();  // the request codes and the zone arrays

    if (!con) {  // the one-shot first fit (ops/pack.pack_groups' arithmetic)
      unsigned tsum = 0;
      for (int n = n0; n < n1; ++n) {
        int c = lane.feas(n) ? lane.raw_fit(n) : 0;
        if (lim) c = min(c, 1);
        c = min(c, cnt);
        fit[n] = c;
        tsum += static_cast<unsigned>(c);
      }
      unsigned total;
      unsigned ex = clu.excl(tsum, total);
      for (int n = n0; n < n1; ++n) {
        const int c = fit[n];
        const int place = min(max(wsub(cnt, static_cast<int>(ex)), 0), c);
        ex += static_cast<unsigned>(c);
        prow[n] = place;
        if (place != 0) lane.take(n, place);
      }
      continue;
    }

    // the fit cache of this group, then the wave placer
    for (int n = n0; n < n1; ++n) lane.fc[n] = lane.feas(n) ? lane.raw_fit(n) : 0;
    const WaveGroup wg{cnt,
                       lim,
                       s_kind,
                       *at<int>(p, kSSkew, b, g),
                       *at<unsigned char>(p, kSSelf, b, g) != 0,
                       a_kind,
                       *at<unsigned char>(p, kASelf, b, g) != 0,
                       *at<unsigned char>(p, kAAny, b, g) != 0,
                       anti,
                       *at<int>(p, kMhb, b, g)};
    const int waves = place_waves(clu, lane, wg, N, Z, n0, n1, s0, s1, max_waves, fit,
                                  zone_placed, czb_s, ezb_s, perm, skey);
    if (kSmem)
      for (int n = n0; n < n1; ++n) prow[n] = lane.P[n];
    lane_waves += static_cast<unsigned long long>(waves);
  }

  if (kSmem)
    for (int n = n0; n < n1; ++n)
      for (int r = 0; r < R; ++r) fout[static_cast<size_t>(n) * R + r] = lane.F(n, r);
  if (tid == 0 && rank == 0 && lane_waves > 0) atomicAdd(wave_counter, lane_waves);
  // every store into another CTA's shared memory came before a cluster
  // barrier every CTA passed: a CTA may leave
}

// Per device: the opt-in shared-memory limit, the SM count, whether
// clusters above 8 are allowed per instance, the dynamic shared memory each
// instance's attribute allows so far, and the largest cluster the card
// schedules at the last (threads, shared memory) asked.
constexpr int kMaxDevices = 64;
struct Cached {
  int max_smem, sms;
  size_t allowed[4];
  bool nonportable[4];
  int ask_threads;
  size_t ask_smem;
  int ask_cluster;
};
std::mutex g_mu;
Cached g_cached[kMaxDevices];

using KernelFn = void (*)(Params, int, int, int, int, int, int, int, int);
// [slices in shared memory][a cluster of more than one CTA]
const KernelFn kKernels[2][2] = {{constrained_kernel<false, false>, constrained_kernel<false, true>},
                                 {constrained_kernel<true, false>, constrained_kernel<true, true>}};

cudaLaunchConfig_t launch_config(int grid, int CS, int threads, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(CS);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the attributes of instance [smem_plane][clu] for `smem` bytes and
// clusters above 8, set once
cudaError_t allow(Cached& c, int smem_plane, int clu, size_t smem) {
  cudaError_t err;
  const KernelFn fn = kKernels[smem_plane][clu];
  const int inst = smem_plane * 2 + clu;
  if (smem > c.allowed[inst]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    c.allowed[inst] = smem;
  }
  if (!c.nonportable[inst]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    c.nonportable[inst] = true;
  }
  return cudaSuccess;
}

struct Launch {
  int cluster, threads, smem_plane, ns;
  size_t smem;
};

inline int con_threads(int Ns) {
  int t = ((Ns + 31) / 32) * 32;
  return t < 32 ? 32 : (t > kConThreads ? kConThreads : t);
}

// The cluster size, threads, placement and shared memory of a launch of B
// lanes at (N, R, Z); sets the kernel's attributes as needed. `cluster` 0
// chooses CS (the largest power of two up to 16, or 8 where the card
// cannot schedule 16, with B x CS within the SMs and at least kMinSlice
// nodes a CTA), 1 to 16 forces it; `placement` 0 chooses shared memory
// where the slices fit, 1 forces device memory, 2 shared memory.
cudaError_t prepare(int B, int N, int R, int Z, int cluster, int placement, Launch* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (B < 0 || N <= 0 || R <= 0 || Z <= 0 || R > 32 || Z > kConThreads || cluster < 0 ||
      cluster > kMaxCluster || placement < 0 || placement > 2)
    return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(g_mu);
  Cached& c = g_cached[dev];
  if (c.max_smem == 0) {
    err = cudaDeviceGetAttribute(&c.max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const size_t max_smem = static_cast<size_t>(c.max_smem);
  int CS = cluster;
  if (CS == 0) {
    // one CTA a lane where its threads cover the lane at 2 nodes a thread
    // (a cluster's exchanges cost more than such a wave's work)
    CS = 1;
    while (N > 2 * kConThreads && CS < kMaxCluster &&
           static_cast<long long>(B) * CS * 2 <= c.sms && N >= CS * 2 * kMinSlice)
      CS *= 2;
  }
  auto shape = [&](int cs, int& ns, int& threads) {
    ns = (N + cs - 1) / cs;
    threads = con_threads(ns);
  };
  int ns, threads;
  shape(CS, ns, threads);
  if (cluster == 0 && CS == kMaxCluster) {
    // can the card schedule a cluster of 16 at this size? (read once per
    // (threads, shared memory))
    const size_t meta = layout(ns, R, Z, CS, threads >> 5, false).end;
    if (c.ask_cluster == 0 || c.ask_threads != threads || c.ask_smem != meta) {
      int active = 0;
      if (meta <= max_smem) {
        err = allow(c, 0, 1, meta);
        if (err != cudaSuccess) return err;
        cudaLaunchAttribute attr;
        cudaLaunchConfig_t cfg = launch_config(CS, CS, threads, meta, nullptr, &attr);
        if (cudaOccupancyMaxActiveClusters(&active, kKernels[0][1], &cfg) != cudaSuccess) {
          (void)cudaGetLastError();  // a size the card refuses: not an error of the launch
          active = 0;
        }
      }
      c.ask_cluster = active >= 1 ? kMaxCluster : kPortableCluster;
      c.ask_threads = threads;
      c.ask_smem = meta;
    }
    if (c.ask_cluster != CS) {
      CS = c.ask_cluster;
      shape(CS, ns, threads);
    }
  }
  const size_t meta = layout(ns, R, Z, CS, threads >> 5, false).end;
  const size_t with = layout(ns, R, Z, CS, threads >> 5, true).end;
  if (meta > max_smem || (placement == 2 && with > max_smem)) return cudaErrorInvalidValue;
  out->cluster = CS;
  out->threads = threads;
  out->ns = ns;
  out->smem_plane = placement == 2 || (placement == 0 && with <= max_smem);
  out->smem = out->smem_plane ? with : meta;
  return allow(c, out->smem_plane, CS > 1, out->smem);
}

int launch_lanes(const void* const* ptrs, const long long* strides, int B, int G, int N, int R,
                 int Z, int max_waves, int cluster, int placement, int place, void* stream) {
  if (B <= 0) return 0;
  Launch l;
  cudaError_t err = prepare(B, N, R, Z, cluster, placement, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  for (int i = 0; i < kNumFields; ++i) {
    p.ptr[i] = ptrs[i];
    p.ls[i] = strides[i];
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(B * l.cluster, l.cluster, l.threads, l.smem,
                                               static_cast<cudaStream_t>(stream), &attr);
  int ns = l.ns;
  void* args[] = {&p, &B, &G, &N, &R, &Z, &max_waves, &ns, &place};
  err = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(kKernels[l.smem_plane][l.cluster > 1]), args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// What a launch of B lanes at (N, R, Z) would use on the current device:
// out[0] the cluster size CS, out[1] the threads of a CTA, out[2] the bytes
// of dynamic shared memory, out[3] 1 where the slices are in shared memory
// (0: device memory, scratch [B, 4, N] needed), out[4] the nodes of a CTA's
// slice. Returns a CUDA
// error code.
extern "C" int ka_constrained_config(int B, int N, int R, int Z, int cluster, int placement,
                                     int* out) {
  Launch l;
  const cudaError_t err = prepare(B, N, R, Z, cluster, placement, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = l.cluster;
  out[1] = l.threads;
  out[2] = static_cast<int>(l.smem);
  out[3] = l.smem_plane;
  out[4] = l.ns;
  return 0;
}

// B lanes, each its G groups in `order` (pack_lanes).
extern "C" int ka_constrained(const void* const* ptrs, const long long* strides, int B, int G,
                              int N, int R, int Z, int max_waves, int cluster, int placement,
                              void* stream) {
  return launch_lanes(ptrs, strides, B, G, N, R, Z, max_waves, cluster, placement, 0, stream);
}

// B lanes, each one group by waves (place_lanes): `order` is {0}, `active`
// (u8[B], or null for every lane) picks the lanes that run.
extern "C" int ka_constrained_place(const void* const* ptrs, const long long* strides, int B,
                                    int N, int R, int Z, int max_waves, int cluster,
                                    int placement, void* stream) {
  return launch_lanes(ptrs, strides, B, 1, N, R, Z, max_waves, cluster, placement, 1, stream);
}
