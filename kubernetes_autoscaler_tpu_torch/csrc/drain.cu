// The drain sweep, hand-written for Hopper (sm_90a): every candidate node's
// removal simulated in one launch, one CTA a candidate.
//
// Replaces XLA code with no pallas_call: the reference's per-candidate
// program in kubernetes_autoscaler_tpu/ops/drain.py:232-347 (`one_candidate`:
// the window gather, the compaction into K group slots, the `lax.scan` of
// the K-step first fit at :312-325 and the per-pod destinations by
// `searchsorted`), run under `lax.map(vmap(...))` at :352, and its reason
// pass at :438-492 (`_failure_reasons_jit`, the same scan at :473 under the
// map at :492). For candidate c, as ops/kernels/drain_kernel.sweep_plain
// computes it:
//   window   the MPN places of pad_order from starts[c]; a place is on c
//            when its pod is valid and sits on c; movable and blocker from
//            the pod's flags
//   compact  the movable pods' groups in group-index order, the first K of
//            them a slot each (gidx, cnt_k); groups beyond K never place
//   fit      slot j of group g with want = cnt_k[j], per node n in order:
//            min over r with req[g,r] > 0 of max(free[n,r], 0) / req[g,r]
//            (BIG = 2^30 without one), 0 unless feas[g,n], dest_ok[n] and
//            n != c, at most 1 with limit_one[g], at most want;
//            place = clip(want - exclusive_prefix(fit), 0, fit); free[n]
//            -= place * req[g] for the later slots
//   outputs  n_moved, n_failed, drainable, has_blocker, and per window
//            place the first node where its group's cumulative placement
//            reaches its rank among the group's pods + 1 (-1 where it does
//            not, or the group overflowed K), and the pod's index (-1 off
//            c); or, explaining, the reason code, the first group with
//            unplaced pods and the unplaced count.
// The topology mode (`Z` > 0: ops/drain.simulate_removals with
// constraints) is the reference's per-candidate program with constraints,
// drain.py:195-219 (the candidate-independent preparation, done by the
// wrapper) and :257-309. For the slot of group g of candidate c:
//   ghost    g's zone totals of anti-affinity, affinity, spread and
//            eligible nodes, less what c holds in its own zone ([Z] values
//            in shared memory, per slot; no [C, Z] or [C, N] plane)
//   gate     feas[g, n] also needs the zone gate: no adjusted anti-affinity
//            count in n's zone, and for a non-self zone affinity an
//            adjusted affinity count there
//   route    a group with a spread, an affinity or anti-self-zone
//            re-places by waves (`place_waves`, csrc/waves.cuh: the
//            reference's `lax.cond(is_con[g], slow, fast)`), its rows of
//            the constraint planes read by group index; any other takes
//            the first fit above
// and the waved slot's runs are its per-node totals after its last wave,
// in node order.
// All arithmetic is int32 with the plain version's wrap-around, so the
// result is byte-equal to the plain version, not close to it.
//
// What bounds it. Not bytes: the outputs are 2 x C x MPN int32 (5 MB at
// C = 5,120, MPN = 128) and the shared inputs (the free plane, 164 KB at
// N = 5,120, R = 8; the predicate plane, 328 KB at G = 64) stay in the
// 50 MB L2 across candidates. The reference's scan costs K x N x R fit
// operations a candidate (671 M a candidate row at [main]'s widths, over
// 5,120 candidates); the data needs far fewer, since a slot is done at the
// node where its running fit reaches its count. The plain version pays the
// K x N x R plane in device memory (a [C, N, R] int32 plane of 210 MB a
// chunk rewritten every slot) and ≈ 1,300 small launches a sweep.
//
// The design. A pre-pass (its own launch from the same C entry) builds the
// candidate-independent fit plane fit0[g, n] = feas[g, n] && dest_ok[n] ?
// min(fit_count(free[n], req[g]), MPN) : 0 as u16 [G, N rounded up to 8]
// (655 KB at G = 64, N = 5,120: it stays in the L2). A slot's want is at
// most MPN, so min(fit0, want) is min(fit_count, want) on every node the
// candidate has not debited; a node it has debited is recomputed from the
// shared plane less its debit row, and n != c, the zone gate, limit_one and
// want apply per candidate after. Then one CTA of 256 threads (more only
// for a window of more than 256 places) runs one candidate to its end: the
// window, one place a thread; the compaction in shared memory over the
// movable pods only (O(movable^2) compares, as the reference's tril
// count); then the slots in turn, each sweeping the nodes in tiles of 8
// nodes a thread (one 16-byte load of the plane row and one of the debit
// index) with one block-wide exclusive scan a tile (one barrier,
// double-buffered warp totals), stopping after the tile where the running
// fit reaches the slot's count: a slot that fits nowhere reads 10 KB, not
// the 164 KB of free rows. The free plane is never copied: a candidate
// changes free capacity only where it places its own pods, at most MPN
// nodes, so a node's free row is the shared plane read through the
// read-only cache less the candidate's debit row for that node, kept in
// shared memory (a u16 node -> debit-row index, 2N bytes, and at most MPN
// rows). Each
// placement is recorded as a run (node, slot, its rank interval
// [exclusive prefix, + place)) in shared memory, and a window place finds
// its destination as the run of its slot whose interval holds its rank: no
// [C, N] placement curve and no searchsorted. A node of a slot belongs to
// one thread, so its debit row needs no atomic; rows and runs are taken
// with shared-memory atomics on two counters.
// The topology mode keeps that view for the waves: a candidate places at
// most its own MPN pods, so however many waves a slot runs it touches at
// most MPN nodes, and the slot's placed count of a node (for limit_one and
// the spread counts) sits beside the node's debit row. Its waves take the
// thread's contiguous nodes [tK, tK + K), K = ceil(N / threads), a fit row
// of N int32 in shared memory (20 KB at N = 5,120), and the zone-sorted
// permutation of the nodes, one row every candidate shares, from the
// wrapper; a wave's fit_count reads the fit plane where the node has no
// debit row. The unconstrained sweep is the other instance of the
// template and runs none of it. Each mode has an instance bounded at 256
// threads (the usual window), which leaves the waves their registers, and
// one at 1,024 for larger windows.
//
// Contract (checked by the Python wrapper): int32 and uint8 (bool)
// contiguous tensors; fit0 a u16 [G, N rounded up to 8] scratch the
// pre-pass fills; candidates [C] in [0, N); starts [N]; pad_order
// [P + MPN]; node_idx, group_ref, valid, movable, blocks [P]; free [N, R];
// feas [G, N]; dest_ok [N]; limit_one [G]; req [G, R]; outputs [C] each
// and dest_node, pod_slot [C, MPN]; `nodes` a u64 counter that each
// candidate adds the nodes its slots' first fits needed to (a slot that
// places its count: up to the node where the running fit reaches it; one
// that does not: all N). A movable pod's group must lie in [0, G) (the
// kernel leaves any other pod unmovable). The topology mode also takes
// zone_cl (clipped to [0, Z)) and zone_valid [N]; s_kind, s_skew, s_self,
// a_kind, a_self, a_any, anti_self_zone [G]; spread_cnt, aff_cnt,
// anti_zone_cnt and s_elig [G, N]; the zone totals anti_zone, aff_zone,
// cnt_zone and elig_zone [G, Z]; perm and skey [N] (the nodes sorted by
// zone, keyless last, and their keys); and `waves`, two u64 counters that
// each candidate adds its slots' waves and its waved slots to. Launches on
// the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <mutex>

#include "pack_row.cuh"
#include "waves.cuh"

namespace {

using namespace ka;

enum Field {
  kCand, kStarts, kPadOrder, kNodeIdx, kGroupRef, kValid, kMovable, kBlocks, kFree, kFeas,
  kDestOk, kLimit, kReq, kOut0, kOut1, kOut2, kOut3, kDest, kPodSlot, kNodes,
  // the topology mode's
  kZcl, kZval, kSKind, kSSkew, kSSelf, kAKind, kASelf, kAAny, kAnti, kSCnt, kAffCnt, kAntiCnt,
  kSElig, kAntiZone, kAffZone, kCntZone, kEligZone, kPerm, kSkey, kWaves,
  // the fit plane's scratch
  kFit0, kNumFields
};

struct Params {
  const void* ptr[kNumFields];
};

// ops/kernels/drain_kernel.DRAIN_*
constexpr int kReasonOk = 0;
constexpr int kReasonBlocked = 1;
constexpr int kReasonNoPlace = 2;
constexpr int kReasonTooMany = 3;

constexpr int kNodesPerThread = 8;  // one 16-byte load of u16 fits
constexpr int kDrainThreads = 256;

// indices into the shared scalar block
enum Misc { kRuns, kRows, kCross, kNumMisc };

// byte offsets of the shared-memory arrays
struct Layout {
  size_t scan, misc, req, mul, sh, gidx, cnt, placed, mg, mb, mj, cidx, rnode, rlo, rhi, rslot,
      debit, idx, blk, zone, splaced, fit, end;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// N rounded up to a whole 16-byte load of u16 values
__host__ __device__ inline int padded(int N) { return (N + 7) & ~7; }

// u16 value i (0..7, a constant once unrolled) of a 16-byte load
__device__ __forceinline__ int half16(const uint4& v, int i) {
  const unsigned w = i < 2 ? v.x : (i < 4 ? v.y : (i < 6 ? v.z : v.w));
  return static_cast<int>((w >> ((i & 1) * 16)) & 0xffffu);
}

// Z > 0: the topology mode's arrays too
__host__ __device__ inline Layout layout(int N, int R, int MPN, int K, int Z) {
  const size_t r4 = static_cast<size_t>(R) * 4, k4 = static_cast<size_t>(K) * 4,
               m4 = static_cast<size_t>(MPN) * 4;
  Layout l;
  l.scan = 0;                     // u32 [2][32] warp totals, double-buffered
  l.misc = l.scan + 2 * 32 * 4;   // i32 [kNumMisc]
  l.req = l.misc + 4 * 4;         // i32 [R] the slot's request
  l.mul = l.req + r4;             // u32 [R] its multipliers
  l.sh = l.mul + r4;              // i32 [R] its shift codes
  l.gidx = l.sh + r4;             // i32 [K] group of each slot
  l.cnt = l.gidx + k4;            // i32 [K] pods of each slot
  l.placed = l.cnt + k4;          // i32 [K] pods each slot placed
  l.mg = l.placed + k4;           // i32 [MPN] group of each movable pod
  l.mb = l.mg + m4;               // i32 [MPN] its rank in its group
  l.mj = l.mb + m4;               // i32 [MPN] its slot (K: overflow)
  l.cidx = l.mj + m4;             // i32 [MPN] movable index of each place (-1)
  l.rnode = l.cidx + m4;          // i32 [MPN] node of each run
  l.rlo = l.rnode + m4;           // i32 [MPN] first rank it takes
  l.rhi = l.rlo + m4;             // i32 [MPN] one past its last rank
  l.rslot = l.rhi + m4;           // i32 [MPN] its slot
  l.debit = l.rslot + m4;         // i32 [MPN][R] debit rows
  l.idx = align16(l.debit + m4 * R);  // u16 [N] debit row + 1 of each node (0: none)
  l.end = align16(l.idx + static_cast<size_t>(padded(N)) * 2);
  l.blk = l.zone = l.splaced = l.fit = l.end;
  if (Z > 0) {
    l.blk = l.end;                                        // u32 [kBlockWords]
    l.zone = l.blk + kBlockWords * 4;                     // i32 [5][Z] the zone arrays
    l.splaced = l.zone + 5 * static_cast<size_t>(Z) * 4;  // i32 [MPN] slot's placed by row
    l.fit = align16(l.splaced + m4);                      // i32 [N] the waves' fit row
    l.end = l.fit + static_cast<size_t>(N) * 4;
  }
  return l;
}

// the CTA size for a window of MPN places: 256, or as many as cover a
// larger window (-1 beyond 1,024)
inline int drain_threads(int MPN) {
  if (MPN <= kDrainThreads) return kDrainThreads;
  const int t = ((MPN + 31) / 32) * 32;
  return t > kMaxThreads ? -1 : t;
}

// The topology mode's per-candidate state of one slot (group g): its zone
// arrays in shared memory, and its rows of the constraint planes.
struct Topo {
  const int* zcl;              // [N] zone id, clipped
  const unsigned char* zval;   // [N] the node has a zone
  int Z;
  const int* anti_adj;         // [Z] g's anti-affinity counts, c's residents out
  const int* aff_adj;          // [Z] g's affinity counts, c's residents out
  bool aff2;                   // zone affinity to others: the gate needs aff_adj

  __device__ int zone_of(int n) const { return min(max(zcl[n], 0), Z - 1); }
  // the zone gate of g at node n with c drained
  __device__ bool gate(int n) const {
    const bool zv = zval[n] != 0;
    const int z = zone_of(n);
    return !(zv && anti_adj[z] > 0) && (!aff2 || (zv && aff_adj[z] > 0));
  }
};

// One (candidate, slot) lane as csrc/waves.cuh's `place_waves` sees it: the
// shared free plane less the candidate's debit rows, the slot's placed
// count of a node beside the node's debit row, and the group's rows.
struct DrainLane {
  const int* free0;
  const unsigned short* fit0;  // the group's row of the fit plane
  int* debit;
  unsigned short* idx;
  int* splaced;   // [MPN] the slot's placed count by debit row
  int* rows;      // the rows taken so far
  int R, c;
  const int* s_req;
  const unsigned* s_mul;
  const int* s_sh;
  const unsigned char* frow;
  const unsigned char* dest_ok;
  Topo t;
  int a_kind;
  const int* s_cnt_;
  const unsigned char* s_elig_;
  const int* aff_cnt;

  __device__ bool feas(int n) const { return n != c && dest_ok[n] && frow[n] && t.gate(n); }
  // per requested resource max(free, 0) / req, the BIG of ops/pack for a
  // resource the group does not request; capped at MPN (the fit plane)
  // where the node has no debit row, which no wave's min with rem (at most
  // MPN) can tell apart
  __device__ int fit_count(int n) const {
    const int e = static_cast<int>(idx[n]) - 1;
    if (e < 0) return fit0[n];
    const int* __restrict__ frw = free0 + static_cast<size_t>(n) * R;
    unsigned fc = UINT_MAX;
    for (int r = 0; r < R; ++r) {
      const int s = s_sh[r];
      unsigned q = static_cast<unsigned>(kBig);
      if (s != kNoLimit) {
        q = quotient(wsub(__ldg(frw + r), debit[e * R + r]), s_mul[r], s);
      }
      fc = min(fc, q);
    }
    return static_cast<int>(fc);
  }
  __device__ int placed(int n) const {
    const int e = static_cast<int>(idx[n]) - 1;
    return e >= 0 ? splaced[e] : 0;
  }
  __device__ void place(int n, int v) const {
    int row = static_cast<int>(idx[n]) - 1;
    if (row < 0) {
      row = atomicAdd(rows, 1);
      idx[n] = static_cast<unsigned short>(row + 1);
      for (int r = 0; r < R; ++r) debit[row * R + r] = mul_wrap(v, s_req[r]);
      splaced[row] = v;
    } else {
      for (int r = 0; r < R; ++r)
        debit[row * R + r] = wadd(debit[row * R + r], mul_wrap(v, s_req[r]));
      splaced[row] += v;
    }
  }
  __device__ int s_cnt(int n) const { return s_cnt_[n]; }
  __device__ bool s_elig(int n) const { return s_elig_[n] != 0 && n != c; }
  __device__ bool a_ok(int n) const {
    return a_kind == 1 ? aff_cnt[n] > 0 : (t.zval[n] != 0 && t.aff_adj[t.zone_of(n)] > 0);
  }
  __device__ bool zval(int n) const { return t.zval[n] != 0; }
  __device__ int zone_of(int n) const { return t.zone_of(n); }
};

template <typename T>
__device__ __forceinline__ const T* field(const Params& p, Field f) {
  return static_cast<const T*>(p.ptr[f]);
}

// The fit plane: fit0[g, n] = feas[g, n] && dest_ok[n] ? min(fit_count(
// free[n], req[g]), MPN) : 0, and 0 past N. One thread a node, a row of
// blocks a group.
__global__ void __launch_bounds__(256) fit_plane_kernel(const int* __restrict__ free0,
                                                        const unsigned char* __restrict__ feas,
                                                        const unsigned char* __restrict__ dest_ok,
                                                        const int* __restrict__ req,
                                                        unsigned short* fit0, int N, int R,
                                                        int MPN) {
  extern __shared__ int codes[];  // u32 [R] multipliers, i32 [R] shift codes
  unsigned* mu = reinterpret_cast<unsigned*>(codes);
  int* sh = codes + R;
  const int g = blockIdx.y;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    unsigned m;
    int s;
    divisor(req[static_cast<size_t>(g) * R + r], m, s);
    mu[r] = m;
    sh[r] = s;
  }
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int Np = padded(N);
  if (n >= Np) return;
  int v = 0;
  if (n < N && feas[static_cast<size_t>(g) * N + n] && dest_ok[n]) {
    unsigned q = static_cast<unsigned>(kBig);
    for (int r = 0; r < R; ++r) {
      const int s = sh[r];
      if (s != kNoLimit) q = min(q, quotient(free0[static_cast<size_t>(n) * R + r], mu[r], s));
    }
    v = min(static_cast<int>(q), MPN);
  }
  fit0[static_cast<size_t>(g) * Np + n] = static_cast<unsigned short>(v);
}

template <bool kTopo, int kMaxT>
__global__ void __launch_bounds__(kMaxT) drain_kernel(Params p, int N, int R, int G, int P,
                                                      int MPN, int K, int Z, int max_waves,
                                                      int explain) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(N, R, MPN, K, kTopo ? Z : 0);
  unsigned* s_scan = reinterpret_cast<unsigned*>(smem + L.scan);
  int* misc = reinterpret_cast<int*>(smem + L.misc);
  int* s_req = reinterpret_cast<int*>(smem + L.req);
  unsigned* s_mul = reinterpret_cast<unsigned*>(smem + L.mul);
  int* s_sh = reinterpret_cast<int*>(smem + L.sh);
  int* gidx = reinterpret_cast<int*>(smem + L.gidx);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);
  int* placed = reinterpret_cast<int*>(smem + L.placed);
  int* mg = reinterpret_cast<int*>(smem + L.mg);
  int* mb = reinterpret_cast<int*>(smem + L.mb);
  int* mj = reinterpret_cast<int*>(smem + L.mj);
  int* cidx = reinterpret_cast<int*>(smem + L.cidx);
  int* rnode = reinterpret_cast<int*>(smem + L.rnode);
  int* rlo = reinterpret_cast<int*>(smem + L.rlo);
  int* rhi = reinterpret_cast<int*>(smem + L.rhi);
  int* rslot = reinterpret_cast<int*>(smem + L.rslot);
  int* debit = reinterpret_cast<int*>(smem + L.debit);
  unsigned short* idx = reinterpret_cast<unsigned short*>(smem + L.idx);

  const int* __restrict__ cand = static_cast<const int*>(p.ptr[kCand]);
  const int* __restrict__ starts = static_cast<const int*>(p.ptr[kStarts]);
  const int* __restrict__ pad_order = static_cast<const int*>(p.ptr[kPadOrder]);
  const int* __restrict__ node_idx = static_cast<const int*>(p.ptr[kNodeIdx]);
  const int* __restrict__ group_ref = static_cast<const int*>(p.ptr[kGroupRef]);
  const unsigned char* __restrict__ valid = static_cast<const unsigned char*>(p.ptr[kValid]);
  const unsigned char* __restrict__ movable = static_cast<const unsigned char*>(p.ptr[kMovable]);
  const unsigned char* __restrict__ blocks = static_cast<const unsigned char*>(p.ptr[kBlocks]);
  const int* __restrict__ free0 = static_cast<const int*>(p.ptr[kFree]);
  const unsigned char* __restrict__ feas = static_cast<const unsigned char*>(p.ptr[kFeas]);
  const unsigned char* __restrict__ dest_ok = static_cast<const unsigned char*>(p.ptr[kDestOk]);
  const unsigned char* __restrict__ limit_one = static_cast<const unsigned char*>(p.ptr[kLimit]);
  const int* __restrict__ req = static_cast<const int*>(p.ptr[kReq]);
  const unsigned short* __restrict__ fit0 = static_cast<const unsigned short*>(p.ptr[kFit0]);
  const int Np = padded(N);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int ci = blockIdx.x;
  const int c = cand[ci];
  const bool c_ok = c >= 0 && c < N;

  for (int i = tid; i < Np; i += blockDim.x) idx[i] = 0;
  if (tid < kNumMisc) misc[tid] = 0;

  // 1. the window: one place a thread
  int slot = -1, g = G;
  bool on = false, mov = false, blk = false;
  if (tid < MPN && c_ok) {
    slot = pad_order[starts[c] + tid];
    if (slot >= 0 && slot < P) {
      on = node_idx[slot] == c && valid[slot];
      mov = on && movable[slot];
      blk = on && blocks[slot];
      if (mov) {
        g = group_ref[slot];
        if (g < 0 || g >= G) mov = false;
      }
    }
  }
  if (!explain && tid < MPN)
    static_cast<int*>(const_cast<void*>(p.ptr[kPodSlot]))[static_cast<size_t>(ci) * MPN + tid] =
        on ? slot : -1;
  // the movable pods, compacted in window order
  const unsigned bal = __ballot_sync(kFullMask, mov);
  if (lane == 0) s_scan[warp] = static_cast<unsigned>(__popc(bal));
  const bool blocker = __syncthreads_or(blk) != 0;
  int before_w = 0, n_mov = 0;
  for (int w = 0; w < nwarps; ++w) {
    const int v = static_cast<int>(s_scan[w]);
    if (w < warp) before_w += v;
    n_mov += v;
  }
  if (tid < MPN) {
    const int m = mov ? before_w + __popc(bal & ((1u << lane) - 1u)) : -1;
    cidx[tid] = m;
    if (mov) mg[m] = g;
  }
  __syncthreads();

  // 2. the compaction: each movable pod's rank in its group and count of
  // its group, then its group's rank among the groups present
  int my_g = G, my_before = 0, my_cnt = 0;
  if (tid < n_mov) {
    my_g = mg[tid];
    for (int q = 0; q < n_mov; ++q)
      if (mg[q] == my_g) {
        ++my_cnt;
        if (q < tid) ++my_before;
      }
    mb[tid] = my_before;
  }
  __syncthreads();
  if (tid < n_mov) {
    int rank = 0;
    for (int q = 0; q < n_mov; ++q)
      if (mb[q] == 0 && mg[q] < my_g) ++rank;
    mj[tid] = rank < K ? rank : K;
    if (my_before == 0 && rank < K) {
      gidx[rank] = my_g;
      cnt[rank] = my_cnt;
    }
  }
  const int n_groups = __syncthreads_count(tid < n_mov && my_before == 0);
  const int filled = n_groups < K ? n_groups : K;

  // the topology mode's arrays and the waves' node range [w0, w1)
  int* zone = reinterpret_cast<int*>(smem + L.zone);
  int *anti_adj = zone, *aff_adj = zone + Z, *czb = zone + 2 * Z, *ezb = zone + 3 * Z,
      *zone_placed = zone + 4 * Z;
  int* splaced = reinterpret_cast<int*>(smem + L.splaced);
  int* fit = reinterpret_cast<int*>(smem + L.fit);
  const int kw = (N + blockDim.x - 1) / blockDim.x;
  const int w0 = min(tid * kw, N);
  const int w1 = min(w0 + kw, N);
  Block wblk(reinterpret_cast<unsigned*>(smem + L.blk));
  unsigned long long lane_waves = 0, waved_slots = 0;  // thread 0's sums

  // 3. the K-step first fit, slot by slot
  unsigned long long needed = 0;  // thread 0's sum of the nodes the slots needed
  unsigned parity = 0;
  const int tile = blockDim.x * kNodesPerThread;
  for (int j = 0; j < filled; ++j) {
    const int gi = gidx[j];
    const int want = cnt[j];
    if (tid < R) {
      const int d = req[static_cast<size_t>(gi) * R + tid];
      unsigned m;
      int s;
      divisor(d, m, s);
      s_req[tid] = d;
      s_mul[tid] = m;
      s_sh[tid] = s;
    }
    const bool limit = limit_one[gi] != 0;
    const unsigned char* __restrict__ frow = feas + static_cast<size_t>(gi) * N;
    Topo topo{};
    bool waved = false;
    if constexpr (kTopo) {
      // the ghost node: g's zone totals less what c holds in its own zone
      const size_t gn = static_cast<size_t>(gi) * N;
      const int a_kind = field<int>(p, kAKind)[gi];
      waved = field<int>(p, kSKind)[gi] > 0 || a_kind > 0 || field<unsigned char>(p, kAnti)[gi];
      topo = Topo{field<int>(p, kZcl), field<unsigned char>(p, kZval), Z, anti_adj, aff_adj,
                  a_kind == 2 && !field<unsigned char>(p, kASelf)[gi]};
      if (tid < Z) {
        const size_t gz = static_cast<size_t>(gi) * Z + tid;
        const bool dz = tid == topo.zone_of(c) && topo.zval[c];
        anti_adj[tid] =
            wsub(field<int>(p, kAntiZone)[gz], dz ? field<int>(p, kAntiCnt)[gn + c] : 0);
        aff_adj[tid] = wsub(field<int>(p, kAffZone)[gz], dz ? field<int>(p, kAffCnt)[gn + c] : 0);
        czb[tid] = wsub(field<int>(p, kCntZone)[gz], dz ? field<int>(p, kSCnt)[gn + c] : 0);
        ezb[tid] = wsub(field<int>(p, kEligZone)[gz],
                        dz ? field<unsigned char>(p, kSElig)[gn + c] : 0) > 0;
        zone_placed[tid] = 0;
      }
      if (waved)
        for (int e = tid; e < misc[kRows]; e += blockDim.x) splaced[e] = 0;
    }
    __syncthreads();
    if constexpr (kTopo) {
      if (waved) {  // block-uniform: the wave placer, then the slot's runs
        const size_t gn = static_cast<size_t>(gi) * N;
        const DrainLane dl{free0, fit0 + static_cast<size_t>(gi) * Np, debit, idx, splaced,
                           &misc[kRows], R, c, s_req, s_mul, s_sh, frow, dest_ok, topo,
                           field<int>(p, kAKind)[gi],
                             field<int>(p, kSCnt) + gn, field<unsigned char>(p, kSElig) + gn,
                             field<int>(p, kAffCnt) + gn};
        const WaveGroup wg{want,
                           limit,
                           field<int>(p, kSKind)[gi],
                           field<int>(p, kSSkew)[gi],
                           field<unsigned char>(p, kSSelf)[gi] != 0,
                           dl.a_kind,
                           field<unsigned char>(p, kASelf)[gi] != 0,
                           field<unsigned char>(p, kAAny)[gi] != 0,
                           field<unsigned char>(p, kAnti)[gi] != 0,
                           kConBig};
        const int waves = place_waves(wblk, dl, wg, N, Z, w0, w1, 0, N, max_waves, fit,
                                      zone_placed, czb, ezb, field<int>(p, kPerm),
                                      field<int>(p, kSkey));
        // the runs: the slot's per-node totals in node order
        unsigned tsum = 0;
        for (int n = w0; n < w1; ++n) tsum += static_cast<unsigned>(dl.placed(n));
        unsigned total;
        int ex = static_cast<int>(wblk.excl(tsum, total));
        for (int n = w0; n < w1; ++n) {
          const int v = dl.placed(n);
          if (v > 0) {
            const int e = atomicAdd(&misc[kRuns], 1);
            rnode[e] = n;
            rlo[e] = ex;
            rhi[e] = ex + v;
            rslot[e] = j;
          }
          ex += v;
        }
        __syncthreads();  // the slot's runs and debit rows
        if (tid == 0) {
          placed[j] = static_cast<int>(total);
          lane_waves += static_cast<unsigned long long>(waves);
          ++waved_slots;
        }
        continue;
      }
    }
    int running = 0;
    const uint4* __restrict__ plane4 =
        reinterpret_cast<const uint4*>(fit0 + static_cast<size_t>(gi) * Np);
    const uint4* idx4 = reinterpret_cast<const uint4*>(idx);
    for (int base = 0; base < N && running < want; base += tile) {
      const int n0 = base + tid * kNodesPerThread;
      int f[kNodesPerThread];
      unsigned tsum = 0;
      uint4 pv = make_uint4(0u, 0u, 0u, 0u), iv = pv;
      if (n0 < N) {
        pv = __ldg(plane4 + n0 / kNodesPerThread);
        iv = idx4[n0 / kNodesPerThread];
      }
#pragma unroll
      for (int i = 0; i < kNodesPerThread; ++i) {
        const int n = n0 + i;  // past N: the plane and the index are 0 there
        int v = half16(pv, i);
        const int e = half16(iv, i) - 1;
        if (e >= 0) {  // a node this candidate debited: free less its debit row
          v = 0;
          if (dest_ok[n] && frow[n]) {
            unsigned q = static_cast<unsigned>(kBig);
            const int* __restrict__ frw = free0 + static_cast<size_t>(n) * R;
            for (int r = 0; r < R; ++r) {
              const int s = s_sh[r];
              if (s == kNoLimit) continue;
              q = min(q, quotient(wsub(__ldg(frw + r), debit[e * R + r]), s_mul[r], s));
            }
            v = static_cast<int>(q);
          }
        }
        if (v > 0) {
          bool ok = n != c;
          if constexpr (kTopo) ok = ok && topo.gate(n);
          if (!ok) v = 0;
          if (limit) v = min(v, 1);
          v = min(v, want);
        }
        f[i] = v;
        tsum += static_cast<unsigned>(v);
      }
      // block exclusive scan of the threads' sums: one barrier
      const unsigned inc = warp_incl(tsum, lane);
      unsigned* sb = s_scan + (parity++ & 1u) * 32;
      if (lane == 31) sb[warp] = inc;
      __syncthreads();
      const unsigned wv = lane < nwarps ? sb[lane] : 0u;
      const unsigned wi = warp_incl(wv, lane);
      const unsigned wbefore = __shfl_sync(kFullMask, wi - wv, warp);
      const unsigned total = __shfl_sync(kFullMask, wi, 31);
      int ex = running + static_cast<int>(wbefore + inc - tsum);
#pragma unroll
      for (int i = 0; i < kNodesPerThread; ++i) {
        const int n = n0 + i;
        const int v = f[i];
        const int place = min(max(want - ex, 0), v);
        if (place > 0) {
          const int e = atomicAdd(&misc[kRuns], 1);
          rnode[e] = n;
          rlo[e] = ex;
          rhi[e] = ex + place;
          rslot[e] = j;
          int row = static_cast<int>(idx[n]) - 1;
          if (row < 0) {
            row = atomicAdd(&misc[kRows], 1);
            idx[n] = static_cast<unsigned short>(row + 1);
            for (int r = 0; r < R; ++r) debit[row * R + r] = mul_wrap(place, s_req[r]);
          } else {
            for (int r = 0; r < R; ++r)
              debit[row * R + r] = wadd(debit[row * R + r], mul_wrap(place, s_req[r]));
          }
          if (ex + v >= want) misc[kCross] = n;  // the running fit reaches want here
        }
        ex += v;
      }
      running += static_cast<int>(total);
    }
    __syncthreads();  // the slot's runs, debit rows and crossing node
    if (tid == 0) {
      placed[j] = min(running, want);
      needed += running >= want ? static_cast<unsigned long long>(misc[kCross]) + 1ull
                                : static_cast<unsigned long long>(N);
    }
  }
  __syncthreads();  // placed[]

  // 4. the outputs
  if (tid == 0) {
    int n_moved = 0, first_fail = -1;
    for (int j = 0; j < filled; ++j) {
      n_moved += placed[j];
      if (first_fail < 0 && cnt[j] - placed[j] > 0) first_fail = j;
    }
    if (explain) {
      const int reason = blocker            ? kReasonBlocked
                         : first_fail >= 0  ? kReasonNoPlace
                         : n_groups > K     ? kReasonTooMany
                                            : kReasonOk;
      static_cast<int*>(const_cast<void*>(p.ptr[kOut0]))[ci] = reason;
      static_cast<int*>(const_cast<void*>(p.ptr[kOut1]))[ci] =
          first_fail >= 0 ? gidx[first_fail] : -1;
      static_cast<int*>(const_cast<void*>(p.ptr[kOut2]))[ci] = n_mov - n_moved;
    } else {
      const int n_failed = n_mov - n_moved;
      static_cast<unsigned char*>(const_cast<void*>(p.ptr[kOut0]))[ci] =
          !blocker && n_failed == 0;
      static_cast<unsigned char*>(const_cast<void*>(p.ptr[kOut1]))[ci] = blocker;
      static_cast<int*>(const_cast<void*>(p.ptr[kOut2]))[ci] = n_moved;
      static_cast<int*>(const_cast<void*>(p.ptr[kOut3]))[ci] = n_failed;
    }
    if (needed)
      atomicAdd(static_cast<unsigned long long*>(const_cast<void*>(p.ptr[kNodes])), needed);
    if (waved_slots) {
      unsigned long long* w = static_cast<unsigned long long*>(const_cast<void*>(p.ptr[kWaves]));
      atomicAdd(w, lane_waves);
      atomicAdd(w + 1, waved_slots);
    }
  }
  if (!explain && tid < MPN) {
    int d = -1;
    const int m = cidx[tid];
    if (m >= 0) {
      const int j = mj[m], b = mb[m];
      if (j < K && b < placed[j]) {
        const int n_runs = misc[kRuns];
        for (int e = 0; e < n_runs; ++e)
          if (rslot[e] == j && rlo[e] <= b && b < rhi[e]) {
            d = rnode[e];
            break;
          }
      }
    }
    static_cast<int*>(const_cast<void*>(p.ptr[kDest]))[static_cast<size_t>(ci) * MPN + tid] = d;
  }
}

}  // namespace

// Per device, read once: the opt-in shared-memory limit, and per instance
// the dynamic shared-memory size the kernel's attribute allows so far.
constexpr int kMaxDevices = 64;
static std::mutex g_mu;
static int g_max_smem[kMaxDevices];
static size_t g_allowed[kMaxDevices][4];

using DrainFn = void (*)(Params, int, int, int, int, int, int, int, int, int);
// [topology mode][wide: more than kDrainThreads threads]
static const DrainFn kDrainKernels[2][2] = {
    {drain_kernel<false, kDrainThreads>, drain_kernel<false, kMaxThreads>},
    {drain_kernel<true, kDrainThreads>, drain_kernel<true, kMaxThreads>}};

static int max_smem(int dev) {
  if (g_max_smem[dev] == 0 &&
      cudaDeviceGetAttribute(&g_max_smem[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return -1;
  return g_max_smem[dev];
}

// The CTA size of a launch at (N, R, MPN, K) on the current device, Z > 0
// in the topology mode with Z zones, or -1 when no launch fits (the window
// past 1,024 places, more zones or resources than threads, or the shared
// memory past the device's opt-in limit).
extern "C" int ka_drain_threads(int N, int R, int MPN, int K, int Z) {
  if (N <= 0 || R <= 0 || MPN <= 0 || K <= 0 || Z < 0) return -1;
  const int threads = drain_threads(MPN);
  if (threads < 0 || R > threads || Z > threads) return -1;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return -1;
  std::lock_guard<std::mutex> lock(g_mu);
  const int limit = max_smem(dev);
  if (limit < 0 || layout(N, R, MPN, K, Z).end > static_cast<size_t>(limit)) return -1;
  return threads;
}

// Two launches on the stream: the fit plane into `fit0`, then the sweep.
extern "C" int ka_drain(const void* const* ptrs, int C, int N, int R, int G, int P, int MPN, int K,
                        int Z, int max_waves, int explain, void* stream) {
  if (C <= 0) return 0;
  const int threads = drain_threads(MPN);
  if (N <= 0 || R <= 0 || G < 0 || P < 0 || MPN <= 0 || MPN > 0xffff || K <= 0 || Z < 0 ||
      threads < 0 || R > threads || Z > threads)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  Params p;
  for (int i = 0; i < kNumFields; ++i) p.ptr[i] = ptrs[i];
  const bool topo = Z > 0;
  const bool wide = threads > kDrainThreads;
  const DrainFn kernel = kDrainKernels[topo][wide];
  const size_t smem = layout(N, R, MPN, K, Z).end;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    const int limit = max_smem(dev);
    if (limit < 0 || smem > static_cast<size_t>(limit))
      return static_cast<int>(cudaErrorInvalidValue);
    size_t& allowed = g_allowed[dev][topo * 2 + wide];
    if (smem > 48 * 1024 && smem > allowed) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed = smem;
    }
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G > 0) {
    const dim3 grid(static_cast<unsigned>((padded(N) + 255) / 256), static_cast<unsigned>(G));
    fit_plane_kernel<<<grid, 256, 2 * static_cast<size_t>(R) * 4, st>>>(
        static_cast<const int*>(p.ptr[kFree]), static_cast<const unsigned char*>(p.ptr[kFeas]),
        static_cast<const unsigned char*>(p.ptr[kDestOk]), static_cast<const int*>(p.ptr[kReq]),
        static_cast<unsigned short*>(const_cast<void*>(p.ptr[kFit0])), N, R, MPN);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int z = topo ? Z : 0, waves = topo ? max_waves : 0;
  void* args[] = {&p, &N, &R, &G, &P, &MPN, &K, &z, &waves, &explain};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(static_cast<unsigned>(C)),
                         dim3(static_cast<unsigned>(threads)), args, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
