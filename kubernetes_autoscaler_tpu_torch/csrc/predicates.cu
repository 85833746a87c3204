// The predicate plane: for every (pod group g, node n), either whether no
// check asked for refuses the pair (bool[G, N]) or the refusal bits of those
// checks (uint16[G, N]).
//
// Replaces no Pallas kernel: XLA's fusion of the reference package's
// kubernetes_autoscaler_tpu/ops/predicates.py (`_any_eq` :89,
// `resources_fit` :97, `selector_match` :103-119, `taints_tolerated`
// :122-142, `ports_free` :145-152, `feasibility_mask` :270-288,
// `reason_mask` :295-325, `reason_mask_for_groups` :329-341), and of the
// resident self-anti-affinity term its callers AND into the plane
// (ops/schedule.py:72-74, ops/drain.py:187-191 and :426-428 there). Run
// eagerly, each step of the reference's loops over the padding dims is a
// launch over [G, N] or [G, N, K], ≈ 570 a plane at the default widths, and
// the resident term six more. This kernel is one C entry.
//
// Semantics, bit for bit those of the plain version
// (ops/kernels/predicate_kernel.py), checks as the caller selects them:
//   selector   every requirement with a non-zero alternative has one of its
//              non-zero alternatives among the node's label slots, and no
//              non-zero negative is among them (a 0 probe never matches);
//   taints     unless the group tolerates all, every taint whose exact hash
//              is non-zero is covered: a toleration's exact hash equals it,
//              or the taint's key hash is non-zero and a toleration's key
//              hash equals it;
//   ports      no non-zero port hash of the group is among the node's;
//   resources  req <= cap - alloc in every slot, the difference in wrapping
//              int32 (NodeTensors.free); slots 0..3 refuse with bits 0..3
//              (cpu, memory, ephemeral, pods), any later one with bit 4;
//   gates      the node is valid, ready and schedulable (bit 8), the group
//              valid (bit 9);
//   residents  (bool kind only, when the caller passes the resident pods)
//              not (anti_affinity_self[g] and a resident pod of g on n). A
//              pod counts where it is valid with node_idx in [0, N) and
//              group_ref in [0, G) once a negative group_ref has had G
//              added, as the reference's `.at[gr, ni].add` reads the index.
// Feasible is bits == 0 over the same checks. A row whose group_mask entry
// is 0 is written 0 in either kind.
//
// Design. The C entry enqueues, when residents are given, a memset of a
// uint32[ceil(G/32), N] word plane and a pre-pass, one thread a resident
// pod, that ORs bit g % 32 of word (g / 32, n) for a pod of an anti-affine
// group; then the plane kernel. A CTA of 512 threads (16 warps) takes a
// tile of 32 nodes and all the groups, in chunks of up to 64, so every node
// plane is read once (the first design staged each tile once per 8
// groups). A CTA's time is a chain of dependent steps at a few warps a
// scheduler, not bytes (tools/torch_pred_trace.py reads it by step), so
// each step is spread over the warps and written without serial loops over
// the padding widths:
//  1. Staging. Lanes 0..5 of warp 6 each issue one bulk copy
//     (cp.async.bulk on an mbarrier) of a node plane's contiguous [32,
//     width] slice of the tile, lanes 0..5 of warp 7 one of a group plane's
//     [64, width] slice of the chunk; the few bytes before the first and
//     after the last 16-byte boundary of a slice (none at the main path's
//     shapes) go by plain loads. Meanwhile the other threads load the node
//     gates, the group flags and the tile's resident words. No divide.
//  2. Once the group rows land (the node slices may still be in flight),
//     4 threads a group count the non-zero entries of a contiguous quarter
//     each of its selector row (alternatives, then negatives); the first
//     takes their places in the CTA's selector list with one shared-memory
//     atomic and each writes its quarter's there in row order, an
//     alternative with its term. A thread a group does the same for the
//     ports and flags a group with a non-zero toleration.
//  3. Once the nodes land, warps 0..7 hold 4 nodes each, 8 lanes a node, a
//     node's L label slots 8 a lane in registers (L = 64); for each listed
//     probe a lane makes 8 compares and one vote answers the 4 nodes (4
//     probes at once): bit u of a node's hit row is whether probe u is
//     among its labels. The same against the used ports. The tile's taint
//     slots u = j T + t become bits: whether each is active (a vote a
//     word), and, on warps 8..15, for each group with a toleration whether
//     each is inactive or tolerated (the zero taints skipped and the
//     compares made once a tile, not once a pair). Once, each node's free
//     capacity is written out in wrapping int32.
//  4. The pairs: lane j is node j of the tile and warp w takes the chunk's
//     groups w, w + 16, ..., 4 of them at once: flags, gates and the
//     resident bit first, then, for the pairs that need them, resources, a
//     term satisfied where a hit bit of its listed alternatives is set, a
//     group refused where a negative's or a port's is, a node refused where
//     an active taint slot is not tolerated; then the writes. A warp writes
//     32 neighbouring bytes of row g (64 for the bits): coalesced along N
//     with no output staging.
// A node's slots are compared with the union of the probes that occur, 8
// compares a lane and a vote a probe, not every probe slot with every slot
// in a chain.
//
// Shared memory at `Dims()` (L 64, T 6, NP 16, R 8, S 6 x A 4, Sn 4, Tl 8,
// PP 4) and G = 64 (one chunk): 51,888 bytes for the static checks, 52,272
// with residents (the filter's and the drain's plane; the resident words
// take 384), 57,056 with resources (opted in above 48 KB). 64 registers a
// thread (the launch bound of 2 CTAs an SM): 2 CTAs (32 warps) an SM by
// registers, 4 by shared memory and by threads, so the main path's 160
// CTAs at N = 5,120 are all resident at once on 132 SMs. Every width the
// first design took fits: the chunk halves until the CTA's shared memory
// fits (a chunk of 1 needs less than the first design's 8-group CTA).
//
// Bound on this card: bytes. The plane reads each node plane once (≈ 2.2 MB
// at the filter's G = 64 x N = 5,120, the resident pods 0.37 MB more) and
// writes 0.33 MB: ≈ 0.0008 ms at 3.35 TB/s. The compares the data needs
// (the non-zero probes against the slots, the non-zero taints against the
// tolerations, R + 2 for resources and gates) are a few million at the main
// path's shapes, far under a millisecond's share of the card's integer
// rate. Tensor cores are of no use: the work is integer equality, with no
// product to accumulate.
//
// Contract (checked by the Python wrapper and, for the sizes, here): the
// planes of the checks asked for, contiguous, i32 hashes and counts, bool
// flags as bytes; the others may be null. The resident inputs (valid,
// node_idx, group_ref [P], anti_affinity_self [G] and the word plane) come
// all together or not at all, and only in the bool kind. Returns the CUDA
// error (cudaErrorInvalidValue for a size or a shared-memory need it does
// not take).
//
// The `// trace:` comments in the plane kernel are comments only: they mark
// where tools/torch_pred_trace.py reads the clock in an instrumented copy,
// each naming what ran since the mark before it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// the checks (ops/kernels/predicate_kernel.py SELECTOR..GATES)
constexpr int kSelector = 1, kTaints = 2, kPorts = 4, kResources = 8, kGates = 16;
constexpr int kAllChecks = 31;
// refusal bits (ops/predicates.py REASON_*): slot r < kNumStandard refuses
// with bit r
constexpr int kNumStandard = 4;
constexpr int kReasonExtended = 1 << 4, kReasonSelector = 1 << 5, kReasonTaint = 1 << 6,
              kReasonPorts = 1 << 7, kReasonNodeUnavailable = 1 << 8,
              kReasonGroupInvalid = 1 << 9;
// a group's flags word
constexpr int kTolerateAll = 1, kValid = 2, kInMask = 4;

constexpr int kTile = 32;        // nodes a CTA: a lane each in the pair phase
constexpr int kThreads = 512;    // threads a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 64;    // groups a chunk
constexpr int kResThreads = 256; // threads a CTA of the resident pre-pass
constexpr int kMaxSmem = 227 * 1024;
static_assert(kThreads == 512, "warps 6 and 7 stage the slices, warps 0..7 hold the tile's "
              "nodes 4 a warp, a thread a (group, list) of a chunk");
constexpr int kMaxWidth = 1 << 20;

enum Field {
  kLabelHash, kTaintExact, kTaintKey, kUsedPorts, kNodeValid, kReady, kSchedulable, kCap, kAlloc,
  kSelReq, kSelNeg, kTolExact, kTolKey, kTolerateAllPlane, kPortHash, kGroupValid, kReq,
  kGroupMask, kOut, kResValid, kResNode, kResGroup, kAntiSelf, kWords, kNumFields
};
enum Dim { dN, dG, dL, dT, dNP, dR, dS, dA, dSn, dTl, dPP, dP, kNumDims };

__host__ __device__ constexpr int64_t a16(int64_t x) { return (x + 15) & ~int64_t{15}; }
// room for a [rows, width] slice of a plane at any 4-byte source alignment:
// it lands at the source's offset modulo 16
__host__ __device__ constexpr int64_t region(int64_t bytes) { return a16(bytes) + 16; }

// byte offsets into a CTA's shared memory (all 16-byte aligned)
struct Layout {
  int chunk;          // groups a chunk
  int ws, wp;         // words of a node's selector / port hit row (odd)
  int lab, te, tk, port, cap, alloc, fr;  // the node tile's planes, free [R][kTile]
  int sel, neg, tex, tky, gport, req;     // the chunk's group planes
  int pu, pt, hs;     // the selector probe list, each one's term, hit rows
                      // [kTile][ws]
  int pp, hp;         // the port probe list, hit rows [kTile][wp]
  int tof;            // the term of each alternative slot [S * A]
  int act, tol;       // the tile's taint slots, a bit each: active [T], and
                      // inactive or tolerated by each group [chunk][T]
  int rw;             // resident words [ceil(chunk / 32) + 1][kTile]
  int gd, nmeta;      // the chunk's group descriptors [chunk][8] and 2
                      // list lengths; the tile's gates
  int64_t smem;       // bytes a CTA (two mbarriers first); the offsets hold
                      // only where it fits
};

Layout layout(const int* d, int checks, bool resident, int chunk) {
  const bool sel = checks & kSelector, tai = checks & kTaints, por = checks & kPorts,
             res = checks & kResources;
  const int64_t probes = static_cast<int64_t>(d[dS]) * d[dA] + d[dSn];
  const int64_t us = sel ? chunk * probes : 0;
  const int64_t up = por ? static_cast<int64_t>(chunk) * d[dPP] : 0;
  Layout y{};
  y.chunk = chunk;
  y.ws = static_cast<int>(((us + 31) / 32) | 1);
  y.wp = static_cast<int>(((up + 31) / 32) | 1);
  int64_t o = 16;  // the two mbarriers
  auto take = [&o](int64_t bytes) {
    const int64_t at = o;
    o += bytes;
    return static_cast<int>(at);
  };
  const int64_t t4 = kTile * 4LL, c4 = chunk * 4LL;
  y.lab = take(sel ? region(t4 * d[dL]) : 0);
  y.te = take(tai ? region(t4 * d[dT]) : 0);
  y.tk = take(tai ? region(t4 * d[dT]) : 0);
  y.port = take(por ? region(t4 * d[dNP]) : 0);
  y.cap = take(res ? region(t4 * d[dR]) : 0);
  y.alloc = take(res ? region(t4 * d[dR]) : 0);
  y.fr = take(res ? a16(t4 * d[dR]) : 0);
  y.sel = take(sel ? region(c4 * d[dS] * d[dA]) : 0);
  y.neg = take(sel ? region(c4 * d[dSn]) : 0);
  y.tex = take(tai ? region(c4 * d[dTl]) : 0);
  y.tky = take(tai ? region(c4 * d[dTl]) : 0);
  y.gport = take(por ? region(c4 * d[dPP]) : 0);
  y.req = take(res ? region(c4 * d[dR]) : 0);
  y.pu = take(a16(us * 4));
  y.pt = take(a16(us * 4));
  y.hs = take(sel ? a16(t4 * y.ws) : 0);
  y.pp = take(a16(up * 4));
  y.hp = take(por ? a16(t4 * y.wp) : 0);
  y.tof = take(sel ? a16(4LL * d[dS] * d[dA]) : 0);
  y.act = take(tai ? a16(4LL * d[dT]) : 0);
  y.tol = take(tai ? a16(c4 * d[dT]) : 0);
  y.rw = take(resident ? a16(((chunk + 31) / 32 + 1) * t4) : 0);
  y.gd = take(a16(c4 * 8) + 16);
  y.nmeta = take(t4);
  y.smem = o;
  return y;
}

// the largest chunk (≤ kMaxChunk, ≤ G, halving) whose CTA fits
Layout fit(const int* d, int checks, bool resident) {
  int chunk = d[dG] < kMaxChunk ? (d[dG] > 0 ? d[dG] : 1) : kMaxChunk;
  Layout y = layout(d, checks, resident, chunk);
  while (y.smem > kMaxSmem && chunk > 1) {
    chunk = (chunk + 1) / 2;
    y = layout(d, checks, resident, chunk);
  }
  return y;
}

struct Args {
  const int32_t* lab;
  const int32_t* te;
  const int32_t* tk;
  const int32_t* ports;
  const uint8_t* nvalid;
  const uint8_t* ready;
  const uint8_t* sched;
  const int32_t* cap;
  const int32_t* alloc;
  const int32_t* sel;
  const int32_t* neg;
  const int32_t* tex;
  const int32_t* tky;
  const uint8_t* tol_all;
  const int32_t* gport;
  const uint8_t* gvalid;
  const int32_t* req;
  const uint8_t* gmask;
  const uint32_t* words;  // null without residents
  void* out;
  int N, G, L, T, NP, R, S, A, Sn, Tl, PP;
  int checks, bits;
  Layout y;
};

// ---- the asynchronous copies (PTX)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// the barriers' initialisation, seen by the async proxy
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// this thread's shared-memory accesses ordered before later bulk copies
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_done(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// ---- end of the PTX

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_done(bar, parity)) {
  }
}

// Where a slice of a plane starting at `src` lands in its region: at the
// source's offset modulo 16, so that its 16-byte aligned middle is one bulk
// copy.
template <class T>
__device__ __forceinline__ T* landing(unsigned char* region_at, const T* src) {
  return reinterpret_cast<T*>(region_at + (reinterpret_cast<uintptr_t>(src) & 15));
}

// One slice, staged by the calling thread: it arrives on `bar` expecting
// the bulk bytes and issues one bulk copy of the slice's 16-byte aligned
// middle; the few bytes before and after it go by plain loads (none where
// the slice is aligned, as the main path's are). A thread with no slice
// (`words` 0) just arrives.
__device__ __forceinline__ void stage(unsigned char* region_at, const int32_t* src,
                                      int64_t words, uint64_t* bar) {
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  unsigned char* d = landing(region_at, s);
  const int64_t bytes = words * 4, lead = (16 - (reinterpret_cast<uintptr_t>(s) & 15)) & 15;
  const int64_t head = bytes < lead ? bytes : lead;
  const int64_t body = (bytes - head) & ~int64_t{15};
  mbar_arrive_expect(bar, static_cast<uint32_t>(body));
  if (body) bulk_copy(d + head, s + head, static_cast<uint32_t>(body), bar);
  for (int64_t i = 0; i < head; ++i) d[i] = s[i];
  for (int64_t i = head + body; i < bytes; ++i) d[i] = s[i];
}

// 8 lanes a node: lane `sl` of the node's 8 (`sub` of the warp's 4) holds
// 8 of the slots of row[0, width) below 64, rotated by `sub` so that the
// warp's 4 nodes read distinct banks (0 past the width); with kWide, slots
// past 64 are read from `row`
struct Slots {
  int v[8];
  __device__ __forceinline__ void load(const int* row, int width, int sl, int sub, bool on) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = sl + 8 * ((k + sub) & 7);
      v[k] = on && c < width ? row[c] : 0;
    }
  }
  template <bool kWide>
  __device__ __forceinline__ bool has(int p, const int* row, int width, int sl) const {
    bool h = false;
#pragma unroll
    for (int k = 0; k < 8; ++k) h |= v[k] == p;
    if (kWide)
      for (int c = sl + 64; c < width; c += 8) h |= row[c] == p;
    return h;
  }
};

// Bit u of hit[...] for u < count: whether list[u] (non-zero) is among the
// node's slots. A warp holds 4 nodes, 8 lanes each: one vote a probe
// answers all four, 4 probes at once; lane 0 of a node's 8 writes its
// words (where the node is `on`).
template <bool kWide>
__device__ __forceinline__ void hit_rows(const Slots& s, const int* row, int width, int sl,
                                         int sub, bool on, const int* list, int count,
                                         uint32_t* hit) {
  uint32_t word = 0;
  for (int u0 = 0; u0 < count; u0 += 4) {
    uint32_t b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool in = u0 + k < count;
      const int p = in ? list[u0 + k] : 0;
      b[k] = __ballot_sync(~0u, in && s.template has<kWide>(p, row, width, sl));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int u = u0 + k;
      if (u >= count) break;
      word |= ((b[k] >> (sub * 8)) & 0xffu ? 1u : 0u) << (u & 31);
      if ((u & 31) == 31 || u + 1 == count) {
        if (on && sl == 0) hit[u >> 5] = word;
        word = 0;
      }
    }
  }
}

__device__ __forceinline__ bool bit(const uint32_t* w, int u) { return (w[u >> 5] >> (u & 31)) & 1; }

// the bits of word w that lie in [u0, u1)
__device__ __forceinline__ uint32_t span(int w, int u0, int u1) {
  const int lo = max(u0 - w * 32, 0), hi = min(u1 - w * 32, 32);
  return hi <= lo ? 0u : (hi - lo == 32 ? ~0u : ((1u << (hi - lo)) - 1) << lo);
}

// node slices (one thread each, lanes 0..5 of warp 6) and group slices
// (lanes 0..5 of warp 7): a barrier each, counting one arrival a slot
constexpr int kNodeSlices = 6, kGroupSlices = 6;
// a group's flags beyond those of its planes: it has a non-zero selector
// probe, a non-zero port
constexpr int kHasSel = 8, kHasPorts = 16, kHasTols = 32;
// a group's descriptor: two int4
enum Desc { dAltAt, dAlts, dNegs, dFlags, dPortAt, dPorts };
// a chunk's groups a warp (the pair phase's and the lists' unrolled loops)
constexpr int kGroupsAWarp = kMaxChunk / kWarps;

__global__ void __launch_bounds__(kThreads, 2) plane_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout y = a.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool sel = a.checks & kSelector, tai = a.checks & kTaints, por = a.checks & kPorts,
             res = a.checks & kResources, gates = a.checks & kGates;
  const int n0 = blockIdx.x * kTile;
  const int nt = min(kTile, a.N - n0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [0] the tile, [1] a chunk
  int* gd = reinterpret_cast<int*>(smem + y.gd);
  int* totals = gd + 8 * y.chunk;  // selector and port probes listed
  int* up = reinterpret_cast<int*>(smem + y.nmeta);
  uint32_t* act = reinterpret_cast<uint32_t*>(smem + y.act);
  uint32_t* tol = reinterpret_cast<uint32_t*>(smem + y.tol);
  int* pu = reinterpret_cast<int*>(smem + y.pu);
  int* pt = reinterpret_cast<int*>(smem + y.pt);
  uint32_t* hs = reinterpret_cast<uint32_t*>(smem + y.hs);
  int* pp = reinterpret_cast<int*>(smem + y.pp);
  uint32_t* hp = reinterpret_cast<uint32_t*>(smem + y.hp);
  int* tof = reinterpret_cast<int*>(smem + y.tof);
  uint32_t* rw = reinterpret_cast<uint32_t*>(smem + y.rw);
  int* fr = reinterpret_cast<int*>(smem + y.fr);
  // trace: start
  const int SA = sel ? a.S * a.A : 0;  // alternative slots of a group
  const int64_t at = n0, nn = nt;
  // where the tile's slices land (the same in every thread)
  const int* lab = landing(smem + y.lab, a.lab + at * a.L);
  const int* te = landing(smem + y.te, a.te + at * a.T);
  const int* tk = landing(smem + y.tk, a.tk + at * a.T);
  const int* nport = landing(smem + y.port, a.ports + at * a.NP);
  const int* cap = landing(smem + y.cap, a.cap + at * a.R);
  const int* alloc = landing(smem + y.alloc, a.alloc + at * a.R);

  // 1. staging. Lane 0 of warp 6 makes the tile's barrier and lanes 0..5
  // issue a bulk copy of a node plane's slice each; warp 7 likewise with
  // the chunk's barrier and group planes (below); the other threads load
  // the node gates and the chunk's group flags meanwhile
  if (warp == 6) {
    if (lane == 0) {
      mbar_init(&bars[0], kNodeSlices);
      fence_init();
    }
    __syncwarp();
    if (lane < kNodeSlices) {
      const bool on[kNodeSlices] = {sel, tai, tai, por, res, res};
      const int32_t* src[kNodeSlices] = {a.lab, a.te, a.tk, a.ports, a.cap, a.alloc};
      const int width[kNodeSlices] = {a.L, a.T, a.T, a.NP, a.R, a.R};
      const int off[kNodeSlices] = {y.lab, y.te, y.tk, y.port, y.cap, y.alloc};
      stage(smem + off[lane], src[lane] + at * width[lane], on[lane] ? nn * width[lane] : 0,
            &bars[0]);
    }
  }
  if (tid < nt)
    up[tid] = !gates || (a.nvalid[n0 + tid] & a.ready[n0 + tid] & a.sched[n0 + tid]) != 0;
  if (sel)  // the term of each alternative slot, without a divide
    for (int t = tid; t < a.S; t += kThreads)
      for (int k = 0; k < a.A; ++k) tof[t * a.A + k] = t;

  // trace: node slices issued, node gates loaded, the term table
  for (int c = 0, g0 = 0; g0 < a.G; ++c, g0 += y.chunk) {
    const int gc = min(y.chunk, a.G - g0);
    const int w0 = g0 >> 5, rows = ((g0 + gc - 1) >> 5) - w0 + 1;
    // the group flags and the tile's resident words, loaded first
    int flag = 0;
    if (tid < gc) {
      const int g = g0 + tid;
      const int ta = tai ? a.tol_all[g] : 0, gv = gates ? a.gvalid[g] : 0,
                gm = a.gmask != nullptr ? a.gmask[g] : 1;
      flag = (ta ? kTolerateAll : 0) | (gv ? kValid : 0) | (gm ? kInMask : 0);
    }
    uint32_t word = 0;
    if (a.words != nullptr && tid < rows * kTile && (tid & 31) < nt)
      word = a.words[static_cast<int64_t>(w0 + (tid >> 5)) * a.N + n0 + (tid & 31)];
    // trace: group flags and resident words loaded
    if (c > 0) {
      fence_async();
      __syncthreads();  // the previous chunk's rows and lists are read
    }
    // the chunk's group slices: a thread a plane
    const int64_t gat = g0, cg = gc;
    if (warp == 7) {
      if (c == 0) {
        if (lane == 0) {
          mbar_init(&bars[1], kGroupSlices);
          fence_init();
        }
        __syncwarp();
      }
      if (lane < kGroupSlices) {
        const bool on[kGroupSlices] = {sel, sel, tai, tai, por, res};
        const int32_t* src[kGroupSlices] = {a.sel, a.neg, a.tex, a.tky, a.gport, a.req};
        const int width[kGroupSlices] = {a.S * a.A, a.Sn, a.Tl, a.Tl, a.PP, a.R};
        const int off[kGroupSlices] = {y.sel, y.neg, y.tex, y.tky, y.gport, y.req};
        stage(smem + off[lane], src[lane] + gat * width[lane], on[lane] ? cg * width[lane] : 0,
              &bars[1]);
      }
    }
    const int* gsel = landing(smem + y.sel, a.sel + gat * SA);
    const int* gneg = landing(smem + y.neg, a.neg + gat * a.Sn);
    const int* gtex = landing(smem + y.tex, a.tex + gat * a.Tl);
    const int* gtky = landing(smem + y.tky, a.tky + gat * a.Tl);
    const int* gpt = landing(smem + y.gport, a.gport + gat * a.PP);
    const int* greq = landing(smem + y.req, a.req + gat * a.R);
    // trace: the chunk's group slices issued
    if (tid < gc) gd[tid * 8 + dFlags] = flag;
    if (a.words != nullptr && tid < rows * kTile) rw[tid] = word;
    if (tid == 0) totals[0] = totals[1] = 0;
    if (c == 0) __syncthreads();  // the barriers are made before anyone waits
    mbar_wait(&bars[1], c & 1);
    __syncthreads();
    // trace: a barrier, the wait for the group rows, a barrier

    // 2. the chunk's probes. The selector's row of a group (alternatives,
    // then negatives) goes to 4 threads, a contiguous quarter each: they
    // count its non-zero entries, the first takes their places in the CTA's
    // list with a shared-memory atomic, and each writes its quarter's there
    // in row order, each alternative with its term. A thread a group does
    // the same for the ports, and flags a group with a toleration.
    {
      const int gl = tid >> 2, q = tid & 3;  // threads 0..255: the selector
      if (sel && tid < 4 * kMaxChunk) {
        const bool in = gl < gc;
        const int SN = SA + a.Sn, lo = (q * SN) >> 2, hi = ((q + 1) * SN) >> 2;
        const int* row = gsel + gl * SA;
        const int* neg = gneg + gl * a.Sn - SA;  // neg[i] for i in [SA, SN)
        int mine = 0, alts = 0;  // this quarter's non-zero entries, alternatives
        for (int i = lo; i < hi && in; ++i) {
          const bool nz = (i < SA ? row[i] : neg[i]) != 0;
          mine += nz;
          alts += nz && i < SA;
        }
        const int na = mine + __shfl_xor_sync(~0u, mine, 1);
        const int total = na + __shfl_xor_sync(~0u, na, 2);
        alts += __shfl_xor_sync(~0u, alts, 1);
        alts += __shfl_xor_sync(~0u, alts, 2);
        int w = 0;
        if (in && q == 0 && total) w = atomicAdd(&totals[0], total);
        // this quarter's place: the group's, after the quarters before it
        const int before = __shfl_up_sync(~0u, mine, 1);
        const int first2 = __shfl_sync(~0u, na, lane & ~3);
        w = __shfl_sync(~0u, w, lane & ~3) + (q & 1 ? before : 0) + (q & 2 ? first2 : 0);
        if (in && total) {
          int* dg = gd + gl * 8;
          if (q == 0) {
            dg[dAlts] = alts;
            dg[dNegs] = total - alts;
            dg[dAltAt] = w;
            atomicOr(&dg[dFlags], kHasSel);
          }
          for (int i = lo; i < hi; ++i) {
            const int v = i < SA ? row[i] : neg[i];
            if (v == 0) continue;
            if (i < SA) pt[w] = tof[i];  // (a negative's term is never read)
            pu[w++] = v;
          }
        }
      }
      const int g2 = tid - 4 * kMaxChunk;  // threads 256..319: the ports and
      if (g2 >= 0 && g2 < gc) {              // the tolerations
        int* dg = gd + g2 * 8;
        if (por) {
          const int* row = gpt + g2 * a.PP;
          int np = 0;
          for (int i = 0; i < a.PP; ++i) np += row[i] != 0;
          int w = np ? atomicAdd(&totals[1], np) : 0;
          dg[dPortAt] = w;
          dg[dPorts] = np;
          if (np) atomicOr(&dg[dFlags], kHasPorts);
          for (int i = 0; i < a.PP && np; ++i)
            if (row[i] != 0) pp[w++] = row[i];
        }
        if (tai) {
          const int* ex = gtex + g2 * a.Tl;
          const int* ky = gtky + g2 * a.Tl;
          bool any = false;
          for (int i = 0; i < a.Tl && !any; ++i) any = (ex[i] | ky[i]) != 0;
          if (any) atomicOr(&dg[dFlags], kHasTols);
        }
      }
    }
    // trace: the probe lists (a thread a group and list)
    if (c == 0) mbar_wait(&bars[0], 0);  // the node slices
    __syncthreads();

    // trace: wait for the node slices and a barrier
    // 3. a warp holds 4 nodes, 8 lanes each: the hit rows; the taint bits;
    // once, free
    {
      const int sub = lane >> 3, sl = lane & 7, j = warp * 4 + sub;
      const bool on = j < nt;
      const int jj = on ? j : 0;
      const int us = totals[0], upn = totals[1];
      const bool holds = warp * 4 < nt;  // a warp with a node of the tile
      if (sel && us > 0 && holds) {
        const int* row = lab + jj * a.L;
        Slots s;
        s.load(row, a.L, sl, sub, on);
        if (a.L > 64)
          hit_rows<true>(s, row, on ? a.L : 0, sl, sub, on, pu, us, hs + jj * y.ws);
        else
          hit_rows<false>(s, row, on ? a.L : 0, sl, sub, on, pu, us, hs + jj * y.ws);
      }
      if (por && upn > 0 && holds) {
        const int* row = nport + jj * a.NP;
        Slots s;
        s.load(row, a.NP, sl, sub, on);
        if (a.NP > 64)
          hit_rows<true>(s, row, on ? a.NP : 0, sl, sub, on, pp, upn, hp + jj * y.wp);
        else
          hit_rows<false>(s, row, on ? a.NP : 0, sl, sub, on, pp, upn, hp + jj * y.wp);
      }
      // the tile's taint slots u = j T + t as bits: once, whether each is
      // active (a non-zero exact hash); for each group with a toleration,
      // whether each is inactive or tolerated (lane u % 32 of a vote)
      // trace: the hit rows
      const int ut = nt * a.T;
      if (c == 0 && tai)
        for (int w = warp; w < a.T; w += kWarps) {
          const int u = w * 32 + lane;
          act[w] = __ballot_sync(~0u, u < ut && te[u] != 0);
        }
      // warps 8..15 (the hit rows take 0..7) take the groups w - 8, w, ...
      // with a toleration, and each word of slots: lane u % 32 of a vote
      // where the word has an active slot, all ones where not
      if (tai && warp >= kWarps / 2)
        for (int gl = warp - kWarps / 2; gl < gc; gl += kWarps / 2) {
          const int f = gd[gl * 8 + dFlags];
          if (!(f & kHasTols) || (f & kTolerateAll)) continue;
          const int* ex = gtex + gl * a.Tl;
          const int* ky = gtky + gl * a.Tl;
          int x[8], q[8];
#pragma unroll
          for (int l = 0; l < 8; ++l) {
            x[l] = l < a.Tl ? ex[l] : 0;
            q[l] = l < a.Tl ? ky[l] : 0;
          }
          for (int w = 0; w < a.T; ++w) {
            const int u = w * 32 + lane;
            const int ev = u < ut ? te[u] : 0;
            if (!__any_sync(~0u, ev != 0)) {  // no active slot: all tolerated
              if (lane == 0) tol[gl * a.T + w] = ~0u;
              continue;
            }
            const int k2 = u < ut ? tk[u] : 0;
            bool covered = ev == 0;
            if (a.Tl <= 8) {  // the group's tolerations in registers (0 past Tl: never equal)
#pragma unroll
              for (int l = 0; l < 8; ++l) covered |= x[l] == ev || (k2 != 0 && q[l] == k2);
            } else {
              for (int l = 0; l < a.Tl; ++l) covered = covered || ex[l] == ev || (k2 != 0 && ky[l] == k2);
            }
            const uint32_t b = __ballot_sync(~0u, covered);
            if (lane == 0) tol[gl * a.T + w] = b;
          }
        }
      // trace: the taint bits
      if (c == 0 && res && on)  // cap - alloc, wrapping as int32 arithmetic does
        for (int r = sl; r < a.R; r += 8)
          fr[r * kTile + j] = static_cast<int>(static_cast<uint32_t>(cap[j * a.R + r]) -
                                               static_cast<uint32_t>(alloc[j * a.R + r]));
    }
    __syncthreads();

    // trace: free, and a barrier
    // 4. the pairs: lane j is node j, warp w the groups w, w + 16, ..., all
    // at once: the flags, gates and resident bit of each first, then the
    // checks that read lists (a group with probes, a tainted node, the
    // resources) for the pairs that need them, then the writes
    const int j = lane;
    if (j >= nt) continue;
    const bool nup = up[j] != 0;
    // this node's taint slots [j T, j T + T), and whether one is active
    const int u0 = j * a.T, u1 = u0 + a.T;
    bool tainted = false;
    for (int w = u0 >> 5; tai && w <= (u1 - 1) >> 5; ++w) tainted |= (act[w] & span(w, u0, u1)) != 0;
    const bool rs = a.words != nullptr;
    // a chunk spans 2 words at most: one of 32 groups or fewer does, and
    // one wider is min(G, 64) unhalved (a halving leaves 32 or fewer), so
    // its chunks start at multiples of 64, or only at 0 when G < 64
    const uint32_t rj0 = rs ? rw[j] : 0, rj1 = rs && rows > 1 ? rw[kTile + j] : 0;
    int bits[kGroupsAWarp];
    bool ok[kGroupsAWarp];
#pragma unroll
    for (int k = 0; k < kGroupsAWarp; ++k) {
      const int gl = warp + k * kWarps, g = g0 + gl;
      const int f = gl < gc ? gd[gl * 8 + dFlags] : 0;
      ok[k] = (f & kInMask) != 0;
      bits[k] = gates ? (nup ? 0 : kReasonNodeUnavailable) | (f & kValid ? 0 : kReasonGroupInvalid)
                      : 0;
      if (rs) {
        const int r = (g >> 5) - w0;
        ok[k] = ok[k] && !(((r == 0 ? rj0 : rj1) >> (g & 31)) & 1);
      }
    }
#pragma unroll
    for (int k = 0; k < kGroupsAWarp; ++k) {
      const int gl = warp + k * kWarps;
      if (!ok[k] || !(a.bits || bits[k] == 0)) continue;  // (a group past the chunk is not ok)
      const int4 d0 = reinterpret_cast<const int4*>(gd)[gl * 2];
      const int f = d0.w;
      const bool taints = tainted && !(f & kTolerateAll);
      if (!(res || taints || (f & (kHasSel | kHasPorts)))) continue;
      int b = bits[k];
      if (res) {
        const int* rq = greq + gl * a.R;
        for (int r = 0; r < a.R; ++r)
          if (rq[r] > fr[r * kTile + j]) b |= r < kNumStandard ? 1 << r : kReasonExtended;
      }
      if ((f & kHasSel) && (a.bits || b == 0)) {
        // every term with a non-zero alternative has one among the labels
        // (a group's listed alternatives come term by term), and no
        // negative is
        const uint32_t* h = hs + j * y.ws;
        bool fail = false, sat = true;
        for (int i = d0.x, term = -1; i < d0.x + d0.y && !fail; ++i) {
          if (pt[i] != term) {  // a term starts: the last one was satisfied?
            fail = !sat;
            sat = false;
            term = pt[i];
          }
          sat = sat || bit(h, i);
        }
        fail = fail || !sat;
        for (int i = d0.x + d0.y; i < d0.x + d0.y + d0.z && !fail; ++i) fail = bit(h, i);
        if (fail) b |= kReasonSelector;
      }
      if (taints && (a.bits || b == 0))  // every active slot of the node tolerated
        for (int w = u0 >> 5; w <= (u1 - 1) >> 5; ++w) {
          const uint32_t m = span(w, u0, u1);
          if ((((f & kHasTols) ? tol[gl * a.T + w] : ~act[w]) & m) != m) {
            b |= kReasonTaint;
            break;
          }
        }
      if ((f & kHasPorts) && (a.bits || b == 0)) {
        const int4 d1 = reinterpret_cast<const int4*>(gd)[gl * 2 + 1];
        const uint32_t* h = hp + j * y.wp;
        for (int i = d1.x; i < d1.x + d1.y; ++i)
          if (bit(h, i)) {
            b |= kReasonPorts;
            break;
          }
      }
      bits[k] = b;
    }
    // trace: the pairs' flags, gates, resident bits and list checks
    const int64_t o = (gat + warp) * a.N + n0 + j, step = static_cast<int64_t>(kWarps) * a.N;
#pragma unroll
    for (int k = 0; k < kGroupsAWarp; ++k) {
      if (warp + k * kWarps >= gc) break;
      if (a.bits)
        static_cast<uint16_t*>(a.out)[o + k * step] = ok[k] ? static_cast<uint16_t>(bits[k]) : 0;
      else
        static_cast<uint8_t*>(a.out)[o + k * step] = ok[k] && bits[k] == 0;
    }
  }
  // trace: end: the pairs' writes
}

// one thread a resident pod: bit g % 32 of word (g / 32, n) for a pod of
// an anti-affine group g on node n, the indices read as the reference's
// `.at[gr, ni]` reads them (a negative group counts from the end once;
// anything still outside is dropped)
__global__ void __launch_bounds__(kResThreads)
    resident_kernel(const uint8_t* valid, const int32_t* node_idx, const int32_t* group_ref,
                    const uint8_t* anti, int P, int G, int N, uint32_t* words) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kResThreads + threadIdx.x;
  if (i >= P || !valid[i]) return;
  const int n = node_idx[i];
  int64_t g = group_ref[i];
  if (g < 0) g += G;
  if (n < 0 || n >= N || g < 0 || g >= G || !anti[g]) return;
  atomicOr(&words[(g >> 5) * N + n], 1u << (g & 31));
}

std::atomic<int> smem_opted_in{48 * 1024};

}  // namespace

// The dynamic shared memory a CTA takes at these widths and checks (dims in
// the Dim order), with or without residents, at the chunk it would run; -1
// for widths it does not take.
extern "C" int64_t ka_pred_smem(const int* d, int checks, int resident) {
  for (int i = 0; i < kNumDims; ++i)
    if (d[i] < 0 || d[i] > (i <= dG || i == dP ? (1 << 30) : kMaxWidth)) return -1;
  return fit(d, checks, resident != 0).smem;
}

// One call: p holds the Field pointers (null where no check asked for reads
// them; group_mask null for every row; the resident fields and the word
// plane, uint32[ceil(G/32) * N], null without residents), d the Dim widths;
// `bits` selects uint16 refusal bits, else bool feasibility. Enqueued on
// `stream_`: with residents a memset and the pre-pass, then the plane;
// nothing is read back.
extern "C" int ka_pred_plane(void* const* p, const int* d, int checks, int bits, void* stream_) {
  if (checks <= 0 || (checks & ~kAllChecks)) return static_cast<int>(cudaErrorInvalidValue);
  const bool resident = p[kResValid] != nullptr;
  const int64_t need = ka_pred_smem(d, checks, resident);
  if (need < 0 || need > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (p[kOut] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int needs[6][5] = {{kLabelHash, kSelReq, kSelNeg, -1, -1},
                           {kTaintExact, kTaintKey, kTolExact, kTolKey, kTolerateAllPlane},
                           {kUsedPorts, kPortHash, -1, -1, -1},
                           {kCap, kAlloc, kReq, -1, -1},
                           {kNodeValid, kReady, kSchedulable, kGroupValid, -1},
                           {kResNode, kResGroup, kAntiSelf, kWords, -1}};
  for (int c = 0; c < 6; ++c) {
    if (c < 5 ? !(checks & (1 << c)) : !resident) continue;
    for (int k = 0; k < 5; ++k)
      if (needs[c][k] >= 0 && p[needs[c][k]] == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
  }
  if (resident && bits) return static_cast<int>(cudaErrorInvalidValue);
  if (d[dN] == 0 || d[dG] == 0) return 0;
  const int smem = static_cast<int>(need);
  if (smem > smem_opted_in.load()) {
    const cudaError_t err =
        cudaFuncSetAttribute(plane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_opted_in.store(smem);
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  uint32_t* words = static_cast<uint32_t*>(p[kWords]);
  if (resident) {
    const int64_t wbytes = (static_cast<int64_t>(d[dG]) + 31) / 32 * d[dN] * 4;
    const cudaError_t err = cudaMemsetAsync(words, 0, static_cast<size_t>(wbytes), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (d[dP] > 0) {
      const int blocks = static_cast<int>((static_cast<int64_t>(d[dP]) + kResThreads - 1) / kResThreads);
      resident_kernel<<<blocks, kResThreads, 0, stream>>>(
          static_cast<const uint8_t*>(p[kResValid]), static_cast<const int32_t*>(p[kResNode]),
          static_cast<const int32_t*>(p[kResGroup]), static_cast<const uint8_t*>(p[kAntiSelf]),
          d[dP], d[dG], d[dN], words);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  Args a{};
  a.lab = static_cast<const int32_t*>(p[kLabelHash]);
  a.te = static_cast<const int32_t*>(p[kTaintExact]);
  a.tk = static_cast<const int32_t*>(p[kTaintKey]);
  a.ports = static_cast<const int32_t*>(p[kUsedPorts]);
  a.nvalid = static_cast<const uint8_t*>(p[kNodeValid]);
  a.ready = static_cast<const uint8_t*>(p[kReady]);
  a.sched = static_cast<const uint8_t*>(p[kSchedulable]);
  a.cap = static_cast<const int32_t*>(p[kCap]);
  a.alloc = static_cast<const int32_t*>(p[kAlloc]);
  a.sel = static_cast<const int32_t*>(p[kSelReq]);
  a.neg = static_cast<const int32_t*>(p[kSelNeg]);
  a.tex = static_cast<const int32_t*>(p[kTolExact]);
  a.tky = static_cast<const int32_t*>(p[kTolKey]);
  a.tol_all = static_cast<const uint8_t*>(p[kTolerateAllPlane]);
  a.gport = static_cast<const int32_t*>(p[kPortHash]);
  a.gvalid = static_cast<const uint8_t*>(p[kGroupValid]);
  a.req = static_cast<const int32_t*>(p[kReq]);
  a.gmask = static_cast<const uint8_t*>(p[kGroupMask]);
  a.words = resident ? words : nullptr;
  a.out = p[kOut];
  a.N = d[dN];
  a.G = d[dG];
  a.L = d[dL];
  a.T = d[dT];
  a.NP = d[dNP];
  a.R = d[dR];
  a.S = d[dS];
  a.A = d[dA];
  a.Sn = d[dSn];
  a.Tl = d[dTl];
  a.PP = d[dPP];
  a.checks = checks;
  a.bits = bits;
  a.y = fit(d, checks, resident);
  const unsigned grid = static_cast<unsigned>((static_cast<int64_t>(d[dN]) + kTile - 1) / kTile);
  plane_kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
