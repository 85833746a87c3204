// The predicate plane: for every (pod group g, node n), either whether no
// check asked for refuses the pair (bool[G, N]) or the refusal bits of those
// checks (uint16[G, N]).
//
// Replaces no Pallas kernel: XLA's fusion of the reference package's
// kubernetes_autoscaler_tpu/ops/predicates.py (`_any_eq` :89,
// `resources_fit` :97, `selector_match` :103-119, `taints_tolerated`
// :122-142, `ports_free` :145-152, `feasibility_mask` :270-288,
// `reason_mask` :295-325, `reason_mask_for_groups` :329-341). Its loops run
// over the static padding dims (L label slots, S x A selector alternatives,
// Sn negatives, T taints x Tl tolerations, PP x NP ports); run eagerly, each
// step is a launch over [G, N] or [G, N, K], ≈ 570 a plane at the default
// widths. This kernel is one launch.
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
//              valid (bit 9).
// Feasible is bits == 0 over the same checks. A row whose group_mask entry
// is 0 is written 0 in either kind.
//
// Design: one launch of a 2-d grid. A CTA takes a tile of kTile nodes, a
// thread a node, and a chunk of kGroups groups (blockIdx.y), so that the
// main path's G = 64 x N = 5,120 is 320 CTAs. It stages in shared memory
// the tile's node slots (labels, taints, ports, free capacity), read
// coalesced since a tile's slice of each plane is contiguous, as rows at an
// odd word stride (a warp reading one slot of 32 nodes hits 32 banks), and
// the chunk's group rows (probes, tolerations, requests and a flags word),
// which every thread then reads at the same address (a broadcast). Each
// thread walks the chunk's groups; all threads of a warp are on the same
// group at once, so skipping a zero probe is the same branch for the whole
// warp, and a non-zero probe is compared with every slot of the node's row.
// Neighbouring threads write neighbouring n of one g.
//
// Bound on this card: operations. The plane reads ≈ 2.2 MB at the filter's
// G = 64 x N = 5,120 and writes 0.33 MB; the reference's formulation makes
// ≈ 1,960 integer compares a pair there, every slot against every probe
// slot, zero or not. What the data needs is the compares of its non-zero
// probes: (non-zero selector probes) x L + (non-zero ports) x NP a pair,
// 2 Tl a non-zero taint for a group that does not tolerate all, and R + 2
// for resources and gates. The design does exactly those, from shared
// memory, and nothing else of note.
//
// Contract (checked by the Python wrapper and, for the sizes, here): the
// planes of the checks asked for, contiguous, i32 hashes and counts, bool
// flags as bytes; the others may be null. Returns the CUDA error
// (cudaErrorInvalidValue for a size or a shared-memory need it does not
// take).

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
// a group row's flags word
constexpr int kTolerateAll = 1, kValid = 2, kInMask = 4;

constexpr int kTile = 128;  // nodes a CTA, a thread each
constexpr int kGroups = 8;  // groups a CTA
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxWidth = 1 << 20;

enum Field {
  kLabelHash, kTaintExact, kTaintKey, kUsedPorts, kNodeValid, kReady, kSchedulable, kCap, kAlloc,
  kSelReq, kSelNeg, kTolExact, kTolKey, kTolerateAllPlane, kPortHash, kGroupValid, kReq,
  kGroupMask, kOut, kNumFields
};
enum Dim { dN, dG, dL, dT, dNP, dR, dS, dA, dSn, dTl, dPP, kNumDims };

// word offsets of a node row and of a group row in shared memory
struct Layout {
  int lab, te, tk, port, fr, node_words;  // node_words odd, or 0
  int sel, neg, tex, tky, gport, req, flags, group_words;
  int64_t smem;                            // bytes a CTA; the offsets hold
                                           // only where it fits a CTA
};

Layout layout(const int* d, int checks) {
  int64_t o[11] = {};
  int64_t w = 0, v = 0;
  const int64_t node[5] = {checks & kSelector ? d[dL] : 0, checks & kTaints ? d[dT] : 0,
                           checks & kTaints ? d[dT] : 0, checks & kPorts ? d[dNP] : 0,
                           checks & kResources ? d[dR] : 0};
  for (int i = 0; i < 5; ++i) {
    o[i] = w;
    w += node[i];
  }
  const int64_t group[6] = {
      checks & kSelector ? static_cast<int64_t>(d[dS]) * d[dA] : 0, checks & kSelector ? d[dSn] : 0,
      checks & kTaints ? d[dTl] : 0, checks & kTaints ? d[dTl] : 0, checks & kPorts ? d[dPP] : 0,
      checks & kResources ? d[dR] : 0};
  for (int i = 0; i < 6; ++i) {
    o[5 + i] = v;
    v += group[i];
  }
  const int64_t node_words = w ? (w | 1) : 0;
  Layout y{};
  y.lab = static_cast<int>(o[0]);
  y.te = static_cast<int>(o[1]);
  y.tk = static_cast<int>(o[2]);
  y.port = static_cast<int>(o[3]);
  y.fr = static_cast<int>(o[4]);
  y.node_words = static_cast<int>(node_words);
  y.sel = static_cast<int>(o[5]);
  y.neg = static_cast<int>(o[6]);
  y.tex = static_cast<int>(o[7]);
  y.tky = static_cast<int>(o[8]);
  y.gport = static_cast<int>(o[9]);
  y.req = static_cast<int>(o[10]);
  y.flags = static_cast<int>(v);
  y.group_words = static_cast<int>(v + 1);
  y.smem = (kTile * node_words + kGroups * (v + 1)) * 4;
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
  void* out;
  int N, G, L, T, NP, R, S, A, Sn, Tl, PP;
  int checks, bits;
  Layout y;
};

// rows [0, rows) of a contiguous [rows, width] slice into shared memory at
// `stride` words a row from word `off`
__device__ void stage(int* dst, int stride, int off, const int32_t* src, int rows, int width) {
  for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
    const int r = i / width;
    dst[r * stride + off + (i - r * width)] = src[i];
  }
}

// whether non-zero `probe` is among row[0, k)
__device__ __forceinline__ bool has(const int* row, int k, int probe) {
  bool hit = false;
  for (int i = 0; i < k; ++i) hit |= row[i] == probe;
  return hit;
}

__global__ void __launch_bounds__(kTile) plane_kernel(const Args a) {
  extern __shared__ int smem[];
  const Layout y = a.y;
  int* nodes = smem;                          // [kTile][node_words]
  int* groups = smem + kTile * y.node_words;  // [kGroups][group_words]
  const int n0 = blockIdx.x * kTile;
  const int g0 = blockIdx.y * kGroups;
  const int nt = min(kTile, a.N - n0);
  const int gt = min(kGroups, a.G - g0);
  const int W = y.node_words, GW = y.group_words;

  if (a.checks & kSelector) {
    stage(nodes, W, y.lab, a.lab + static_cast<int64_t>(n0) * a.L, nt, a.L);
    stage(groups, GW, y.sel, a.sel + static_cast<int64_t>(g0) * a.S * a.A, gt, a.S * a.A);
    stage(groups, GW, y.neg, a.neg + static_cast<int64_t>(g0) * a.Sn, gt, a.Sn);
  }
  if (a.checks & kTaints) {
    stage(nodes, W, y.te, a.te + static_cast<int64_t>(n0) * a.T, nt, a.T);
    stage(nodes, W, y.tk, a.tk + static_cast<int64_t>(n0) * a.T, nt, a.T);
    stage(groups, GW, y.tex, a.tex + static_cast<int64_t>(g0) * a.Tl, gt, a.Tl);
    stage(groups, GW, y.tky, a.tky + static_cast<int64_t>(g0) * a.Tl, gt, a.Tl);
  }
  if (a.checks & kPorts) {
    stage(nodes, W, y.port, a.ports + static_cast<int64_t>(n0) * a.NP, nt, a.NP);
    stage(groups, GW, y.gport, a.gport + static_cast<int64_t>(g0) * a.PP, gt, a.PP);
  }
  if (a.checks & kResources) {
    const int64_t base = static_cast<int64_t>(n0) * a.R;
    for (int i = threadIdx.x; i < nt * a.R; i += blockDim.x) {
      const int r = i / a.R;
      // cap - alloc, wrapping as int32 arithmetic does on the card's tensors
      nodes[r * W + y.fr + (i - r * a.R)] = static_cast<int>(
          static_cast<uint32_t>(a.cap[base + i]) - static_cast<uint32_t>(a.alloc[base + i]));
    }
    stage(groups, GW, y.req, a.req + static_cast<int64_t>(g0) * a.R, gt, a.R);
  }
  for (int j = threadIdx.x; j < gt; j += blockDim.x) {
    const int g = g0 + j;
    int f = 0;
    if ((a.checks & kTaints) && a.tol_all[g]) f |= kTolerateAll;
    if ((a.checks & kGates) && a.gvalid[g]) f |= kValid;
    if (a.gmask == nullptr || a.gmask[g]) f |= kInMask;
    groups[j * GW + y.flags] = f;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < nt; t += blockDim.x) {
    const int n = n0 + t;
    const int* row = nodes + t * W;
    const bool up = !(a.checks & kGates) || (a.nvalid[n] && a.ready[n] && a.sched[n]);
    for (int j = 0; j < gt; ++j) {
      const int* gr = groups + j * GW;
      const int f = gr[y.flags];
      int bits = 0;
      if (a.checks & kSelector) {
        bool fail = false;
        for (int s = 0; s < a.S && !fail; ++s) {
          bool active = false, sat = false;
          for (int k = 0; k < a.A; ++k) {
            const int p = gr[y.sel + s * a.A + k];
            if (p != 0) {
              active = true;
              if (!sat) sat = has(row + y.lab, a.L, p);
            }
          }
          fail = active && !sat;
        }
        for (int k = 0; k < a.Sn && !fail; ++k) {
          const int p = gr[y.neg + k];
          if (p != 0) fail = has(row + y.lab, a.L, p);
        }
        if (fail) bits |= kReasonSelector;
      }
      if ((a.checks & kTaints) && !(f & kTolerateAll)) {
        for (int k = 0; k < a.T; ++k) {
          const int te = row[y.te + k];
          if (te == 0) continue;
          const int tk = row[y.tk + k];
          bool covered = false;
          for (int l = 0; l < a.Tl && !covered; ++l)
            covered = gr[y.tex + l] == te || (tk != 0 && gr[y.tky + l] == tk);
          if (!covered) {
            bits |= kReasonTaint;
            break;
          }
        }
      }
      if (a.checks & kPorts) {
        for (int k = 0; k < a.PP; ++k) {
          const int p = gr[y.gport + k];
          if (p != 0 && has(row + y.port, a.NP, p)) {
            bits |= kReasonPorts;
            break;
          }
        }
      }
      if (a.checks & kResources) {
        for (int r = 0; r < a.R; ++r)
          if (gr[y.req + r] > row[y.fr + r]) bits |= r < kNumStandard ? 1 << r : kReasonExtended;
      }
      if (a.checks & kGates) {
        if (!up) bits |= kReasonNodeUnavailable;
        if (!(f & kValid)) bits |= kReasonGroupInvalid;
      }
      const int64_t o = static_cast<int64_t>(g0 + j) * a.N + n;
      if (a.bits)
        static_cast<uint16_t*>(a.out)[o] = (f & kInMask) ? static_cast<uint16_t>(bits) : 0;
      else
        static_cast<uint8_t*>(a.out)[o] = (f & kInMask) && bits == 0;
    }
  }
}

std::atomic<int> smem_opted_in{48 * 1024};

}  // namespace

// The dynamic shared memory a CTA takes at these widths and checks (dims in
// the Dim order), or -1 for widths it does not take.
extern "C" int64_t ka_pred_smem(const int* d, int checks) {
  for (int i = 0; i < kNumDims; ++i)
    if (d[i] < 0 || d[i] > (i <= dG ? (1 << 30) : kMaxWidth)) return -1;
  return layout(d, checks).smem;
}

// One launch: p holds the Field pointers (null where no check asked for
// reads them; group_mask null for every row), d the Dim widths; `bits`
// selects uint16 refusal bits, else bool feasibility. Enqueued on `stream_`;
// nothing is read back.
extern "C" int ka_pred_plane(void* const* p, const int* d, int checks, int bits, void* stream_) {
  if (checks <= 0 || (checks & ~kAllChecks)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t need = ka_pred_smem(d, checks);
  if (need < 0 || need > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(need);
  if (d[dN] == 0 || d[dG] == 0) return 0;
  const int64_t gy = (static_cast<int64_t>(d[dG]) + kGroups - 1) / kGroups;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (p[kOut] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int needs[5][5] = {{kLabelHash, kSelReq, kSelNeg, -1, -1},
                           {kTaintExact, kTaintKey, kTolExact, kTolKey, kTolerateAllPlane},
                           {kUsedPorts, kPortHash, -1, -1, -1},
                           {kCap, kAlloc, kReq, -1, -1},
                           {kNodeValid, kReady, kSchedulable, kGroupValid, -1}};
  for (int c = 0; c < 5; ++c) {
    if (!(checks & (1 << c))) continue;
    for (int k = 0; k < 5; ++k)
      if (needs[c][k] >= 0 && p[needs[c][k]] == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > smem_opted_in.load()) {
    const cudaError_t err =
        cudaFuncSetAttribute(plane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_opted_in.store(smem);
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
  a.y = layout(d, checks);
  const dim3 grid((d[dN] + kTile - 1) / kTile, static_cast<unsigned>(gy));
  plane_kernel<<<grid, kTile, smem, static_cast<cudaStream_t>(stream_)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
