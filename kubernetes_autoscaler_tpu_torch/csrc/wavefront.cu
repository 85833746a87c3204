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
//     placed[g,:] = place
// and at the end of the wave free[n,:] -= sum over the wave's slots of
// place[n] * req[g,:] (int32, wrapping). A group occupies at most one slot
// of the plan, so its remaining count at its slot is its count. Rows of
// groups in no slot are zero; scheduled[g] = sum(placed[g,:]).
//
// What bounds it. The bytes are small (the placed writes, G*N int32, plus
// the free capacity in and out: about 1.7 MB at G=64, N=5120, R=8, a
// fraction of a microsecond of device memory time). The bound is serial
// depth: waves go one after another, each a prefix sum over the node lanes
// per slot and a summed update of the free plane. What a wave costs is the
// chain of latencies on that path, so the design keeps every read on it in
// the SM's own shared memory except one exchange of per-CTA totals, and
// crosses CTAs with one cluster barrier a wave (tools/torch_wavefront_trace.py
// prints the cycles of each step).
//
// The design. One thread-block cluster of C CTAs (C = 16 where the card can
// schedule a cluster that size at this launch's threads and shared memory,
// else 8; see ka_wavefront_config). CTA c owns the node lanes [c*ceil(N/C),
// (c+1)*ceil(N/C)) and keeps its lanes of the working free plane in its
// own shared memory, so every fit reads a local value and every update
// writes one. The prologue is spread over the cluster: each CTA stages its
// lanes of the plane, ORs its lanes of the mask into "some lane is
// feasible" words and stores them into every CTA's shared memory
// (distributed shared memory stores, before the first cluster barrier),
// and lists the live slots of every wave (a slot is live
// when its group's count is negative, or positive with a mask bit
// somewhere in the row); the CTA keeps its lanes' mask words, and each
// group's requested resources with their divisor codes. Those independent
// loads run in four roles of warps at once. A wave is
// then, in every CTA at once, for every live slot of the wave (a warp per
// slot and chunk of 32 own lanes):
//  1. the chunk's fits (the division-free fit of pack_row.cuh: a multiply
//     and a shift per requested resource) and their warp prefix, saturated
//     at the count (pack_row.cuh's u32 scan, exact below the count); a
//     warp scans its first kKeep tasks side by side and keeps their
//     prefixes in registers for step 4, and recomputes any later ones
//     there;
//  2. per slot, the chunks' offsets and this CTA's total, stored into every
//     CTA's shared memory (distributed shared memory stores);
//  3. one cluster barrier (barrier.cluster arrive.release / wait.acquire);
//     each slot's offset is the saturated sum of the lower CTAs' totals,
//     now in the CTA's own shared memory (rank 0 writes scheduled);
//  4. each lane's place = min(off + incl, c) - min(off + excl, c), stored
//     into its placed row, and place * req summed into a per-lane delta by
//     shared-memory integer adds (order-free, so overlapping slots and
//     negative counts need nothing more);
//  5. free -= delta on the CTA's own lanes.
// Steps 1, 2, 4 and 5 end with __syncthreads; the totals alternate between
// two buffers from wave to wave, so the one cluster barrier a wave orders
// them, and after a live wave's barrier no CTA touches another's shared
// memory, so no barrier ends the kernel. A negative count places the count on
// every lane with no scan, as K1 does. A wave with no live slot costs
// nothing. All CTAs then zero, whole rows dealt round-robin, the rows of
// groups that place nothing (in no slot, count 0, or a positive count and
// an empty mask); stores of many CTAs into one row at once were measured
// several times slower. K1's one-CTA row pass (pack.cu) is not reused
// whole: a slot's row spans the cluster here, and the slots of a wave run
// side by side in one CTA; its division-free fit and saturating scan are.
// Where a CTA's lanes of the plane and the delta (8*R bytes a lane) do not
// fit its shared memory (N beyond about 42,000 lanes at C=16, G=64, R=8)
// the plane stays in free_after, and step 5 reads the wave's placed rows
// back instead of a shared delta. Then the metadata, the mask words
// and the chunk sums (about 24*G*R + 24*G + 8*G*C + 4*W + G*ceil(N/C)/4
// bytes) bound N: about 210,000 lanes at C=16, G=64, R=8. PERF.md gives the measured
// times.
//
// Contract (checked by the Python wrapper): int32 tensors, contiguous,
// free [N,R], mask_bits [ceil(G/32),N], req [G,R], count/limit_one [G],
// waves [W,S] with every id in [-1,G) and no group in two slots; outputs
// placed [G,N], free_after [N,R], scheduled [G]. A launch whose shared
// memory exceeds the opt-in limit is refused (cudaErrorInvalidValue).
// `cluster` 0 lets the launcher choose C, 1 to 16 forces it; `placement` 0
// lets it choose where the plane lives, 1 forces device memory, 2 shared
// memory. Launches on the given stream and returns the launch's error, or
// cudaGetLastError(): a cluster that cannot be scheduled is an error,
// never a quiet fallback.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

#include "pack_row.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ka;

constexpr int kMaxCluster = 16;  // non-portable: needs 16 SMs of one GPC free
constexpr int kKeep = 2;         // tasks a warp keeps in registers across a wave
constexpr int kPortableCluster = 8;

// byte offsets of the shared-memory arrays, in order
struct Layout {
  size_t req, mul, shift, fr, fmul, fshift, nfit, cnt, lim, live, list, off, base, tot, any,
      any_cta, chunk, maskw, delta, free, end;
};

// C: the cluster's CTAs; per: the lanes a CTA owns; plane_smem: the working
// free plane and the wave's delta in shared memory (else the plane stays in
// free_after)
__host__ __device__ inline Layout layout(int G, int R, int W, int C, int per, bool plane_smem) {
  const size_t gr = static_cast<size_t>(G) * R * sizeof(int);
  const size_t g = static_cast<size_t>(G) * sizeof(int);
  const size_t words = static_cast<size_t>((G + 31) >> 5) * sizeof(unsigned);
  const size_t chunks = static_cast<size_t>(G) * ((per + 31) >> 5) * sizeof(unsigned);
  const size_t plane = plane_smem ? static_cast<size_t>(R) * per * sizeof(int) : 0;
  Layout l;
  l.req = 0;
  l.mul = l.req + gr;
  l.shift = l.mul + gr;
  l.fr = l.shift + gr;
  l.fmul = l.fr + gr;
  l.fshift = l.fmul + gr;
  l.nfit = l.fshift + gr;
  l.cnt = l.nfit + g;
  l.lim = l.cnt + g;
  l.live = l.lim + g;
  l.list = l.live + g;
  l.off = l.list + g;
  l.base = l.off + (static_cast<size_t>(W) + 1) * sizeof(int);
  l.tot = l.base + g;
  l.any = l.tot + 2 * g * C;
  l.any_cta = l.any + words;
  l.chunk = l.any_cta + words * C;
  l.maskw = l.chunk + chunks;
  l.delta = l.maskw + ((G + 31) >> 5) * static_cast<size_t>(per) * sizeof(unsigned);
  l.free = l.delta + plane;
  l.end = l.free + plane;
  return l;
}

template <bool kSmem>
__global__ void __launch_bounds__(kMaxThreads, 1)
wavefront_kernel(const int* __restrict__ free_in, const int* __restrict__ mask_bits,
                 const int* __restrict__ req, const int* __restrict__ count,
                 const int* __restrict__ limit_one, const int* __restrict__ waves,
                 int* __restrict__ placed, int* __restrict__ free_after,
                 int* __restrict__ scheduled, int G, int N, int R, int W, int S) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // this CTA's lanes: [n0, n0 + m), in chunks of 32
  const int per = (N + C - 1) / C;
  const int n0 = min(rank * per, N);
  const int m = min(n0 + per, N) - n0;
  const int nchunk = (per + 31) >> 5;  // the layout's chunks a slot (every CTA's)
  const int mchunk = (m + 31) >> 5;    // this CTA's

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L = layout(G, R, W, C, per, kSmem);
  int* req_s = reinterpret_cast<int*>(smem_raw + L.req);              // [G*R]
  unsigned* mul_s = reinterpret_cast<unsigned*>(smem_raw + L.mul);    // [G*R] divisor codes
  int* shift_s = reinterpret_cast<int*>(smem_raw + L.shift);          // [G*R]
  // the fit's resources of group g, req > 0 only: fr_s[g*R + k], k < nfit_s[g],
  // with their divisor codes
  int* fr_s = reinterpret_cast<int*>(smem_raw + L.fr);                // [G*R]
  unsigned* fmul_s = reinterpret_cast<unsigned*>(smem_raw + L.fmul);  // [G*R]
  int* fshift_s = reinterpret_cast<int*>(smem_raw + L.fshift);        // [G*R]
  int* nfit_s = reinterpret_cast<int*>(smem_raw + L.nfit);            // [G]
  int* cnt_s = reinterpret_cast<int*>(smem_raw + L.cnt);              // [G]
  int* lim_s = reinterpret_cast<int*>(smem_raw + L.lim);              // [G]
  int* live_s = reinterpret_cast<int*>(smem_raw + L.live);            // [G] in a slot, then live
  int* list_s = reinterpret_cast<int*>(smem_raw + L.list);            // [G] live slots, wave by wave
  int* off_s = reinterpret_cast<int*>(smem_raw + L.off);              // [W+1] wave w: list_s[off[w]..off[w+1])
  unsigned* base_s = reinterpret_cast<unsigned*>(smem_raw + L.base);  // [G] a slot's places on lower CTAs' lanes
  unsigned* tot_s = reinterpret_cast<unsigned*>(smem_raw + L.tot);    // [2][G][C] a slot's places on each CTA's lanes
  unsigned* any_s = reinterpret_cast<unsigned*>(smem_raw + L.any);    // [nwords] this CTA's lanes
  unsigned* any_cta = reinterpret_cast<unsigned*>(smem_raw + L.any_cta);  // [C][nwords] every CTA's any_s
  unsigned* chunk_s = reinterpret_cast<unsigned*>(smem_raw + L.chunk);  // [G][nchunk] a wave's chunk sums, then offsets
  unsigned* maskw_s = reinterpret_cast<unsigned*>(smem_raw + L.maskw);  // [nwords][per] mask words, own lanes
  int* delta_s = reinterpret_cast<int*>(smem_raw + L.delta);          // [R][per] the wave's update (kSmem)
  int* free_s = reinterpret_cast<int*>(smem_raw + L.free);            // [R][per] the plane (kSmem)

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int nwords = (G + 31) >> 5;

  // the working free capacity of this CTA's lane j
  auto plane = [&](int j, int r) -> int& {
    return kSmem ? free_s[r * per + j] : free_after[static_cast<size_t>(n0 + j) * R + r];
  };
  // the fit of group g (count cap > 0) at this CTA's lane j: the mask bit,
  // then min over the requested resources of the division-free quotient,
  // the one-per-node cap and the count
  auto fit = [&](int g, int j, unsigned cap) -> unsigned {
    unsigned x = 0;
    if (j < m && ((maskw_s[(g >> 5) * per + j] >> (g & 31)) & 1u)) {
      x = kBig;
      const int nf = nfit_s[g];
      for (int k = 0; k < nf; ++k) {
        const int q = g * R + k;
        x = min(x, quotient(plane(j, fr_s[q]), fmul_s[q], fshift_s[q]));
      }
    }
    if (lim_s[g]) x = min(x, 1u);
    return min(x, cap);
  };

  // ---- prologue: what the cluster knows before the first wave. Its
  // independent loads go to four roles of warps (one when the CTA has
  // fewer than 4 warps), so their latencies overlap instead of adding up.
  for (int i = tid; i < G; i += nthreads) live_s[i] = 0;
  for (int i = tid; i < nwords; i += nthreads) any_s[i] = 0;
  if (kSmem)
    for (int i = tid; i < R * per; i += nthreads) delta_s[i] = 0;
  __syncthreads();
  const int nroles = nwarps >= 4 ? 4 : 1;
  const int role = warp % nroles;
  const int rtid = (warp / nroles) * 32 + lane;
  const int rthreads = ((nwarps - role + nroles - 1) / nroles) * 32;
  for (int rl = 0; rl < 4; ++rl) {
    if (nroles > 1 && rl != role) continue;
    if (rl == 0) {  // requests and their divisor codes, one (group, resource) a thread
      for (int i = rtid; i < G * R; i += rthreads) {
        const int d = req[i];
        req_s[i] = d;
        unsigned mu;
        int sh;
        divisor(d, mu, sh);
        mul_s[i] = mu;
        shift_s[i] = sh;
      }
    } else if (rl == 1) {  // counts, limits, and which groups sit in a slot
      for (int i = rtid; i < G; i += rthreads) {
        cnt_s[i] = count[i];
        lim_s[i] = limit_one[i];
      }
      for (int i = rtid; i < W * S; i += rthreads) {
        const int g = waves[i];
        if (g >= 0) live_s[g] = 1;  // every writer writes 1
      }
    } else if (rl == 2) {  // this CTA's lanes of the plane
      for (int i = rtid; i < m * R; i += rthreads) {
        const int j = i / R, r = i - j * R;
        plane(j, r) = free_in[static_cast<size_t>(n0) * R + i];
      }
    } else {  // this CTA's mask words, and their OR
      for (int c = 0; c < nwords; ++c) {
        const int* src = mask_bits + static_cast<size_t>(c) * N + n0;
        unsigned acc = 0;
        for (int j = rtid; j < m; j += rthreads) {
          const unsigned v = static_cast<unsigned>(src[j]);
          maskw_s[c * per + j] = v;
          acc |= v;
        }
        acc = __reduce_or_sync(kFullMask, acc);
        if (lane == 0 && acc) atomicOr(&any_s[c], acc);
      }
    }
  }
  __syncthreads();  // any_s is complete: into every CTA's any_cta
  for (int i = tid; i < C * nwords; i += nthreads) {
    const int q = i / nwords, c = i - q * nwords;
    cluster.map_shared_rank(any_cta, q)[rank * nwords + c] = any_s[c];
  }
  cluster.sync();  // every CTA's any_s has arrived
  for (int g = tid; g < G; g += nthreads) {
    unsigned a = 0;
    for (int q = 0; q < C; ++q) a |= any_cta[q * nwords + (g >> 5)];
    const int cnt = cnt_s[g];
    live_s[g] = live_s[g] && cnt != 0 && (cnt < 0 || ((a >> (g & 31)) & 1u));
    // the fit list: the requested resources with their divisor codes
    int nf = 0;
    for (int r = 0; r < R; ++r) {
      const int q = g * R + r;
      if (req_s[q] <= 0) continue;
      fr_s[g * R + nf] = r;
      fmul_s[g * R + nf] = mul_s[q];
      fshift_s[g * R + nf] = shift_s[q];
      ++nf;
    }
    nfit_s[g] = nf;
  }
  __syncthreads();
  // the live slots of every wave, in slot order: counts, offsets, ids
  for (int w = warp; w < W; w += nwarps) {
    int nl = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const int g = s < S ? waves[static_cast<size_t>(w) * S + s] : -1;
      nl += __popc(__ballot_sync(kFullMask, g >= 0 && live_s[g]));
    }
    if (lane == 0) off_s[w + 1] = nl;
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    if (lane == 0) off_s[0] = 0;
    for (int w0 = 0; w0 < W; w0 += 32) {
      int x = w0 + lane < W ? off_s[w0 + lane + 1] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFullMask, x, o);
        if (lane >= o) x += y;
      }
      if (w0 + lane < W) off_s[w0 + lane + 1] = carry + x;
      carry += __shfl_sync(kFullMask, x, 31);
    }
  }
  __syncthreads();
  for (int w = warp; w < W; w += nwarps) {
    int at = off_s[w];
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const int g = s < S ? waves[static_cast<size_t>(w) * S + s] : -1;
      const bool is_live = g >= 0 && live_s[g];
      const unsigned bal = __ballot_sync(kFullMask, is_live);
      if (is_live) list_s[at + __popc(bal & ((1u << lane) - 1u))] = g;
      at += __popc(bal);
    }
  }
  __syncthreads();
  // task t of a wave = (slot t / mchunk, chunk t % mchunk), split without a
  // division by mchunk's codes (t < 2^31)
  unsigned mc_mul;
  int mc_shift;
  divisor(mchunk, mc_mul, mc_shift);
  auto slot_of = [&](int t) -> int {
    return mc_shift == kIdentity ? t : static_cast<int>(__umulhi(static_cast<unsigned>(t), mc_mul) >> mc_shift);
  };

  // ---- the waves: every slot of a wave against the wave-start capacity
  unsigned buf = 0;  // which half of tot_s this wave writes
  bool synced = false;
  for (int w = 0; w < W; ++w) {
    const int b0 = off_s[w];
    const int nl = off_s[w + 1] - b0;
    if (nl == 0) continue;  // cluster-uniform
    const int ntask = nl * mchunk;

    // the prefix of task t (a chunk of 32 own lanes of one slot) at this
    // lane: the chunk's fits summed up to it, saturated at the count; false
    // for a negative count (warp-uniform), which places the count everywhere
    auto prefix = [&](int t, unsigned& incl, unsigned& excl) -> bool {
      const int s = slot_of(t), c = t - s * mchunk;
      const int cnt = cnt_s[list_s[b0 + s]];
      if (cnt < 0) return false;
      const unsigned cap = static_cast<unsigned>(cnt);
      incl = warp_scan_sat(fit(list_s[b0 + s], 32 * c + lane, cap), cap, lane);
      const unsigned before = __shfl_up_sync(kFullMask, incl, 1);
      excl = lane ? before : 0u;
      return true;
    };

    // 1. each task: the chunk's sum. A warp's first kKeep tasks compute
    // their fits first, scan side by side and keep their prefixes in
    // registers for step 4.
    unsigned keep_incl[kKeep], keep_excl[kKeep], keep_cap[kKeep];
#pragma unroll
    for (int k = 0; k < kKeep; ++k) {
      const int t = warp + k * nwarps;
      keep_incl[k] = 0;
      keep_cap[k] = 0;
      if (t < ntask) {
        const int s = slot_of(t);
        const int g = list_s[b0 + s];
        const int cnt = cnt_s[g];
        if (cnt >= 0) {
          keep_cap[k] = static_cast<unsigned>(cnt);
          keep_incl[k] = fit(g, 32 * (t - s * mchunk) + lane, keep_cap[k]);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < kKeep; ++k) {
        const unsigned y = __shfl_up_sync(kFullMask, keep_incl[k], off);
        if (lane >= off) keep_incl[k] = min(keep_incl[k] + y, keep_cap[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kKeep; ++k) {
      const int t = warp + k * nwarps;
      const unsigned before = __shfl_up_sync(kFullMask, keep_incl[k], 1);
      keep_excl[k] = lane ? before : 0u;
      if (t < ntask && lane == 31) {
        const int s = slot_of(t);
        if (cnt_s[list_s[b0 + s]] >= 0) chunk_s[s * nchunk + t - s * mchunk] = keep_incl[k];
      }
    }
    for (int t = warp + kKeep * nwarps; t < ntask; t += nwarps) {
      unsigned incl, excl;
      if (prefix(t, incl, excl) && lane == 31) {
        const int s = slot_of(t);
        chunk_s[s * nchunk + t - s * mchunk] = incl;
      }
    }
    __syncthreads();
    // 2. each slot: its chunks' exclusive offsets and this CTA's total
    for (int s = warp; s < nl; s += nwarps) {
      const int cnt = cnt_s[list_s[b0 + s]];
      unsigned carry = 0;
      if (cnt > 0) {
        const unsigned cap = static_cast<unsigned>(cnt);
        for (int c0 = 0; c0 < mchunk; c0 += 32) {
          const int c = c0 + lane;
          const unsigned incl =
              warp_scan_sat(c < mchunk ? chunk_s[s * nchunk + c] : 0u, cap, lane);
          const unsigned before = __shfl_up_sync(kFullMask, incl, 1);
          if (c < mchunk) chunk_s[s * nchunk + c] = min(carry + (lane ? before : 0u), cap);
          carry = min(carry + __shfl_sync(kFullMask, incl, 31), cap);
        }
      }
      // into every CTA's shared memory, so that step 3 reads only its own
      if (lane < C) cluster.map_shared_rank(tot_s, lane)[(buf * G + s) * C + rank] = carry;
    }
    cluster.sync();  // every CTA's totals of the wave are in
    // 3. each slot: the places on lower CTAs' lanes; rank 0 writes scheduled
    for (int s = warp; s < nl; s += nwarps) {
      const int g = list_s[b0 + s];
      const int cnt = cnt_s[g];
      if (cnt < 0) {
        if (rank == 0 && lane == 0) scheduled[g] = mul_wrap(cnt, N);
        continue;
      }
      const unsigned cap = static_cast<unsigned>(cnt);
      unsigned below, all;
      const unsigned v = lane < C ? tot_s[(buf * G + s) * C + lane] : 0u;
      below = warp_sum_sat(lane < rank ? v : 0u, cap);
      all = warp_sum_sat(v, cap);
      if (lane == 0) {
        base_s[s] = below;
        if (rank == 0) scheduled[g] = static_cast<int>(all);
      }
    }
    __syncthreads();
    // 4. each task: its places, stored; with kSmem the wave's update
    // summed into delta (integer adds, in any order)
    auto place_task = [&](int t, bool scanned, unsigned incl, unsigned excl) {
      const int s = slot_of(t), c = t - s * mchunk, j = 32 * c + lane;
      const int g = list_s[b0 + s];
      const int cnt = cnt_s[g];
      int place = cnt;  // a negative count: the count on every lane
      if (cnt >= 0) {
        if (!scanned) prefix(t, incl, excl);
        const unsigned cap = static_cast<unsigned>(cnt);
        const unsigned off = min(base_s[s] + chunk_s[s * nchunk + c], cap);
        place = static_cast<int>(min(off + incl, cap) - min(off + excl, cap));
      }
      if (j < m) {
        placed[static_cast<size_t>(g) * N + n0 + j] = place;
        if (kSmem && place != 0) {
          const int* rq = req_s + g * R;
          for (int r = 0; r < R; ++r)
            if (rq[r] != 0) atomicAdd(&delta_s[r * per + j], mul_wrap(place, rq[r]));
        }
      }
    };
#pragma unroll
    for (int k = 0; k < kKeep; ++k) {
      const int t = warp + k * nwarps;
      if (t < ntask) place_task(t, true, keep_incl[k], keep_excl[k]);
    }
    for (int t = warp + kKeep * nwarps; t < ntask; t += nwarps) place_task(t, false, 0u, 0u);
    __syncthreads();
    // 5. this CTA's lanes drop by the wave's summed placements
    for (int j = tid; j < m; j += nthreads) {
      if (kSmem) {
        for (int r = 0; r < R; ++r) {
          free_s[r * per + j] -= delta_s[r * per + j];
          delta_s[r * per + j] = 0;
        }
      } else {  // read the wave's rows back, four slots' loads in flight
        for (int l0 = 0; l0 < nl; l0 += 4) {
          int p[4], gs[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            gs[u] = l0 + u < nl ? list_s[b0 + l0 + u] : -1;
            p[u] = gs[u] >= 0 ? placed[static_cast<size_t>(gs[u]) * N + n0 + j] : 0;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (p[u] == 0) continue;
            const int* rq = req_s + gs[u] * R;
            for (int r = 0; r < R; ++r)
              if (rq[r] != 0) plane(j, r) -= mul_wrap(p[u], rq[r]);
          }
        }
      }
    }
    __syncthreads();
    buf ^= 1u;
    synced = true;
  }

  // ---- epilogue: the rows that place nothing are zero, whole rows dealt
  // round-robin to the CTAs (CTAs storing into one row at once drain
  // several times slower), and the plane goes out
  for (int g = rank; g < G; g += C) {
    if (live_s[g]) continue;
    int* grow = placed + static_cast<size_t>(g) * N;
#pragma unroll 8
    for (int n = tid; n < N; n += nthreads) grow[n] = 0;
    if (tid == 0) scheduled[g] = 0;
  }
  if (kSmem) {
    for (int i = tid; i < m * R; i += nthreads) {
      const int j = i / R, r = i - j * R;
      free_after[static_cast<size_t>(n0) * R + i] = free_s[r * per + j];
    }
  }
  // no CTA may leave while another can still store into its shared memory:
  // every remote store (any_cta, tot_s) comes before a barrier all pass
  if (!synced) cluster.sync();
}

using KernelFn = void (*)(const int*, const int*, const int*, const int*, const int*,
                          const int*, int*, int*, int*, int, int, int, int, int);
// [kSmem]
const KernelFn kKernels[2] = {wavefront_kernel<false>, wavefront_kernel<true>};

// Per device and kernel, read or set once and reused by later launches:
// the opt-in shared-memory limit (0 until read), the dynamic shared memory
// the kernel's attribute allows so far, whether clusters above 8 are
// allowed, and the cluster size chosen with the largest threads and shared
// memory asked so far (a smaller launch fits wherever a larger one does).
constexpr int kMaxDevices = 64;
struct Cached {
  size_t smem_allowed;
  bool nonportable;
  int cluster;  // 0 until chosen
  int cluster_threads;
  size_t cluster_smem;
};
std::mutex g_mu;
int g_max_smem[kMaxDevices];
Cached g_cached[kMaxDevices][2];

cudaLaunchConfig_t launch_config(int C, int threads, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(C));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(C);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the kernel's attributes for `smem` bytes and clusters above 8, set once
cudaError_t allow(Cached& c, KernelFn fn, size_t smem) {
  cudaError_t err;
  if (smem > c.smem_allowed) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    c.smem_allowed = smem;
  }
  if (!c.nonportable) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    c.nonportable = true;
  }
  return cudaSuccess;
}

struct Launch {
  KernelFn kernel;
  int cluster, threads, smem_plane;
  size_t smem;
};

// The kernel, cluster size, threads, free-plane placement and shared
// memory of a launch; sets the kernel's attributes as needed. `cluster` 0
// chooses C (16 where the card can schedule it, else 8); `placement` 0
// chooses where each CTA keeps its lanes of the working free plane (in its
// shared memory where they fit beside the metadata, else in free_after), 1
// forces device memory, 2 shared memory.
cudaError_t prepare(int G, int N, int R, int W, int cluster, int placement, Launch* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cluster < 0 || cluster > kMaxCluster || placement < 0 || placement > 2)
    return cudaErrorInvalidValue;
  int K;  // threads as K1 sizes a CTA for a row of N lanes; K itself is unused
  row_shape(N, K, out->threads);

  std::lock_guard<std::mutex> lock(g_mu);
  if (g_max_smem[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_max_smem[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  const size_t max_smem = static_cast<size_t>(g_max_smem[dev]);

  // the cluster size, read once per instance at the device-memory
  // placement's shared memory for 16 CTAs
  const KernelFn base = kKernels[0];
  Cached& c0 = g_cached[dev][0];
  if (cluster > 0) {
    out->cluster = cluster;
  } else {
    const size_t meta16 = layout(G, R, W, kMaxCluster, (N + kMaxCluster - 1) / kMaxCluster, false).end;
    if (c0.cluster == 0 || out->threads > c0.cluster_threads || meta16 > c0.cluster_smem) {
      int active = 0;
      if (meta16 <= max_smem) {
        err = allow(c0, base, meta16);
        if (err != cudaSuccess) return err;
        cudaLaunchAttribute attr;
        cudaLaunchConfig_t cfg = launch_config(kMaxCluster, out->threads, meta16, nullptr, &attr);
        if (cudaOccupancyMaxActiveClusters(&active, base, &cfg) != cudaSuccess) {
          (void)cudaGetLastError();  // a size the card refuses: not an error of the launch
          active = 0;
        }
      }
      c0.cluster = active >= 1 ? kMaxCluster : kPortableCluster;
      c0.cluster_threads = out->threads;
      c0.cluster_smem = meta16;
    }
    out->cluster = c0.cluster;
  }

  const int per = (N + out->cluster - 1) / out->cluster;
  const size_t meta = layout(G, R, W, out->cluster, per, false).end;
  const size_t with_plane = layout(G, R, W, out->cluster, per, true).end;
  if (meta > max_smem || (placement == 2 && with_plane > max_smem)) return cudaErrorInvalidValue;
  out->smem_plane = placement == 2 || (placement == 0 && with_plane <= max_smem);
  out->smem = out->smem_plane ? with_plane : meta;
  out->kernel = kKernels[out->smem_plane];
  return allow(g_cached[dev][out->smem_plane], out->kernel, out->smem);
}

}  // namespace

// What a launch on these shapes would use on the current device: out[0] the
// cluster size C (the CTAs launched), out[1] the threads of a CTA, out[2]
// the bytes of dynamic shared memory, out[3] 1 where each CTA keeps its
// lanes of the working free plane in shared memory, 0 in device memory. Returns a CUDA error
// code.
extern "C" int ka_wavefront_config(int G, int N, int R, int W, int cluster, int placement,
                                   int* out) {
  Launch l;
  const cudaError_t err = prepare(G, N, R, W, cluster, placement, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = l.cluster;
  out[1] = l.threads;
  out[2] = static_cast<int>(l.smem);
  out[3] = l.smem_plane;
  return 0;
}

extern "C" int ka_pack_groups_wavefront(const void* free_in, const void* mask_bits,
                                        const void* req, const void* count,
                                        const void* limit_one, const void* waves,
                                        void* placed, void* free_after, void* scheduled,
                                        int G, int N, int R, int W, int S, int cluster,
                                        int placement, void* stream) {
  Launch l;
  cudaError_t err = prepare(G, N, R, W, cluster, placement, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(l.cluster, l.threads, l.smem, static_cast<cudaStream_t>(stream), &attr);
  void* args[] = {&free_in, &mask_bits, &req, &count, &limit_one, &waves, &placed,
                  &free_after, &scheduled, &G, &N, &R, &W, &S};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(l.kernel), args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
