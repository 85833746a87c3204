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
// A wave of a lane is csrc/waves.cuh's `place_waves` (shared with the drain
// sweep's topology mode, csrc/drain.cu), whose header gives its steps.
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
// lanes b, b + grid, ...; an inactive lane costs one flag read);
// thread t owns the contiguous nodes [tK, tK + K), K = ceil(N / threads),
// so a node's free capacity and placed count are touched by one thread
// only and need no barrier. The lane's free plane ([R][N]), placed row and
// a fit row live in shared memory when they fit the opt-in limit (N up to
// about 5,700 at R = 8, cudaFuncSetAttribute above 48 KB); else the plane
// stays in the free_out buffer, the placed row in the output and the fit
// row in a scratch buffer in device memory, as csrc/wavefront.cu keeps
// free_after, with the same code. The zone prefix walks a zone-sorted
// permutation of the nodes (computed once a call by the wrapper, as
// ops/constrained._zone_segments does). A wave costs 3 barriers (5 with
// zone caps): the min reductions, the global scan, the placed sum, and the
// segmented scan with its hand-over. No division: pack_row.cuh's
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
#include "waves.cuh"

namespace {

using namespace ka;

enum Field {
  kFreeIn, kFreeOut, kPlaced, kFeas, kReq, kWant, kLimit, kActive, kOrder,
  kSKind, kSSkew, kSSelf, kSCnt, kSElig, kAKind, kASelf, kAAny, kAOk, kAnti,
  kCzb, kEzb, kMhb, kZcl, kZval, kPerm, kSkey, kScratch, kWaves, kNumFields
};

enum Mode { kPlace = 0, kPack = 1 };

struct Params {
  const void* ptr[kNumFields];
  long long ls[kNumFields];  // lane stride in elements; 0 = shared row
};

// byte offsets of the shared-memory arrays
struct Layout {
  size_t blk, zp, zc, czb, ezb, req, mul, sh, plane, placed, fit, end;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

__host__ __device__ inline Layout layout(int N, int R, int Z, bool smem_plane) {
  Layout l;
  l.blk = 0;                                   // u32 [kBlockWords] the Block helpers
  l.zp = l.blk + kBlockWords * 4;              // i32 [Z] zone_placed
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

template <typename T>
__device__ __forceinline__ const T* at(const Params& p, Field f, int b, long long off = 0) {
  return static_cast<const T*>(p.ptr[f]) + p.ls[f] * b + off;
}

// One lane as csrc/waves.cuh's `place_waves` sees it: the lane's free plane
// ([R][N] in shared memory, [N][R] in device memory: the free_out buffer)
// and placed row, the current group's request codes and constraint rows.
template <bool kSmem>
struct ConLane {
  int* plane;
  int* P;  // the group's placed row
  int N, R, Z;
  const int* rq;
  const unsigned* mu;
  const int* sh;
  const unsigned char* feas_;
  const int* s_cnt_;
  const unsigned char* s_elig_;
  const unsigned char* a_ok_;
  const unsigned char* zval_;
  const int* zcl;

  __device__ int& F(int n, int r) const {
    return kSmem ? plane[static_cast<size_t>(r) * N + n] : plane[static_cast<size_t>(n) * R + r];
  }
  // per requested resource max(free, 0) / req, the BIG of ops/pack for a
  // resource the group does not request
  __device__ int fit_count(int n) const {
    unsigned fc = UINT_MAX;
    for (int r = 0; r < R; ++r) {
      const int s = sh[r];
      const unsigned q = s == kNoLimit ? static_cast<unsigned>(kBig) : quotient(F(n, r), mu[r], s);
      fc = min(fc, q);
    }
    return static_cast<int>(fc);
  }
  __device__ void take(int n, int place) const {
    for (int r = 0; r < R; ++r) F(n, r) -= mul_wrap(place, rq[r]);
  }
  __device__ bool feas(int n) const { return feas_[n] != 0; }
  __device__ int placed(int n) const { return P[n]; }
  __device__ void place(int n, int v) const {
    take(n, v);
    P[n] += v;
  }
  __device__ int s_cnt(int n) const { return s_cnt_[n]; }
  __device__ bool s_elig(int n) const { return s_elig_[n] != 0; }
  __device__ bool a_ok(int n) const { return a_ok_[n] != 0; }
  __device__ bool zval(int n) const { return zval_[n] != 0; }
  __device__ int zone_of(int n) const { return min(max(zcl[n], 0), Z - 1); }
};

template <bool kSmem>
__global__ void __launch_bounds__(kMaxThreads, 1)
constrained_kernel(Params p, int mode, int B, int G, int N, int R, int Z, int max_waves) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned char* active = static_cast<const unsigned char*>(p.ptr[kActive]);
  const Layout L = layout(N, R, Z, kSmem);
  Block blk(reinterpret_cast<unsigned*>(smem_raw + L.blk));
  int* zone_placed = reinterpret_cast<int*>(smem_raw + L.zp);
  int* zone_cap = reinterpret_cast<int*>(smem_raw + L.zc);
  int* czb_s = reinterpret_cast<int*>(smem_raw + L.czb);
  int* ezb_s = reinterpret_cast<int*>(smem_raw + L.ezb);
  int* req_s = reinterpret_cast<int*>(smem_raw + L.req);
  unsigned* mul_s = reinterpret_cast<unsigned*>(smem_raw + L.mul);
  int* sh_s = reinterpret_cast<int*>(smem_raw + L.sh);

  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int K = (N + T - 1) / T;
  const int n0 = min(tid * K, N);
  const int n1 = min(n0 + K, N);

  // the CTAs walk the lanes; an inactive lane costs a flag read
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    if (mode == kPlace && active != nullptr && !active[b]) continue;  // block-uniform

    const size_t NR = static_cast<size_t>(N) * R;
    int* fout = static_cast<int*>(const_cast<void*>(p.ptr[kFreeOut])) + b * NR;
    int* scratch = static_cast<int*>(const_cast<void*>(p.ptr[kScratch]));
    int* fit =
        kSmem ? reinterpret_cast<int*>(smem_raw + L.fit) : scratch + static_cast<size_t>(b) * N;
    int* placed_out = static_cast<int*>(const_cast<void*>(p.ptr[kPlaced]));
    ConLane<kSmem> lane;
    lane.plane = kSmem ? reinterpret_cast<int*>(smem_raw + L.plane) : fout;
    lane.N = N;
    lane.R = R;
    lane.Z = Z;
    lane.zcl = at<int>(p, kZcl, b);
    lane.zval_ = at<unsigned char>(p, kZval, b);

    {
      const int* fin = at<int>(p, kFreeIn, b);
      for (int n = n0; n < n1; ++n)
        for (int r = 0; r < R; ++r) lane.F(n, r) = fin[static_cast<size_t>(n) * R + r];
    }
    const int* perm = at<int>(p, kPerm, b);
    const int* skey = at<int>(p, kSkey, b);
    const int* order = static_cast<const int*>(p.ptr[kOrder]);
    unsigned long long* wave_counter =
        static_cast<unsigned long long*>(const_cast<void*>(p.ptr[kWaves]));

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
      lane.P = P;
      lane.rq = rq;
      lane.mu = mu;
      lane.sh = sh;
      lane.feas_ = feas;
      __syncthreads();

      if (!con) {  // the one-shot first fit (ops/pack.pack_groups' arithmetic)
        unsigned tsum = 0;
        for (int n = n0; n < n1; ++n) {
          int c = feas[n] ? lane.fit_count(n) : 0;
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
          if (place != 0) lane.take(n, place);
        }
        continue;
      }

      // the wave placer
      lane.s_cnt_ = at<int>(p, kSCnt, b, gn);
      lane.s_elig_ = at<unsigned char>(p, kSElig, b, gn);
      lane.a_ok_ = at<unsigned char>(p, kAOk, b, gn);
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
      const int waves = place_waves(blk, lane, wg, N, Z, n0, n1, max_waves, fit, zone_placed,
                                    zone_cap, czb_s, ezb_s, perm, skey);
      if (kSmem)
        for (int n = n0; n < n1; ++n) prow[n] = P[n];
      if (tid == 0 && waves > 0) atomicAdd(wave_counter, static_cast<unsigned long long>(waves));
    }

    if (kSmem)
      for (int n = n0; n < n1; ++n)
        for (int r = 0; r < R; ++r) fout[static_cast<size_t>(n) * R + r] = lane.F(n, r);
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
