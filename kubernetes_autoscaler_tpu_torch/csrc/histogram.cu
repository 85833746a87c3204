// The VPA histogram bank's sample scatter: weights[a, b] += w and
// total[a] += w for every sample, summed in sample order.
//
// Replaces XLA's scatter-add in the reference package's
// kubernetes_autoscaler_tpu/vpa/histogram.py:116-121 (`_scatter_add`,
// `.at[agg, bucket].add(w)`), which has no Pallas kernel. On the CPU XLA
// adds a bin's samples one after another in sample order, starting from
// the bin's current value; the recommendation is the bucket end where the
// running sum crosses a quantile, so one ulp in a bin can move a pod's
// request. An atomic add on the card sums in whatever order the threads
// arrive, so the port cannot use one.
//
// Indices are read as XLA's `.at[]` reads them, inside the kernels: a
// negative row or bucket counts from the end once; a sample whose row is
// still outside the bank is dropped (its key is A, past the bank's last
// row), and one whose row is inside but whose bucket is not adds to the
// total only.
//
// Design: one C entry, `ka_hist_scatter`, enqueues every pass on the
// caller's stream and reads nothing back; its workspace (two key and two
// value buffers of n words, the count tables, each row's end and count) is
// the caller's, sized from n and A (`ka_hist_workspace`).
//   1. One memset zeroes the control words.
//   2. A stable LSD radix sort by row over the key's bits only (bits = bit
//      length of A, P = ceil(bits / 8) passes of D = ceil(bits / P) bits:
//      16 bits and 2 passes at A = 33,790, 3 passes past 65,535), in tiles
//      of 2,048 samples, reduce then scan (no chain between tiles):
//      `count_kernel` counts the first digit a tile; `scan_kernel` scans
//      each digit's counts over the tiles (a block a digit) and totals
//      them; `sort_pass_kernel` ranks a tile's samples a warp at a time by
//      `__match_any_sync` on the digit, in sample order, and sends each to
//      its digit's start (a scan of the totals) + the earlier tiles' count
//      + the earlier warps' + its rank, so that equal digits keep sample
//      order. A pass moves (key, 32-bit sample index) and adds the next
//      pass's counts a (digit, destination tile), one atomic a group of
//      lanes; the last pass gathers each sample's raw bucket and weight
//      into its place (the gathers issued before the ranking, to overlap
//      it) and records each row's run: its count and its end, one atomic
//      each a (warp, row) group.
//   3. `fold_kernel` folds each row in a warp: 32 samples at a time, read
//      coalesced from the row's run (the next batch loaded while one is
//      folded), the weights staged in shared memory; lane 0 adds them onto
//      the row's total in lane order (a register), and the lanes that share
//      a bucket (`__match_any_sync`) leave it to the lowest of them, which
//      adds their weights in lane order onto the bin staged in shared
//      memory (the whole bank row staged when the run is longer than 32,
//      else a bin read at its first touch). Every add is __fadd_rn: no
//      contraction, no reassociation, so each bin and total is byte-equal
//      to the plain version's sequential sum. Each touched bin is written
//      once, and a row with no sample is not written at all.
//
// Bound on this card: bytes. Each sample is read once (aggregate, bucket,
// weight: 12 B) and each touched bin and total read and written once; the
// adds are two a sample. The sort moves each sample P + 1 times more (16 B
// a pass, scattered), and at the RunOnce feed's n = 100,000 every kernel is
// a few tiles' chain of dependent steps; that is what puts it above the
// bound.
//
// Skew: a row's n adds onto its total form one chain by the semantics and
// cannot be reassociated, nor can a bin's. A row holding most samples is
// folded by one warp, a tile of 32 samples after another (its total's 32
// dependent adds, the bucket groups' chains, two warp barriers), while the
// other rows finish in parallel; its sort passes are unaffected.
//
// Contract (checked by the Python wrapper and, for the sizes, here): i32
// agg and bucket [n], f32 w [n], weights [A, B] and total [A] in place,
// a u32 workspace of at least `ka_hist_workspace(n, A)` words, n < 2^30,
// B small enough for a warp's staged row (5B + 128 bytes) to fit in 48
// KB. Returns the CUDA error (cudaErrorInvalidValue for a size it does not
// take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSortThreads = 256;  // 8 warps a tile
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kItems = 8;          // samples a thread a tile
constexpr int kTile = kSortThreads * kItems;
constexpr int kRadix = 256;        // digits of at most 8 bits
constexpr int kFoldItems = 4;      // tiles of 32 a fold step loads at once
constexpr int kFoldWarps = 8;
constexpr size_t kFoldSmem = 48 * 1024;

__device__ __forceinline__ unsigned row_key(int a, int A) {
  // `.at[]`: [-A, -1] counts from the end; still outside [0, A) is dropped
  return (a >= -A && a < A) ? static_cast<unsigned>(a < 0 ? a + A : a) : static_cast<unsigned>(A);
}

__device__ __forceinline__ unsigned warp_incl(unsigned x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// An exclusive scan of one value a thread over a block of kSortThreads;
// `total` gets the block's sum. `wsum` is kSortWarps words of shared memory.
__device__ __forceinline__ unsigned block_excl(unsigned x, unsigned* wsum, unsigned& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned inc = warp_incl(x, lane);
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const unsigned s = lane < kSortWarps ? wsum[lane] : 0u;
    const unsigned si = warp_incl(s, lane);
    if (lane < kSortWarps) wsum[lane] = si - s;
    if (lane == kSortWarps - 1) wsum[kSortWarps] = si;
  }
  __syncthreads();
  total = wsum[kSortWarps];
  return wsum[warp] + inc - x;
}

// The first pass's digit counts a tile: table[d][t] (digit-major).
__global__ void __launch_bounds__(kSortThreads)
count_kernel(const int32_t* __restrict__ agg, unsigned* __restrict__ table, int64_t n, int A,
             int dbits, int T) {
  __shared__ unsigned cnt[kRadix];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned mask = (1u << dbits) - 1u;
  const int t = blockIdx.x;
  cnt[tid] = 0u;
  __syncthreads();
  const int64_t w0 = static_cast<int64_t>(t) * kTile + warp * (32 * kItems);
  int a[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = w0 + k * 32 + lane;
    a[k] = i < n ? agg[i] : 0;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool valid = w0 + k * 32 + lane < n;
    const unsigned d = valid ? row_key(a[k], A) & mask : kFull;
    const unsigned peers = __match_any_sync(kFull, d);
    if (valid && lane == __ffs(peers) - 1) atomicAdd(&cnt[d], static_cast<unsigned>(__popc(peers)));
  }
  __syncthreads();
  if (tid <= static_cast<int>(mask)) table[static_cast<size_t>(tid) * T + t] = cnt[tid];
}

// Each digit's column of a pass's table, scanned over the tiles in place
// (exclusive), and the digit's total into coltot[d]. A block a digit, a
// warp a contiguous chunk of the column, read and written coalesced.
__global__ void __launch_bounds__(kSortThreads)
scan_kernel(unsigned* table, unsigned* coltot, int T) {
  __shared__ unsigned wsum[kSortWarps + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* col = table + static_cast<size_t>(blockIdx.x) * T;
  const int chunk = (T + kSortWarps * 32 - 1) / (kSortWarps * 32) * 32;
  const int lo = min(warp * chunk, T), hi = min(lo + chunk, T);
  unsigned sum = 0u;
  for (int i = lo + lane; i < hi; i += 32) sum += col[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
  if (lane == 0) wsum[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    const unsigned s = lane < kSortWarps ? wsum[lane] : 0u;
    const unsigned si = warp_incl(s, lane);
    if (lane < kSortWarps) wsum[lane] = si - s;
    if (lane == kSortWarps - 1) wsum[kSortWarps] = si;
  }
  __syncthreads();
  unsigned carry = wsum[warp];
  for (int b = lo; b < hi; b += 32) {
    const int i = b + lane;
    const unsigned c = i < hi ? col[i] : 0u;
    const unsigned inc = warp_incl(c, lane);
    if (i < hi) col[i] = carry + inc - c;
    carry += __shfl_sync(kFull, inc, 31);
  }
  if (threadIdx.x == 0) coltot[blockIdx.x] = wsum[kSortWarps];
}

// One stable pass by the digit at `shift`, tile t = blockIdx.x: a sample
// goes to its digit's start (an exclusive scan of coltot) + the earlier
// tiles' count of its digit (table, scanned) + the earlier warps' + its
// rank in its warp. kFirst: keys from `agg` and values the sample index;
// otherwise the next pass's counts a tile are added into next_table.
// kLast: each sample's raw bucket and weight are written in its place
// (into keys_out and vals_out), and each row's count and end recorded.
template <bool kFirst, bool kLast>
__global__ void __launch_bounds__(kSortThreads)
sort_pass_kernel(const int32_t* __restrict__ agg, const int32_t* __restrict__ bucket,
                 const float* __restrict__ w, const unsigned* __restrict__ keys_in,
                 const unsigned* __restrict__ vals_in, unsigned* __restrict__ keys_out,
                 unsigned* __restrict__ vals_out, const unsigned* __restrict__ table,
                 const unsigned* __restrict__ coltot, unsigned* next_table, unsigned* row_end,
                 unsigned* row_cnt, int64_t n, int A, int shift, int dbits, int T) {
  __shared__ unsigned wcnt[kSortWarps][kRadix];
  __shared__ unsigned base[kRadix];
  __shared__ unsigned wsum[kSortWarps + 1];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int radix = 1 << dbits;
  const unsigned mask = static_cast<unsigned>(radix) - 1u;
  const unsigned below = (1u << lane) - 1u;
  const int t = blockIdx.x;

  // this tile's offsets, read before they are needed
  const unsigned tile_off = tid < radix ? table[static_cast<size_t>(tid) * T + t] : 0u;
  const unsigned tot = tid < radix ? coltot[tid] : 0u;
  for (int j = tid; j < kSortWarps * kRadix; j += kSortThreads) (&wcnt[0][0])[j] = 0u;
  const int64_t w0 = static_cast<int64_t>(t) * kTile + warp * (32 * kItems);

  unsigned key[kItems], val[kItems], rank[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = w0 + k * 32 + lane;
    key[k] = kFull;
    val[k] = 0u;
    if (i < n) {
      if (kFirst) {
        key[k] = row_key(agg[i], A);
        val[k] = static_cast<unsigned>(i);
      } else {
        key[k] = keys_in[i];
        val[k] = vals_in[i];
      }
    }
  }
  // the last pass's gathers, issued now so that they arrive while the
  // tile ranks its samples
  int gb[kLast ? kItems : 1];
  float gw[kLast ? kItems : 1];
  if (kLast) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool valid = w0 + k * 32 + lane < n;
      gb[k] = valid ? bucket[val[k]] : 0;
      gw[k] = valid ? w[val[k]] : 0.0f;
    }
  }
  __syncthreads();
  // ranks within the warp, in (k, lane) order: sample order
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool valid = w0 + k * 32 + lane < n;
    const unsigned d = valid ? (key[k] >> shift) & mask : kFull;
    const unsigned peers = __match_any_sync(kFull, d);
    const int leader = __ffs(peers) - 1;
    unsigned b = 0u;
    if (valid && lane == leader) {
      b = wcnt[warp][d];
      wcnt[warp][d] = b + __popc(peers);
    }
    b = __shfl_sync(kFull, b, leader);
    rank[k] = b + __popc(peers & below);
    __syncwarp();
  }
  __syncthreads();
  if (tid < radix) {  // the earlier warps' counts of each digit
    unsigned run = 0u;
    for (int q = 0; q < kSortWarps; ++q) {
      const unsigned c = wcnt[q][tid];
      wcnt[q][tid] = run;
      run += c;
    }
  }
  unsigned all;
  const unsigned excl = block_excl(tot, wsum, all);
  if (tid < radix) base[tid] = excl + tile_off;
  __syncthreads();

  const int next_shift = shift + dbits;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool valid = w0 + k * 32 + lane < n;
    unsigned pos = 0u;
    if (valid) {
      const unsigned d = (key[k] >> shift) & mask;
      pos = base[d] + wcnt[warp][d] + rank[k];
      if (kLast) {
        keys_out[pos] = static_cast<unsigned>(gb[kLast ? k : 0]);
        vals_out[pos] = __float_as_uint(gw[kLast ? k : 0]);
      } else {
        keys_out[pos] = key[k];
        vals_out[pos] = val[k];
      }
    }
    if (kLast) {
      // the row's run: the highest lane of each (warp, row) group holds its
      // last place; the run is contiguous, so end - count is its start
      const bool row = valid && key[k] < static_cast<unsigned>(A);
      const unsigned peers = __match_any_sync(kFull, row ? key[k] : kFull);
      if (row && lane == 31 - __clz(peers)) {
        atomicMax(&row_end[key[k]], pos + 1u);
        atomicAdd(&row_cnt[key[k]], static_cast<unsigned>(__popc(peers)));
      }
    } else {
      // the next pass's count of (digit, destination tile)
      const unsigned slot =
          valid ? ((key[k] >> next_shift) & mask) * static_cast<unsigned>(T) + pos / kTile : kFull;
      const unsigned peers = __match_any_sync(kFull, slot);
      if (valid && lane == __ffs(peers) - 1)
        atomicAdd(&next_table[slot], static_cast<unsigned>(__popc(peers)));
    }
  }
}

// Each row's run folded in sample order by one warp; see the header.
// `sb` and `sw` hold each sample's raw bucket and weight in sorted order.
__global__ void __launch_bounds__(kFoldWarps * 32, 6)
fold_kernel(const int32_t* __restrict__ sb, const float* __restrict__ sw,
            const unsigned* __restrict__ row_end, const unsigned* __restrict__ row_cnt,
            float* weights, float* total, int A, int B, int warp_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= A) return;
  const unsigned cnt = row_cnt[r];
  if (cnt == 0u) return;  // a row with no sample is not written
  const int64_t end = row_end[r];
  const int64_t start = end - cnt;
  unsigned char* mine = smem + static_cast<size_t>(warp) * warp_bytes;
  float* bins = reinterpret_cast<float*>(mine);
  unsigned char* seen = mine + static_cast<size_t>(B) * 4;
  float* tw = reinterpret_cast<float*>(mine + (static_cast<size_t>(B) * 5 + 15) / 16 * 16);
  float* row = weights + static_cast<int64_t>(r) * B;
  // a row of more than one tile stages its whole bank row at once;
  // a shorter one reads a bin at its first touch
  const bool staged = cnt > 32u;
  for (int b = lane; b < B; b += 32) {
    seen[b] = 0;
    if (staged) bins[b] = row[b];
  }
  float t = lane == 0 ? total[r] : 0.0f;  // lane 0 keeps the total's chain

  // the batch after the current one is loaded while the current is folded
  int bk[kFoldItems], nb[kFoldItems];
  float x[kFoldItems], nx[kFoldItems];
#pragma unroll
  for (int k = 0; k < kFoldItems; ++k) {
    const int64_t i = start + k * 32 + lane;
    bk[k] = i < end ? sb[i] : 0;
    x[k] = i < end ? sw[i] : 0.0f;
  }
  __syncwarp();
  for (int64_t s0 = start; s0 < end; s0 += 32 * kFoldItems) {
    const int64_t s1 = s0 + 32 * kFoldItems;
#pragma unroll
    for (int k = 0; k < kFoldItems; ++k) {
      const int64_t i = s1 + k * 32 + lane;
      nb[k] = i < end ? sb[i] : 0;
      nx[k] = i < end ? sw[i] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kFoldItems; ++k) {
      const int64_t first = s0 + k * 32;
      if (first >= end) break;  // warp-uniform
      const int m = static_cast<int>(end - first < 32 ? end - first : 32);
      int b = bk[k];
      if (b < 0) b += B;
      b = (lane < m && b >= 0 && b < B) ? b : -1;  // outside: the total only
      tw[lane] = x[k];
      __syncwarp();
      if (lane == 0) {  // the total: one chain in lane order
        if (m == 32) {
          const float4* t4 = reinterpret_cast<const float4*>(tw);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float4 f = t4[q];
            t = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(t, f.x), f.y), f.z), f.w);
          }
        } else {
          for (int j = 0; j < m; ++j) t = __fadd_rn(t, tw[j]);
        }
      }
      const unsigned peers = __match_any_sync(kFull, static_cast<unsigned>(b));
      if (b >= 0 && lane == __ffs(peers) - 1) {
        float v = (staged || seen[b]) ? bins[b] : row[b];
        seen[b] = 1;
        for (unsigned q = peers; q; q &= q - 1u) v = __fadd_rn(v, tw[__ffs(q) - 1]);
        bins[b] = v;
      }
      __syncwarp();
    }
#pragma unroll
    for (int k = 0; k < kFoldItems; ++k) {
      bk[k] = nb[k];
      x[k] = nx[k];
    }
  }
  if (lane == 0) total[r] = t;
  for (int b = lane; b < B; b += 32)
    if (seen[b]) row[b] = bins[b];
}

struct Plan {
  int passes, dbits;
  int64_t tiles, control, words;
};

Plan plan(int64_t n, int A) {
  Plan p;
  int bits = 0;
  while (bits < 31 && (static_cast<int64_t>(1) << bits) <= A) ++bits;  // bit length of A
  if (bits == 0) bits = 1;
  p.passes = (bits + 7) / 8;
  p.dbits = (bits + p.passes - 1) / p.passes;
  p.tiles = (n + kTile - 1) / kTile;
  // tables [P][256][T], column totals [P][256], row_end [A], row_cnt [A]
  p.control = p.passes * kRadix * p.tiles + p.passes * kRadix + 2 * static_cast<int64_t>(A);
  p.words = 4 * n + p.control;  // keys and values, two buffers each
  return p;
}

}  // namespace

// The workspace words a scatter of n samples into an A-row bank takes (the
// Python wrapper sizes the same from n and A).
extern "C" int64_t ka_hist_workspace(int64_t n, int A) {
  if (n <= 0 || A <= 0) return 0;
  return plan(n, A).words;
}

// `order_only` stops after the sort passes (the fold is not run and the bank
// is untouched): a timing aid.
extern "C" int ka_hist_scatter(const int32_t* agg, const int32_t* bucket, const float* w,
                               float* weights, float* total, unsigned* ws, int64_t ws_words,
                               int64_t n, int A, int B, int order_only, void* stream_) {
  if (n <= 0 || A <= 0) return 0;
  if (n >= (static_cast<int64_t>(1) << 30) || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(n, A);
  if (ws_words < p.words) return static_cast<int>(cudaErrorInvalidValue);
  const int warp_bytes = static_cast<int>((static_cast<size_t>(B) * 5 + 15) / 16 * 16 + 128);
  if (static_cast<size_t>(warp_bytes) > kFoldSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int T = static_cast<int>(p.tiles);
  const int radix = 1 << p.dbits;

  unsigned* keys[2] = {ws, ws + n};
  unsigned* vals[2] = {ws + 2 * n, ws + 3 * n};
  unsigned* tables = ws + 4 * n;
  unsigned* coltot = tables + p.passes * kRadix * p.tiles;
  unsigned* row_end = coltot + p.passes * kRadix;
  unsigned* row_cnt = row_end + A;
  cudaError_t err = cudaMemsetAsync(tables, 0, static_cast<size_t>(p.control) * 4, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  count_kernel<<<T, kSortThreads, 0, stream>>>(agg, tables, n, A, p.dbits, T);
  for (int q = 0; q < p.passes; ++q) {
    const bool first = q == 0, last = q == p.passes - 1;
    unsigned* table = tables + q * kRadix * p.tiles;
    scan_kernel<<<radix, kSortThreads, 0, stream>>>(table, coltot + q * kRadix, T);
    auto kernel = first ? (last ? sort_pass_kernel<true, true> : sort_pass_kernel<true, false>)
                        : (last ? sort_pass_kernel<false, true> : sort_pass_kernel<false, false>);
    kernel<<<T, kSortThreads, 0, stream>>>(
        agg, bucket, w, first ? nullptr : keys[(q - 1) & 1], first ? nullptr : vals[(q - 1) & 1],
        keys[q & 1], vals[q & 1], table, coltot + q * kRadix,
        last ? nullptr : table + kRadix * p.tiles, row_end, row_cnt, n, A, q * p.dbits, p.dbits,
        T);
  }
  if (!order_only) {
    int wpb = kFoldWarps;
    while (wpb > 1 && static_cast<size_t>(wpb) * warp_bytes > kFoldSmem) --wpb;
    const unsigned blocks = static_cast<unsigned>((A + wpb - 1) / wpb);
    const int last = (p.passes - 1) & 1;
    fold_kernel<<<blocks, wpb * 32, static_cast<size_t>(wpb) * warp_bytes, stream>>>(
        reinterpret_cast<const int32_t*>(keys[last]), reinterpret_cast<const float*>(vals[last]),
        row_end, row_cnt, weights, total, A, B, warp_bytes);
  }
  return static_cast<int>(cudaGetLastError());
}
