// Sorted-key lookup for the rulebook builder.
//
// Replaces lidal_tpu/ops/pallas_merge.py:merge_rank_pallas (called through
// lidal_tpu/ops/merge_lookup.py:_merge_rank).  The TPU kernel merges each
// sorted query stream with its sorted table through a bitonic network and
// compacts the ranks with one-hot matmuls, because Mosaic has no dynamic
// indexing.  None of that carries over.
//
// Keys are (hi, lo) int32 pairs ordered lexicographically with signed
// compares (here one int64, hi * 2^32 + lo, in the same order); the sentinel
// 2^31-1 sorts after every real key.  Output per query: the lower bound
// (count of table keys strictly less than the query), or, in found mode, that
// row when it holds the query and `n` on a miss or when the query is a
// sentinel.
//
// What bounds it on an H100: the bytes of the queries read once and the ranks
// written once (0.08 ms for the five levels of a B = 4 batch).  A search per
// query over the whole table (17 dependent loads at n = 131072) is bound by
// load latency instead, so the kernel uses that the query streams are sorted:
//
// * A block owns a tile of kTile consecutive queries of ONE stream.  It reads
//   them coalesced and reduces their min and max key (a reduction, not the
//   first and last key, so an unsorted tile stays correct).
// * Two warps find the window [lb(min), lb(max)] in the stream's table, each
//   by a 32-way search (32 probes a step, 4 dependent steps at n = 131072).
//   Every query of the tile has its lower bound inside the window: a query
//   equal to the min or the max takes the window's end directly, any other
//   lies strictly between them.
// * When the window holds at most kWindow rows (a tile of an offset stream
//   spans about kTile rows) the block copies it coalesced into shared memory
//   and each thread binary-searches its queries there (<= 12 steps).  A wider
//   window (an unsorted or sparse stream) is searched per thread in device
//   memory, restricted to the window: the same function, not a fallback.
// * Found mode compares the key at the lower bound.  A lower bound at the
//   window's top is a miss for every query strictly inside it, because the
//   key there is at least the tile's max.
//
// lidal_lookup_wide_tiles runs the same window code and counts the tiles, and
// those that take the device-memory branch, so a caller can see how often it
// runs.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kTile = 1024;            // queries per block
constexpr int kPer = kTile / kThreads;  // queries per thread
constexpr int kWindow = 4096;          // table rows staged in shared memory (32 KB)
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ long long key_of(int hi, int lo) {
  return (long long)hi * 4294967296LL + lo;
}

// Lower bound of q in rows [lo, hi) of the table, by one whole warp: each step
// probes 32 evenly spaced rows and keeps the segment that holds the answer.
__device__ int warp_lower_bound(const int* th, const int* tl, int lo, int hi, long long q) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {  // the answer lies in [lo, hi] (closed)
    const int stride = (hi - lo + 31) / 32;
    const int p = lo + (lane + 1) * stride - 1;
    const bool less = p < hi && key_of(th[p], tl[p]) < q;
    const int c = __popc(__ballot_sync(0xffffffffu, less));
    const int nlo = lo + c * stride;
    hi = min(hi, nlo + stride - 1);
    lo = nlo;
  }
  const int p = lo + lane;
  const bool less = p < hi && key_of(th[p], tl[p]) < q;
  return lo + __popc(__ballot_sync(0xffffffffu, less));
}

// Lower bound of q in rows [lo, hi) of a sorted key array, one thread.
template <typename Key>
__device__ __forceinline__ int lower_bound(Key key, int lo, int hi, long long q) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (key(mid) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <bool COUNT_WIDE>
__global__ void __launch_bounds__(kThreads)
lookup_window_kernel(const int* __restrict__ t_hi, const int* __restrict__ t_lo,
                     const int* __restrict__ q_hi, const int* __restrict__ q_lo,
                     int* __restrict__ out, int m, int n, int streams_per_table, int with_found) {
  __shared__ long long s_key[kWindow];
  __shared__ long long s_red[2][kWarps];
  __shared__ int s_win[2];
  __shared__ int s_hit[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles = (m + kTile - 1) / kTile;
  const long long stream = blockIdx.x / tiles;
  const int* th = t_hi + (stream / streams_per_table) * n;
  const int* tl = t_lo + (stream / streams_per_table) * n;
  const int q0 = (blockIdx.x % tiles) * kTile;
  const int* qh_s = q_hi + stream * m + q0;
  const int* ql_s = q_lo + stream * m + q0;
  const int count = min(kTile, m - q0);

  int qh[kPer], ql[kPer];
  long long kmin = LLONG_MAX, kmax = LLONG_MIN;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = tid + i * kThreads;
    qh[i] = j < count ? qh_s[j] : 0;
    ql[i] = j < count ? ql_s[j] : 0;
    if (j < count) {
      const long long q = key_of(qh[i], ql[i]);
      kmin = min(kmin, q);
      kmax = max(kmax, q);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, d));
    kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, d));
  }
  if (lane == 0) {
    s_red[0][warp] = kmin;
    s_red[1][warp] = kmax;
  }
  __syncthreads();
  kmin = s_red[0][0];
  kmax = s_red[1][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    kmin = min(kmin, s_red[0][w]);
    kmax = max(kmax, s_red[1][w]);
  }
  // warp 0: lower bound of the min; warp 1: lower bound of the max
  if (warp < 2) {
    const long long q = warp == 0 ? kmin : kmax;
    const int lb = warp_lower_bound(th, tl, 0, n, q);
    if (lane == 0) {
      s_win[warp] = lb;
      s_hit[warp] = lb < n && key_of(th[lb], tl[lb]) == q;
    }
  }
  __syncthreads();
  const int wlo = s_win[0];
  const int whi = s_win[1];
  const int width = whi - wlo;
  const bool staged = width <= kWindow;
  if (COUNT_WIDE) {  // out[0]: tiles searched in device memory, out[1]: all tiles
    if (tid == 0) {
      if (!staged) atomicAdd(out, 1);
      atomicAdd(out + 1, 1);
    }
    return;
  }
  if (staged) {
    for (int e = tid; e < width; e += kThreads) s_key[e] = key_of(th[wlo + e], tl[wlo + e]);
    __syncthreads();
  }

  int* out_s = out + stream * m + q0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = tid + i * kThreads;
    if (j >= count) continue;
    const long long q = key_of(qh[i], ql[i]);
    int r;
    bool hit;
    if (q == kmin) {
      r = wlo;
      hit = s_hit[0];
    } else if (q == kmax) {
      r = whi;
      hit = s_hit[1];
    } else if (staged) {  // kmin < q < kmax: the answer lies in [wlo, whi]
      const int k = lower_bound([&](int x) { return s_key[x]; }, 0, width, q);
      r = wlo + k;
      hit = k < width && s_key[k] == q;
    } else {
      r = lower_bound([&](int x) { return key_of(th[x], tl[x]); }, wlo, whi, q);
      hit = r < whi && key_of(th[r], tl[r]) == q;
    }
    if (with_found) r = hit && qh[i] != kSentinel ? r : n;
    out_s[j] = r;
  }
}

// Blocks of a launch: one per tile of each stream (0 when the call is invalid).
long long grid_blocks(int num_tables, int streams_per_table, int n, int m) {
  if (num_tables < 0 || n < 0 || m <= 0 || streams_per_table <= 0) return 0;
  const long long blocks = (long long)num_tables * streams_per_table * ((m + kTile - 1) / kTile);
  return blocks <= INT_MAX ? blocks : 0;
}

}  // namespace

// t_hi/t_lo: [T, n]; q_hi/q_lo/out: [T * streams_per_table, m]; all int32,
// contiguous, on the current device.  Returns cudaGetLastError() after launch.
extern "C" int lidal_lookup_sorted(const void* t_hi, const void* t_lo, const void* q_hi,
                                   const void* q_lo, void* out, int num_tables,
                                   int streams_per_table, int n, int m, int with_found,
                                   void* stream) {
  if ((long long)num_tables * streams_per_table * m == 0) return (int)cudaSuccess;
  const long long blocks = grid_blocks(num_tables, streams_per_table, n, m);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  lookup_window_kernel<false><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)t_hi, (const int*)t_lo, (const int*)q_hi, (const int*)q_lo, (int*)out, m, n,
      streams_per_table, with_found);
  return (int)cudaGetLastError();
}

// The same arguments; adds to count[0] (int32 on the device, zeroed by the
// caller) the number of tiles whose window exceeds the shared stage, and to
// count[1] the number of tiles.
extern "C" int lidal_lookup_wide_tiles(const void* t_hi, const void* t_lo, const void* q_hi,
                                       const void* q_lo, void* count, int num_tables,
                                       int streams_per_table, int n, int m, void* stream) {
  if ((long long)num_tables * streams_per_table * m == 0) return (int)cudaSuccess;
  const long long blocks = grid_blocks(num_tables, streams_per_table, n, m);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  lookup_window_kernel<true><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)t_hi, (const int*)t_lo, (const int*)q_hi, (const int*)q_lo, (int*)count, m, n,
      streams_per_table, 0);
  return (int)cudaGetLastError();
}
