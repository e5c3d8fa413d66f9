// Sorted-key lookup for the rulebook builder.
//
// Replaces lidal_tpu/ops/pallas_merge.py:merge_rank_pallas (called through
// lidal_tpu/ops/merge_lookup.py:_merge_rank).  The TPU kernel merges each
// sorted query stream with its sorted table through a bitonic network and
// compacts the ranks with one-hot matmuls, because Mosaic has no dynamic
// indexing.  A GPU thread can index memory directly, so here each thread
// binary-searches one query in its stream's table.
//
// Keys are (hi, lo) int32 pairs ordered lexicographically with signed
// compares; the sentinel 2^31-1 sorts after every real key.  Output per query:
// the lower bound (count of table keys strictly less than the query), or, in
// found mode, that row when it holds the query and `n` on a miss or when the
// query is a sentinel.
//
// What bounds it on an H100: ~log2(n) dependent loads per query (17 at
// n = 131072), i.e. load latency, not bandwidth or arithmetic.  Streams share
// tables (all 26 offsets of a frame search the same frame table), so the
// kernel takes T tables for S = T*R streams instead of S copies: the B tables
// of a batch (1 MB each at level 0) then stay in the 50 MB L2, and many
// resident warps hide the latency of each step.

#include <cuda_runtime.h>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kThreads = 256;

__device__ __forceinline__ bool key_less(int ah, int al, int bh, int bl) {
  return ah < bh || (ah == bh && al < bl);
}

__global__ void __launch_bounds__(kThreads)
lookup_sorted_kernel(const int* __restrict__ t_hi, const int* __restrict__ t_lo,
                     const int* __restrict__ q_hi, const int* __restrict__ q_lo,
                     int* __restrict__ out, long long total, int m, int n,
                     int streams_per_table, int with_found) {
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (gid >= total) return;
  const long long table = gid / m / streams_per_table;
  const int* th = t_hi + table * n;
  const int* tl = t_lo + table * n;
  const int qh = q_hi[gid];
  const int ql = q_lo[gid];
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (key_less(th[mid], tl[mid], qh, ql)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int r = lo;
  if (with_found) {
    const bool found = lo < n && qh != kSentinel && th[lo] == qh && tl[lo] == ql;
    r = found ? lo : n;
  }
  out[gid] = r;
}

}  // namespace

// t_hi/t_lo: [T, n]; q_hi/q_lo/out: [T * streams_per_table, m]; all int32,
// contiguous, on the current device.  Returns cudaGetLastError() after launch.
extern "C" int lidal_lookup_sorted(const void* t_hi, const void* t_lo, const void* q_hi,
                                   const void* q_lo, void* out, int num_tables,
                                   int streams_per_table, int n, int m, int with_found,
                                   void* stream) {
  const long long total = (long long)num_tables * streams_per_table * m;
  if (total == 0) return (int)cudaSuccess;
  if (n < 0 || m <= 0 || streams_per_table <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (total + kThreads - 1) / kThreads;
  lookup_sorted_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)t_hi, (const int*)t_lo, (const int*)q_hi, (const int*)q_lo, (int*)out,
      total, m, n, streams_per_table, with_found);
  return (int)cudaGetLastError();
}
