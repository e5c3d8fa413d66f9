// Per-tap lists of the real (row, tap) pairs of a map, built on the device,
// and the ordered sum of per-chunk weight-gradient partials over them: shared
// by the f32 backward (conv_dx_dw.cu) and the bf16 one (conv_dx_dw_fused.cu).
//
// Two small kernels compact nbr_t [K, m] (the map transposed, so a tap's
// column is contiguous; transpose_kernel makes it from the map) into rows
// [K, m]: for tap k the rows i with 0 <= nbr_t[k, i] < n, ascending, and
// counts[k].  The first counts the real
// entries of each 4096-row segment; the second places each segment's rows at
// the sum of the earlier segments' counts (warp ballots, then a prefix over the
// block's 128 warp rounds).  The counts stay on the device: the host never
// waits on them.
//
// A weight-gradient kernel cuts each tap's list into chunks of P pairs and
// writes one [c_f, c_src] partial per (tap, chunk) to a workspace [K, S, c_f,
// c_src]; dwg_reduce_kernel sums, per tap, the first max(1, ceil(count / P))
// partials in chunk order.  P depends on the shape only, so the same input
// gives bit-equal sums on every run, with no atomics.

#pragma once

#include <cuda_runtime.h>

namespace pair_lists {

constexpr int kThreads = 256;   // 8 warps
constexpr int kSegRows = 4096;  // rows of nbr_t a list block scans, 16 a thread

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// seg_counts[tap][seg] = the real entries of nbr_t[tap] in rows
// [seg * kSegRows, (seg + 1) * kSegRows)
__global__ void __launch_bounds__(kThreads)
pair_count_kernel(const int* __restrict__ nbr_t, int* __restrict__ seg_counts, int m, int n) {
  __shared__ int s_sum[kThreads / 32];
  const int tap = blockIdx.y;
  const int* col = nbr_t + (long long)tap * m;
  const int base = blockIdx.x * kSegRows + threadIdx.x;
  int c = 0;
#pragma unroll
  for (int r = 0; r < kSegRows / kThreads; ++r) {
    const int i = base + r * kThreads;
    if (i < m) c += (unsigned)col[i] < (unsigned)n;
  }
  c = warp_sum(c);
  if ((threadIdx.x & 31) == 0) s_sum[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += s_sum[w];
    seg_counts[(long long)tap * gridDim.x + blockIdx.x] = total;
  }
}

// rows[tap][0, counts[tap]) = the rows i with 0 <= nbr_t[tap, i] < n, ascending
__global__ void __launch_bounds__(kThreads)
pair_list_kernel(const int* __restrict__ nbr_t, const int* __restrict__ seg_counts,
                 int* __restrict__ rows, int* __restrict__ counts, int m, int n) {
  constexpr int R = kSegRows / kThreads;  // rounds: row = segment start + r * kThreads + thread
  constexpr int W = kThreads / 32;
  constexpr int PER = R * W / 32;  // (round, warp) counts a lane of warp 0 scans
  __shared__ int s_pre[R * W];     // real rows per (round, warp), then their exclusive prefix
  __shared__ int s_base;
  const int tap = blockIdx.y;
  const int seg = blockIdx.x;
  const int segs = gridDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* col = nbr_t + (long long)tap * m;
  const int* sc = seg_counts + (long long)tap * segs;
  if (warp == 0) {  // where this segment's rows start in the list; segment 0 writes the count
    int before = 0, all = 0;
    for (int s = lane; s < segs; s += 32) {
      const int c = sc[s];
      all += c;
      before += s < seg ? c : 0;
    }
    before = warp_sum(before);
    all = warp_sum(all);
    if (lane == 0) {
      s_base = before;
      if (seg == 0) counts[tap] = all;
    }
  }
  const int base = seg * kSegRows + threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  unsigned real_bits = 0;  // bit r: this thread's row of round r is real
  int rank[R];             // its place among its warp's real rows of round r
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = base + r * kThreads;
    const bool real = i < m && (unsigned)col[i] < (unsigned)n;
    const unsigned ballot = __ballot_sync(0xffffffffu, real);
    if (lane == 0) s_pre[r * W + warp] = __popc(ballot);
    rank[r] = __popc(ballot & below);
    real_bits |= (unsigned)real << r;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive prefix in (round, warp) order, which is row order
    int v[PER];
    int sum = 0;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      v[e] = s_pre[lane * PER + e];
      sum += v[e];
    }
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += t;
    }
    int run = inc - sum;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      s_pre[lane * PER + e] = run;
      run += v[e];
    }
  }
  __syncthreads();
  int* out = rows + (long long)tap * m + s_base;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if ((real_bits >> r) & 1u) out[s_pre[r * W + warp] + rank[r]] = base + r * kThreads;
}

// dwg[tap] = the sum of the tap's first max(1, ceil(count / P)) partials, in chunk order
__global__ void dwg_reduce_kernel(const float4* __restrict__ part, const int* __restrict__ counts,
                                  float4* __restrict__ dwg, int per_tap4, int k, int chunks,
                                  int pairs_per_chunk) {
  const long long total4 = (long long)k * per_tap4;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total4;
       e += (long long)gridDim.x * blockDim.x) {
    const int tap = (int)(e / per_tap4);
    const int used = max(1, (int)(((long long)counts[tap] + pairs_per_chunk - 1) / pairs_per_chunk));
    const float4* p = part + (long long)tap * chunks * per_tap4 + (e - (long long)tap * per_tap4);
    float4 acc = p[0];
    for (int s = 1; s < used; ++s) {
      const float4 v = p[(long long)s * per_tap4];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    dwg[e] = acc;
  }
}

// nbr_t [k, m] = nbr [m, k] transposed (k <= 32), through a 32-row tile in
// shared memory, so that both the reads and the writes are coalesced.
__global__ void __launch_bounds__(kThreads)
transpose_kernel(const int* __restrict__ nbr, int* __restrict__ nbr_t, int m, int k) {
  __shared__ int tile[32][33];
  const int r0 = blockIdx.x * 32;
  const int x = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < 32; i += kThreads / 32)
    if (r0 + i < m && x < k) tile[i][x] = nbr[(long long)(r0 + i) * k + x];
  __syncthreads();
  for (int t = threadIdx.x >> 5; t < k; t += kThreads / 32)
    if (r0 + x < m) nbr_t[(long long)t * m + r0 + x] = tile[x][t];
}

inline cudaError_t launch_transpose(const int* nbr, int* nbr_t, int m, int k, cudaStream_t stream) {
  transpose_kernel<<<(m + 31) / 32, kThreads, 0, stream>>>(nbr, nbr_t, m, k);
  return cudaGetLastError();
}

// The lists of every tap: rows [k, m], counts [k], seg_counts [k, ceil(m / kSegRows)] scratch.
inline cudaError_t launch_lists(const int* nbr_t, int* rows, int* counts, int* seg_counts, int m,
                                int n, int k, cudaStream_t stream) {
  const dim3 grid((m + kSegRows - 1) / kSegRows, k);
  pair_count_kernel<<<grid, kThreads, 0, stream>>>(nbr_t, seg_counts, m, n);
  pair_list_kernel<<<grid, kThreads, 0, stream>>>(nbr_t, seg_counts, rows, counts, m, n);
  return cudaGetLastError();
}

// dwg [k, c_f, c_src] from the workspace ws [k, chunks, c_f, c_src] of partials.
inline cudaError_t launch_reduce(const float* ws, const int* counts, float* dwg, int k, int c_f,
                                 int c_src, int chunks, int pairs_per_chunk, cudaStream_t stream) {
  const int per_tap4 = c_f * c_src / 4;
  const long long total4 = (long long)k * per_tap4;
  const int blocks = (int)((total4 + 255) / 256 < 4096 ? (total4 + 255) / 256 : 4096);
  dwg_reduce_kernel<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(ws), counts,
                                                reinterpret_cast<float4*>(dwg), per_tap4, k, chunks,
                                                pairs_per_chunk);
  return cudaGetLastError();
}

}  // namespace pair_lists
