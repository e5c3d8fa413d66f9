// Weighted 8-tap row gather and its transpose (the SPVCNN point branch).
//
// Replaces lidal_tpu/ops/pallas_gather8.py:gather8_pallas and scatter8_pallas:
//
//   gather8:   out[i]    = sum_{k < 8} w8[i, k] * feats[nbr[i, k]]
//   scatter8:  dfeats[t] = sum_{(i, k): nbr[i, k] == t} w8[i, k] * dy[i]
//
// An index outside [0, n) is the sentinel and contributes zero.  The columns of
// nbr need not be sorted.
//
// The TPU kernels turn both into matrix products with one-hot blocks over a
// band of the sorted map, in bf16.  None of that carries over: an SM gathers
// rows directly, in f32.  The bf16 route (ops/conv.BF16_OPERANDS and
// ops/cuda_gather8.SCATTER8_BF16, the counterparts of lidal_tpu/ops/conv.py:
// USE_PALLAS and pallas_gather8.py:USE_PALLAS_BWD) rounds what the TPU
// kernels round: gather8 reads its table as bf16 (pallas_gather8.py:139; the
// one-hot product of :105-106 is exact, w8 stays f32), scatter8 reads dy as
// bf16 and rounds w8 to bf16 (:314 and the weighted one-hot of :284).  Both
// are the same kernels with the rows' type as a template parameter, which
// halves the bytes the rows take; the products and sums stay f32, in the same
// order.
//
// What bounds both on an H100: bytes.  gather8 does 2 operations for every 4
// bytes it reads; the trilinear call at B = 4 writes 537 MB and reads an 8 MB
// table that stays in the 50 MB L2.  Measured on an NVIDIA H100 80GB HBM3
// (700.00 W) with a map that has no sentinel: gather8 0.30 ms against a bound
// of 0.17 ms (m = 524288, n = 8192, c = 256; chip_smoke.py); scatter8 1.97-1.99
// ms, 0.33 of it the transposed map, against a bound of 0.22 ms (m = 655360,
// n = 10240, c = 256, 512 pairs a target; tools/kernel_shapes.py).
//
// gather8: one warp per output row.  Lanes 0-7 read the row's 8 indices and
// weights once and share them by shuffle; each lane then owns 16-byte column
// slices (float4, neighbouring lanes on neighbouring addresses), loads its
// slice of the 8 source rows (a sentinel tap loads nothing and counts as a
// zero row) and sums over k in ascending order.  Every product and every sum
// is rounded on its own (__fmul_rn / __fadd_rn, no FMA contraction), which is
// the arithmetic of the plain PyTorch version, so the two are bit-equal.
//
// scatter8: deterministic, no float atomics.  The first version of this
// kernel took its transposed map from a stable torch.sort of all m * 8 keys and
// torch.searchsorted (0.36-0.39 ms of its ~0.4-0.56 ms a call on an SPVCNN
// train step, NVIDIA H100 80GB HBM3, 700.00 W), though only ~2 % of the pairs
// are real there, and it gave every target a 256-thread block, most of whose
// threads idled at ~1 pair a target.  Here the map is built on the device in
// the same call, with integer atomics only, and the sum's unit of work is
// sized to the segment:
//
//   1. map_count: one pass over nbr (a thread a pair, grid from m * 8) drops
//      the sentinels and counts each target's pairs (integer atomicAdd,
//      aggregated over the lanes of a warp that share a target).
//   2. map_tile_sums + map_scan: the counts' sum per tile of 4096, then each
//      tile scanned from the sum of the tiles before it into offsets[n + 1].
//   3. map_fill: a second pass drops the sentinels and writes each real pair
//      i * 8 + k into its target's segment at a slot taken with an integer
//      atomic; the order inside a segment is then arbitrary.
//   4. map_sort: a warp per target sorts its segment ascending: runs of 32 by
//      rank in registers, then runs merged pairwise, each element placed by a
//      binary search of the other run (exact: the ids are distinct), in shared
//      memory up to kSortCap ids.  A warp alone would take milliseconds over a
//      segment of thousands (a full map's last target collects ~9k pairs), so
//      a longer segment goes to map_rank, which places each id by counting the
//      smaller ones, with the segment's chunks spread over the grid: length^2
//      integer compares, exact at any length.  The result equals the stable
//      sort's order and offsets.
//   5. scatter8_sum: a warp per target, its lanes on float4 column slices,
//      the segment's ids and weights read 32 at a time and passed by shuffle,
//      summed in blocks of kBlockSum pairs (a block's sum is added to the
//      total, so no register carries a sum of thousands of terms).  A segment
//      longer than kLongSegment is split over the block's 8 warps into eight
//      contiguous parts whose partials are added in warp order.
//
// The order of every sum depends on the map alone, so one input gives the
// same bits on every run.  What bounds it: bytes; a dy row is read once per
// real tap (up to 8 times the bound's bytes on a full map), and reading each
// row once with the targets' partial sums kept on chip is the next step.  On
// an NVIDIA H100 80GB HBM3 (700.00 W) the two calls of a B = 5 SPVCNN train
// step take 0.21-0.23 ms, 0.05 ms of device time a call for the map
// (tools/kernel_shapes.py), where the first version took 0.98-1.02 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 8;
constexpr int kWarpsPerBlock = 8;
constexpr int kBlockSum = 16;
constexpr int kMapThreads = 256;
constexpr int kScanPer = 16;  // counts a scan thread takes
constexpr int kScanTile = kScanPer * kMapThreads;  // counts a scan block takes
constexpr int kSortCap = 512;  // ids a warp sorts in shared memory
constexpr int kRankTile = 2048;  // ids of a segment staged at once to count against
constexpr int kRankBlocks = 264;  // the counting kernel's grid: two blocks an SM
constexpr int kLongSegment = 128;  // pairs; a longer segment is split over the block's warps
constexpr int kMaxScatterC = 1024;
constexpr unsigned kFull = 0xffffffffu;

// Four consecutive row values from column slice `col` of f32 rows (float4) or
// of bf16 rows (8 bytes, widened exactly to f32).
template <bool BF16>
__device__ __forceinline__ float4 load4(const void* __restrict__ rows, size_t col) {
  if (BF16) {
    const uint2 b = __ldg(reinterpret_cast<const uint2*>(rows) + col);
    return make_float4(__uint_as_float(b.x << 16), __uint_as_float(b.x & 0xffff0000u), __uint_as_float(b.y << 16),
                       __uint_as_float(b.y & 0xffff0000u));
  }
  return __ldg(reinterpret_cast<const float4*>(rows) + col);
}

// w rounded to bf16 (to nearest, ties to even) and widened back to f32.
__device__ __forceinline__ float round_bf16(float w) { return __bfloat162float(__float2bfloat16_rn(w)); }

__device__ __forceinline__ void axpy_rn(float4& acc, float w, const float4& v) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, v.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, v.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, v.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w, v.w));
}

template <bool BF16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather8_kernel(const void* __restrict__ feats, const int* __restrict__ nbr,
               const float* __restrict__ w8, float4* __restrict__ out, int m, int n, int c4) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  int idx = n;
  float w = 0.0f;
  if (lane < kTaps) {
    idx = nbr[(size_t)row * kTaps + lane];
    w = w8[(size_t)row * kTaps + lane];
  }
  int idxs[kTaps];
  float ws[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    idxs[k] = __shfl_sync(0xffffffffu, idx, k);
    ws[k] = __shfl_sync(0xffffffffu, w, k);
  }
  float4* o = out + (size_t)row * c4;
  for (int col = lane; col < c4; col += 32) {
    float4 v[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const int j = idxs[k];
      v[k] = (j >= 0 && j < n) ? load4<BF16>(feats, (size_t)j * c4 + col) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kTaps; ++k) axpy_rn(acc, ws[k], v[k]);
    o[col] = acc;
  }
}

__global__ void map_count_kernel(const int* __restrict__ nbr, int pairs, int n, int* __restrict__ counts) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int key = p < pairs ? nbr[p] : -1;
  const bool real = key >= 0 && key < n;
  const unsigned active = __ballot_sync(kFull, real);
  if (!real) return;
  const unsigned same = __match_any_sync(active, key);
  if ((threadIdx.x & 31) == __ffs(same) - 1) atomicAdd(counts + key, __popc(same));
}

// The sum of a block's values, returned to every thread (kMapThreads threads).
__device__ __forceinline__ int block_sum(int v, int* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();  // scratch may still be read from an earlier call
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kMapThreads / 32; ++w) total += scratch[w];
  return total;
}

__global__ void __launch_bounds__(kMapThreads)
map_tile_sums_kernel(const int* __restrict__ counts, int n, int* __restrict__ tile_sums) {
  __shared__ int scratch[kMapThreads / 32];
  const int base = blockIdx.x * kScanTile;
  int sum = 0;
  for (int k = threadIdx.x; k < kScanTile; k += kMapThreads) sum += base + k < n ? counts[base + k] : 0;
  sum = block_sum(sum, scratch);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = sum;
}

// A block per tile of kScanTile counts: the tile's carry is the sum of the
// tiles before it; the tile is staged in shared memory (padded so that each
// thread's kScanPer consecutive counts lie in distinct banks) and scanned.
__global__ void __launch_bounds__(kMapThreads)
map_scan_kernel(const int* __restrict__ counts, int n, const int* __restrict__ tile_sums, int* __restrict__ offsets) {
  __shared__ int stage[kScanTile + kScanTile / 32];
  __shared__ int scratch[kMapThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kScanTile;
  int carry = 0;
  for (int k = threadIdx.x; k < (int)blockIdx.x; k += kMapThreads) carry += tile_sums[k];
  carry = block_sum(carry, scratch);
  for (int k = threadIdx.x; k < kScanTile; k += kMapThreads) stage[k + k / 32] = base + k < n ? counts[base + k] : 0;
  __syncthreads();
  const int i0 = kScanPer * threadIdx.x;
  int v[kScanPer];
  int local = 0;
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
    v[k] = stage[i0 + k + (i0 + k) / 32];
    local += v[k];
  }
  int x = local;  // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();  // block_sum's last read of scratch is done
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int excl = x - local;
  for (int w = 0; w < warp; ++w) excl += scratch[w];
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
    stage[i0 + k + (i0 + k) / 32] = excl;
    excl += v[k];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kScanTile; k += kMapThreads) {
    if (base + k < n) offsets[base + k] = carry + stage[k + k / 32];
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == kMapThreads - 1) offsets[n] = carry + excl;
}

__global__ void map_fill_kernel(const int* __restrict__ nbr, int pairs, int n, const int* __restrict__ offsets,
                                int* __restrict__ counts, int* __restrict__ order) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int key = p < pairs ? nbr[p] : -1;
  const bool real = key >= 0 && key < n;
  const unsigned active = __ballot_sync(kFull, real);
  if (!real) return;
  const int lane = threadIdx.x & 31;
  const unsigned same = __match_any_sync(active, key);
  const int leader = __ffs(same) - 1;
  int top = 0;
  if (lane == leader) top = atomicSub(counts + key, __popc(same));  // the segment's free slots are [0, top)
  top = __shfl_sync(same, top, leader);
  const int rank = __popc(same & ((1u << lane) - 1u));
  order[offsets[key] + top - 1 - rank] = p;
}

// Rank of v among the first len lanes' values (distinct, len <= 32, warp-uniform).
__device__ __forceinline__ int rank_in_warp(int v, int len) {
  int rank = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) rank += (j < len) & (__shfl_sync(kFull, v, j) < v);
  return rank;
}

// A warp per target.  A segment of up to kSortCap ids is sorted in shared
// memory; a longer one is copied to tmp and listed for map_rank_kernel.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
map_sort_kernel(const int* __restrict__ offsets, int n, int* __restrict__ order, int* __restrict__ tmp,
                int* __restrict__ long_count, int* __restrict__ long_list) {
  __shared__ int buf[kWarpsPerBlock][2 * kSortCap];
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * kWarpsPerBlock + warp;
  if (t >= n) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int begin = offsets[t];
  const int len = offsets[t + 1] - begin;
  if (len <= 1) return;
  int* seg = order + begin;
  if (len > kSortCap) {
    for (int i = lane; i < len; i += 32) tmp[begin + i] = seg[i];
    if (lane == 0) long_list[atomicAdd(long_count, 1)] = t;  // the list's order does not matter
    return;
  }
  int* src = buf[warp];
  int* dst = buf[warp] + kSortCap;
  for (int i = lane; i < len; i += 32) src[i] = seg[i];
  __syncwarp();
  // runs of 32, each sorted in place
  for (int r0 = 0; r0 < len; r0 += 32) {
    const int rl = min(32, len - r0);
    const int v = lane < rl ? src[r0 + lane] : 0;
    const int rank = rank_in_warp(v, rl);
    __syncwarp();
    if (lane < rl) src[r0 + rank] = v;
  }
  __syncwarp();
  // runs of w merged pairwise: an element's place is its index in its own run
  // plus the number of smaller elements in the other run
  for (int w = 32; w < len; w *= 2) {
    for (int i = lane; i < len; i += 32) {
      const int v = src[i];
      const int run = i / w;
      const int other0 = (run ^ 1) * w;
      int lo = other0, hi = max(other0, min(other0 + w, len));
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (src[mid] < v) lo = mid + 1; else hi = mid;
      }
      dst[(run & ~1) * w + (i - run * w) + (lo - other0)] = v;
    }
    __syncwarp();
    int* swap = src;
    src = dst;
    dst = swap;
  }
  for (int i = lane; i < len; i += 32) seg[i] = src[i];
}

// The listed segments (longer than kSortCap), unsorted in tmp: each
// id's place is the number of smaller ids in its segment, counted against the
// segment streamed through shared memory.  Chunks of 256 ids go round-robin
// to the grid's blocks, so one long segment keeps many SMs busy.
__global__ void __launch_bounds__(kMapThreads)
map_rank_kernel(const int* __restrict__ offsets, const int* __restrict__ long_count,
                const int* __restrict__ long_list, const int* __restrict__ tmp, int* __restrict__ order) {
  __shared__ __align__(16) int tile[kRankTile];
  const int count = *long_count;
  int chunk0 = 0;  // chunks of the entries before this one
  for (int e = 0; e < count; ++e) {
    const int t = long_list[e];
    const int begin = offsets[t];
    const int len = offsets[t + 1] - begin;
    const int chunks = (len + kMapThreads - 1) / kMapThreads;
    const int* src = tmp + begin;
    const int first = (((int)blockIdx.x - chunk0) % (int)gridDim.x + (int)gridDim.x) % (int)gridDim.x;
    for (int c = first; c < chunks; c += gridDim.x) {  // block-uniform
      const int i = c * kMapThreads + threadIdx.x;
      const int x = i < len ? src[i] : 0x7fffffff;
      int rank = 0;
      for (int s0 = 0; s0 < len; s0 += kRankTile) {
        const int sl = min(kRankTile, len - s0);
        __syncthreads();  // the previous tile has been read
        for (int k = threadIdx.x; k < kRankTile; k += kMapThreads) tile[k] = k < sl ? src[s0 + k] : 0x7fffffff;
        __syncthreads();
        for (int k = 0; k < sl; k += 4) {  // ids are below 2^31 - 1, so the padding never counts
          const int4 y = *reinterpret_cast<const int4*>(tile + k);
          rank += (y.x < x) + (y.y < x) + (y.z < x) + (y.w < x);
        }
      }
      if (i < len) order[begin + rank] = x;
    }
    chunk0 += chunks;
  }
}

// One warp's sum over the pairs order[begin : end] of a target, S float4
// column slices a lane.
template <int S, bool BF16>
__device__ __forceinline__ void segment_sum(const void* __restrict__ dy, const float* __restrict__ w8,
                                            const int* __restrict__ order, int begin, int end, int c4,
                                            int lane, float4 (&total)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) total[s] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p0 = begin; p0 < end; p0 += 32) {
    const int cnt = min(32, end - p0);
    int pid = 0;
    float w = 0.0f;
    if (lane < cnt) {
      pid = order[p0 + lane];  // i * 8 + k
      w = BF16 ? round_bf16(w8[pid]) : w8[pid];
    }
    for (int h = 0; h < cnt; h += kBlockSum) {
      float4 blk[S];
#pragma unroll
      for (int s = 0; s < S; ++s) blk[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      const int he = min(h + kBlockSum, cnt);
#pragma unroll 4
      for (int j = h; j < he; ++j) {
        const int pair = __shfl_sync(kFull, pid, j);
        const float wj = __shfl_sync(kFull, w, j);
        const size_t row = (size_t)(pair >> 3) * c4;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int col = lane + 32 * s;
          if (col < c4) {
            const float4 v = load4<BF16>(dy, row + col);
            blk[s].x += wj * v.x;
            blk[s].y += wj * v.y;
            blk[s].z += wj * v.z;
            blk[s].w += wj * v.w;
          }
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        total[s].x += blk[s].x;
        total[s].y += blk[s].y;
        total[s].z += blk[s].z;
        total[s].w += blk[s].w;
      }
    }
  }
}

template <int S, bool BF16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
scatter8_sum_kernel(const void* __restrict__ dy, const float* __restrict__ w8, const int* __restrict__ order,
                    const int* __restrict__ offsets, float4* __restrict__ out, int n, int c4) {
  __shared__ float4 part[kWarpsPerBlock][32 * S];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarpsPerBlock + warp;
  float4 total[S];
  if (t < n) {
    const int begin = offsets[t];
    const int end = offsets[t + 1];
    if (end - begin <= kLongSegment) {
      segment_sum<S, BF16>(dy, w8, order, begin, end, c4, lane, total);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int col = lane + 32 * s;
        if (col < c4) out[(size_t)t * c4 + col] = total[s];
      }
    }
  }
  // the block's long segments: each warp sums an eighth, the partials are added in warp order
  for (int w = 0; w < kWarpsPerBlock; ++w) {
    const int tw = blockIdx.x * kWarpsPerBlock + w;
    if (tw >= n) break;
    const int begin = offsets[tw];
    const int len = offsets[tw + 1] - begin;
    if (len <= kLongSegment) continue;
    segment_sum<S, BF16>(dy, w8, order, begin + (int)((long long)len * warp / kWarpsPerBlock),
                   begin + (int)((long long)len * (warp + 1) / kWarpsPerBlock), c4, lane, total);
#pragma unroll
    for (int s = 0; s < S; ++s) part[warp][lane + 32 * s] = total[s];
    __syncthreads();
    for (int col = threadIdx.x; col < c4; col += kWarpsPerBlock * 32) {
      float4 acc = part[0][col];
      for (int ww = 1; ww < kWarpsPerBlock; ++ww) {
        const float4 q = part[ww][col];
        acc.x += q.x;
        acc.y += q.y;
        acc.z += q.z;
        acc.w += q.w;
      }
      out[(size_t)tw * c4 + col] = acc;
    }
    __syncthreads();
  }
}

template <int S>
void launch_sum(int bf16, unsigned blocks, cudaStream_t st, const void* dy, const float* w8, const int* order,
                const int* offsets, float4* out, int n, int c4) {
  if (bf16)
    scatter8_sum_kernel<S, true><<<blocks, kWarpsPerBlock * 32, 0, st>>>(dy, w8, order, offsets, out, n, c4);
  else
    scatter8_sum_kernel<S, false><<<blocks, kWarpsPerBlock * 32, 0, st>>>(dy, w8, order, offsets, out, n, c4);
}

// counts: int32 [2 n + 2 + n / kScanTile], the per-target counts, the number
// of listed long segments, their list, then the scan's tile sums.
int build_map(const int* nbr, int pairs, int n, int* counts, int* offsets, int* order, int* tmp,
              cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(counts, 0, (size_t)(n + 1) * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const unsigned pair_blocks = (unsigned)((pairs + kMapThreads - 1) / kMapThreads);
  if (pairs > 0) map_count_kernel<<<pair_blocks, kMapThreads, 0, stream>>>(nbr, pairs, n, counts);
  const unsigned tiles = (unsigned)max(1, (n + kScanTile - 1) / kScanTile);
  int* tile_sums = counts + 2 * n + 1;
  map_tile_sums_kernel<<<tiles, kMapThreads, 0, stream>>>(counts, n, tile_sums);
  map_scan_kernel<<<tiles, kMapThreads, 0, stream>>>(counts, n, tile_sums, offsets);
  if (pairs > 0) map_fill_kernel<<<pair_blocks, kMapThreads, 0, stream>>>(nbr, pairs, n, offsets, counts, order);
  map_sort_kernel<<<(unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock), kWarpsPerBlock * 32, 0, stream>>>(
      offsets, n, order, tmp, counts + n, counts + n + 1);
  map_rank_kernel<<<kRankBlocks, kMapThreads, 0, stream>>>(offsets, counts + n, counts + n + 1, tmp, order);
  return (int)cudaGetLastError();
}

}  // namespace

// feats: f32 [n, c] (bf16 == 0) or bf16 [n, c] (bf16 == 1); nbr: int32 [m, 8];
// w8: f32 [m, 8]; out: f32 [m, c]; all contiguous on the current device, feats
// and out 16-byte aligned (8-byte for bf16 rows), c % 4 == 0.  Returns
// cudaGetLastError() after the launch.
extern "C" int lidal_gather8(const void* feats, const void* nbr, const void* w8, void* out,
                             int m, int n, int c, int bf16, void* stream) {
  if (m == 0 || c == 0) return (int)cudaSuccess;
  if (m < 0 || n < 0 || c < 0 || c % 4 != 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((m + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const auto st = (cudaStream_t)stream;
  if (bf16)
    gather8_kernel<true><<<blocks, kWarpsPerBlock * 32, 0, st>>>(feats, (const int*)nbr, (const float*)w8, (float4*)out,
                                                                 m, n, c / 4);
  else
    gather8_kernel<false><<<blocks, kWarpsPerBlock * 32, 0, st>>>(feats, (const int*)nbr, (const float*)w8,
                                                                  (float4*)out, m, n, c / 4);
  return (int)cudaGetLastError();
}

// The transposed map of nbr (int32 [m, 8]) over n targets: offsets int32
// [n + 1] and order int32 [m * 8], whose first offsets[n] entries are the real
// pairs i * 8 + k grouped by target, ascending within a target (the stable
// sort's order; the rest is scratch).  counts: int32 [2 n + 2 + n / 4096],
// tmp: int32 [m * 8], scratch.  All contiguous on the current device; m * 8 < 2^31.  Returns
// cudaGetLastError() after the launches.
extern "C" int lidal_transpose8(const void* nbr, void* counts, void* offsets, void* order, void* tmp,
                                int m, int n, void* stream) {
  if (m < 0 || n < 0 || m > (0x7fffffff >> 3)) return (int)cudaErrorInvalidValue;
  return build_map((const int*)nbr, m * kTaps, n, (int*)counts, (int*)offsets, (int*)order, (int*)tmp,
                   (cudaStream_t)stream);
}

// dy: f32 [m, c] (bf16 == 0) or bf16 [m, c] (bf16 == 1, and each w8 then
// rounded to bf16 as it is read); w8: f32 [m, 8]; nbr: int32 [m, 8]; counts,
// offsets, order, tmp: the scratch of lidal_transpose8; out: f32 [n, c]; all
// contiguous on the current device, dy and out 16-byte aligned (8-byte for
// bf16 rows), c % 4 == 0 and c <= 1024.  Builds the transposed map, then sums.
// Returns cudaGetLastError() after the launches.
extern "C" int lidal_scatter8(const void* dy, const void* w8, const void* nbr, void* counts, void* offsets,
                              void* order, void* tmp, void* out, int m, int n, int c, int bf16, void* stream) {
  if (n == 0 || c == 0) return (int)cudaSuccess;
  if (m < 0 || n < 0 || c < 0 || c % 4 != 0 || c > kMaxScatterC || m > (0x7fffffff >> 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = build_map((const int*)nbr, m * kTaps, n, (int*)counts, (int*)offsets, (int*)order,
                            (int*)tmp, st);
  if (err != (int)cudaSuccess) return err;
  const int c4 = c / 4;
  const unsigned blocks = (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const float* w = (const float*)w8;
  const int* o = (const int*)order;
  const int* off = (const int*)offsets;
  float4* y = (float4*)out;
  if (c4 <= 32) {
    launch_sum<1>(bf16, blocks, st, dy, w, o, off, y, n, c4);
  } else if (c4 <= 64) {
    launch_sum<2>(bf16, blocks, st, dy, w, o, off, y, n, c4);
  } else if (c4 <= 128) {
    launch_sum<4>(bf16, blocks, st, dy, w, o, off, y, n, c4);
  } else {
    launch_sum<8>(bf16, blocks, st, dy, w, o, off, y, n, c4);
  }
  return (int)cudaGetLastError();
}
