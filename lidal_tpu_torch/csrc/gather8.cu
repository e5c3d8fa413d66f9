// Weighted 8-tap row gather, its transpose, and the child-sum chain of the
// SPVCNN point branch.
//
// Replaces lidal_tpu/ops/pallas_gather8.py:gather8_pallas and scatter8_pallas:
//
//   gather8:    out[i]    = sum_{k < 8} w8[i, k] * feats[nbr[i, k]]
//   scatter8:   dfeats[t] = sum_{(i, k): nbr[i, k] == t} w8[i, k] * dy[i]
//   child sums: out[o]    = (sum over the subtree of o) / max(counts[o], 1)
//
// The last is the chain of gather8_pallas calls with weights 1 that
// lidal_tpu/ops/devoxelize.py:_child_sum runs down the voxel tree (levels
// chained 8-tap child sums, then the divide by the ancestor counts), in one
// launch.  An index outside [0, n) is the sentinel and contributes zero.  The
// columns of nbr need not be sorted.
//
// The TPU kernels turn all of this into matrix products with one-hot blocks
// over a band of the sorted map, in bf16.  None of that carries over: an SM
// gathers rows directly, in f32.  The bf16 route (ops/conv.BF16_OPERANDS, the
// counterpart of lidal_tpu/ops/conv.py:USE_PALLAS and
// pallas_gather8.py:USE_PALLAS_BWD set together) rounds what the TPU
// kernels round: gather8 reads its table as bf16 (pallas_gather8.py:139; the
// one-hot product of :105-106 is exact, w8 stays f32), every level of the
// child-sum chain reads the level below as bf16 (each gather8_pallas call
// casts its table), scatter8 reads dy as bf16 and rounds w8 to bf16 (:314 and
// the weighted one-hot of :284).  The kernels read the f32 rows and round each
// value in registers (to nearest, ties to even, two values a conversion: the
// bits of a cast), so no bf16 copy of a table is made; the products and sums
// stay f32, in the same order.  The price is a conversion per value read: on
// a full map, where each table value is read 8 times, the route's trilinear
// gather took 0.39-0.40 ms against f32's 0.31 (phase 14 / 30 (a) below).
//
// What bounds them on an H100: bytes.  gather8 does 2 operations for every 4
// bytes it reads.  Its trilinear calls at B = 4 write 537 and 268 MB and read
// tables of 8 and 34 MB that stay in the 50 MB L2; on SPVCNN's maps most rows
// have no real corner.
//
// gather8: warps stream over the rows, 4 rows a step.  A step's 32 (index,
// weight) pairs are one coalesced load, one pair a lane, and the next step's
// are loaded before the current step's sums.  A row with no real tap and
// finite weights is +0 exactly (+0 plus any w * 0), so it is stored without
// loads, and a step of four such rows as one contiguous run.  Otherwise each
// lane owns 16-byte column slices, loads its slice of the 8 source rows (a
// sentinel tap loads nothing and counts as a zero row) and sums over k in
// ascending order.  Every product and every sum is rounded on its own
// (__fmul_rn / __fadd_rn, no FMA contraction), which is the arithmetic of the
// plain PyTorch version, so the two are bit-equal.  The map is read and the
// output written with evict-first hints (__ldcs / __stcs), so the hundreds of
// MB streamed through L2 do not push the table out (plain stores were 4.5 %
// slower on the B = 4 level-4 call).  The grid is as many blocks as the card
// holds at once, at most 64 registers a thread: with 80 or 127 (an unrolled
// column loop) a full map ran 15-70 % slower.  Measured on an NVIDIA H100
// 80GB HBM3 (700.00 W), chip_smoke.py phase 14: the two trilinear calls of a
// B = 4 SPVCNN forward 0.222 + 0.134 ms against bounds of 0.173 + 0.100 ms
// (the first version 0.257-0.268 + 0.178-0.182); a torch zero_() of the
// 537 MB output alone takes 0.165 ms there.
//
// child sums: a warp per row of the chain's last level walks its subtree
// depth first and keeps one partial sum per level in registers.  The walk is
// a chain of dependent loads, so each step fetches as much as it can at once:
// a node's 8 children arrive in lanes 0-7, and above the points the 8
// children's own child rows in one load (two indices a lane); at the lowest
// level the 8 point rows are loaded together; the warp's next row's children
// are loaded before the current subtree is walked.  Each level's sum runs
// over its 8 children in ascending order, a sentinel child adding +0, every
// add rounded on its own: the chain's order, so the result is bit-equal to
// the levels run one after another.  Only the last level is written, divided
// by its count in the epilogue (IEEE division, the bits of torch's).  A point
// without an ancestor at the last level is never read, where the chain read
// and wrote every level in full, empty rows included.  The backward is not
// here: it is one row gather through the points' ancestors
// (ops/devoxelize.py).  Measured as above: the two chains of a B = 4 forward
// 0.049-0.066 + 0.061-0.066 ms, where the same levels as six gather8 launches
// take 0.46-0.83 ms; on full trees (every point under the last level)
// 0.115-0.124 and 0.223-0.233 ms against 0.23-0.42 and 0.43-0.70.  They are
// latency-bound (bounds 0.007-0.022 ms): the sparse trees leave ~2 points
// under a level-4 voxel, and a warp's walk is ~5 dependent loads deep.
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
constexpr int kRowsPerStep = 4;  // gather8 rows a warp takes at once: 4 x 8 (index, weight) pairs, one a lane
constexpr int kBlockSum = 16;
constexpr int kMapThreads = 256;
constexpr int kScanPer = 16;  // counts a scan thread takes
constexpr int kScanTile = kScanPer * kMapThreads;  // counts a scan block takes
constexpr int kSortCap = 512;  // ids a warp sorts in shared memory
constexpr int kRankTile = 2048;  // ids of a segment staged at once to count against
constexpr int kRankBlocks = 264;  // the counting kernel's grid: two blocks an SM
constexpr int kLongSegment = 128;  // pairs; a longer segment is split over the block's warps
constexpr int kMaxScatterC = 1024;
constexpr int kMaxChainLevels = 4;
constexpr int kMaxChainC = 512;
constexpr unsigned kFull = 0xffffffffu;

// v rounded to bf16 (to nearest, ties to even) and widened back to f32.
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// Four values rounded to bf16 (to nearest, ties to even) and widened back,
// two to a conversion.
__device__ __forceinline__ void round4(float4& v) {
  const float2 lo = __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
  const float2 hi = __bfloat1622float2(__floats2bfloat162_rn(v.z, v.w));
  v = make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Four consecutive values from column slice `col` of f32 rows, each rounded
// to bf16 when ROUND: the bits a bf16 copy of the rows would give.
template <bool ROUND>
__device__ __forceinline__ float4 load4(const float4* __restrict__ rows, size_t col) {
  float4 v = __ldg(rows + col);
  if (ROUND) round4(v);
  return v;
}

__device__ __forceinline__ void axpy_rn(float4& acc, float w, const float4& v) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, v.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, v.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, v.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w, v.w));
}

__device__ __forceinline__ void add_rn(float4& acc, const float4& v) {
  acc.x = __fadd_rn(acc.x, v.x);
  acc.y = __fadd_rn(acc.y, v.y);
  acc.z = __fadd_rn(acc.z, v.z);
  acc.w = __fadd_rn(acc.w, v.w);
}

// Blocks of `kernel` the card holds at once (all its SMs), at most `want`.
template <typename Kernel>
unsigned resident_blocks(Kernel kernel, long long want) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarpsPerBlock * 32, 0);
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (unsigned)(want < cap ? (want > 0 ? want : 1) : cap);
}

// At most 64 registers a thread (32 warps an SM): a row with real taps keeps
// 8 loads in flight a lane, so the card needs many warps to cover their latency.
template <bool ROUND>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 4)
gather8_kernel(const float4* __restrict__ feats, const int* __restrict__ nbr, const float* __restrict__ w8,
               float4* __restrict__ out, int m, int n, int c4) {
  const int lane = threadIdx.x & 31;
  const long long pairs = (long long)m * kTaps;
  const long long steps = ((long long)m + kRowsPerStep - 1) / kRowsPerStep;
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  long long step = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  // lane l holds tap l % 8 of row l / 8 of its step
  int idx = n;
  float w = 0.0f;
  if (step < steps && step * 32 + lane < pairs) {
    idx = __ldcs(nbr + step * 32 + lane);
    w = __ldcs(w8 + step * 32 + lane);
  }
  for (; step < steps; step += stride) {  // warp-uniform
    const long long next = step + stride;
    int next_idx = n;
    float next_w = 0.0f;
    if (next < steps && next * 32 + lane < pairs) {  // the next step's map, in flight during this step
      next_idx = __ldcs(nbr + next * 32 + lane);
      next_w = __ldcs(w8 + next * 32 + lane);
    }
    // taps that need their sum: a real row, or a weight whose product with 0 is not 0;
    // a row without one is +0 plus w * 0, eight times: +0 exactly
    const unsigned busy = __ballot_sync(kFull, (idx >= 0 && idx < n) || !isfinite(w));
    if (busy == 0) {  // the step's rows are one contiguous run of zeros
      const long long first = step * kRowsPerStep;
      const long long len = ((first + kRowsPerStep < m ? first + kRowsPerStep : m) - first) * c4;
      for (long long i = lane; i < len; i += 32) __stcs(out + first * c4 + i, make_float4(0.f, 0.f, 0.f, 0.f));
    }
    for (int r = 0; r < kRowsPerStep && busy != 0; ++r) {
      const long long row = step * kRowsPerStep + r;
      if (row >= m) break;
      float4* o = out + row * c4;
      if (((busy >> (8 * r)) & 0xffu) == 0) {
        for (int col = lane; col < c4; col += 32) __stcs(o + col, make_float4(0.f, 0.f, 0.f, 0.f));
        continue;
      }
      int idxs[kTaps];
      float ws[kTaps];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        idxs[k] = __shfl_sync(kFull, idx, 8 * r + k);
        ws[k] = __shfl_sync(kFull, w, 8 * r + k);
      }
      for (int col = lane; col < c4; col += 32) {
        float4 v[kTaps];
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          const int j = idxs[k];
          v[k] = (j >= 0 && j < n) ? load4<ROUND>(feats, (size_t)j * c4 + col) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k = 0; k < kTaps; ++k) axpy_rn(acc, ws[k], v[k]);
        __stcs(o + col, acc);
      }
    }
    idx = next_idx;
    w = next_w;
  }
}

// The chain's arguments: the points and each level's child map.
struct Chain {
  const float4* x;  // [frames * caps[0], c4]
  const int* child[kMaxChainLevels];  // child[l]: [frames, caps[l + 1], 8], rows of level l of the frame
  int caps[kMaxChainLevels + 1];  // rows of each level per frame; a child outside [0, caps[l]) is the sentinel
  int c4;
};

// The sum at level D >= 1 (before the divide) of a node whose 8 children
// (rows of level D - 1) lanes 0-7 hold in `j`, into acc, S float4 column
// slices a lane: the children in ascending order, each add rounded on its
// own, a sentinel child adding +0.  With ROUND every child (a point row, or
// the sum of a level below) is rounded to bf16 before it is added, as each
// level's table is on the route.  Above the points, the 8 children's own
// child rows arrive in one load (lanes 4k..4k+3 read child k's, two indices
// each) before the first child's subtree is walked.
template <int D, int S, bool ROUND>
__device__ __forceinline__ void children_sum(const Chain& a, int b, int j, int lane, float4 (&acc)[S]) {
  const int cap_f = a.caps[D - 1];
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (D == 1) {
    int idxs[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) idxs[k] = __shfl_sync(kFull, j, k);
    const float4* x = a.x + (size_t)b * cap_f * a.c4;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int col = lane + 32 * s;
      float4 v[kTaps];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const bool real = idxs[k] >= 0 && idxs[k] < cap_f && col < a.c4;
        v[k] = real ? load4<ROUND>(x, (size_t)idxs[k] * a.c4 + col) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kTaps; ++k) add_rn(acc[s], v[k]);
    }
  } else {
    const int cap_g = a.caps[D - 2];
    const int own = __shfl_sync(kFull, j, lane >> 2);
    int2 g = make_int2(cap_g, cap_g);
    if (own >= 0 && own < cap_f) {
      g = __ldg(reinterpret_cast<const int2*>(a.child[D - 2] + ((size_t)b * cap_f + own) * kTaps) + (lane & 3));
    }
#pragma unroll 1
    for (int k = 0; k < kTaps; ++k) {
      const int jk = __shfl_sync(kFull, j, k);
      float4 sub[S];
      if (jk >= 0 && jk < cap_f) {  // warp-uniform
        // child k's children into lanes 0-7: lane t takes half t % 2 of lane 4k + t / 2's pair
        const int src = 4 * k + ((lane >> 1) & 3);
        const int gx = __shfl_sync(kFull, g.x, src), gy = __shfl_sync(kFull, g.y, src);
        children_sum<D - 1, S, ROUND>(a, b, (lane & 1) ? gy : gx, lane, sub);
        if (ROUND) {
#pragma unroll
          for (int s = 0; s < S; ++s) round4(sub[s]);
        }
      } else {
#pragma unroll
        for (int s = 0; s < S; ++s) sub[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int s = 0; s < S; ++s) add_rn(acc[s], sub[s]);
    }
  }
}

// The children of row o of the last level (o < rows) in lanes 0-7, else sentinels.
__device__ __forceinline__ int root_children(const Chain& a, int levels, long long o, long long rows, int lane) {
  int j = -1;
  if (o < rows && lane < kTaps) j = __ldg(a.child[levels - 1] + o * kTaps + lane);
  return j;
}

// A warp per row of level L: the subtree's sum divided by max(count, 1).
// The next row's children are loaded before this row's subtree is walked.
template <int L, int S, bool ROUND>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
child_sum_kernel(Chain a, const int* __restrict__ counts, float4* __restrict__ out, int frames) {
  const int lane = threadIdx.x & 31;
  const long long rows = (long long)frames * a.caps[L];
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  long long o = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  int j = root_children(a, L, o, rows, lane);
  for (; o < rows; o += stride) {  // warp-uniform
    const int j_next = root_children(a, L, o + stride, rows, lane);
    const int b = (int)(o / a.caps[L]);
    float4 acc[S];
    children_sum<L, S, ROUND>(a, b, j, lane, acc);
    const int cnt = counts[o];
    const float d = (float)(cnt > 1 ? cnt : 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int col = lane + 32 * s;
      if (col < a.c4) {
        out[o * a.c4 + col] = make_float4(__fdiv_rn(acc[s].x, d), __fdiv_rn(acc[s].y, d), __fdiv_rn(acc[s].z, d),
                                          __fdiv_rn(acc[s].w, d));
      }
    }
    j = j_next;
  }
}

template <int L, int S>
int launch_chain(const Chain& a, const int* counts, float4* out, int frames, int round, cudaStream_t st) {
  const long long warps = (long long)frames * a.caps[L];
  const long long want = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (round) {
    const unsigned blocks = resident_blocks(child_sum_kernel<L, S, true>, want);
    child_sum_kernel<L, S, true><<<blocks, kWarpsPerBlock * 32, 0, st>>>(a, counts, out, frames);
  } else {
    const unsigned blocks = resident_blocks(child_sum_kernel<L, S, false>, want);
    child_sum_kernel<L, S, false><<<blocks, kWarpsPerBlock * 32, 0, st>>>(a, counts, out, frames);
  }
  return (int)cudaGetLastError();
}

template <int L>
int launch_chain_s(const Chain& a, const int* counts, float4* out, int frames, int round, cudaStream_t st) {
  if (a.c4 <= 32) return launch_chain<L, 1>(a, counts, out, frames, round, st);
  if (a.c4 <= 64) return launch_chain<L, 2>(a, counts, out, frames, round, st);
  return launch_chain<L, 4>(a, counts, out, frames, round, st);
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
__device__ __forceinline__ void segment_sum(const float4* __restrict__ dy, const float* __restrict__ w8,
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
scatter8_sum_kernel(const float4* __restrict__ dy, const float* __restrict__ w8, const int* __restrict__ order,
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
void launch_sum(int bf16, unsigned blocks, cudaStream_t st, const float4* dy, const float* w8, const int* order,
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

// feats: f32 [n, c], each value rounded to bf16 as it is read when
// round_bf16 != 0; nbr: int32 [m, 8]; w8: f32 [m, 8]; out: f32 [m, c]; all
// contiguous on the current device, feats and out 16-byte aligned, c % 4 == 0.
// Returns cudaGetLastError() after the launch.
extern "C" int lidal_gather8(const void* feats, const void* nbr, const void* w8, void* out,
                             int m, int n, int c, int round_bf16, void* stream) {
  if (m == 0 || c == 0) return (int)cudaSuccess;
  if (m < 0 || n < 0 || c < 0 || c % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long want = ((long long)m + kRowsPerStep * kWarpsPerBlock - 1) / (kRowsPerStep * kWarpsPerBlock);
  const auto st = (cudaStream_t)stream;
  const auto* f = (const float4*)feats;
  if (round_bf16) {
    const unsigned blocks = resident_blocks(gather8_kernel<true>, want);
    gather8_kernel<true><<<blocks, kWarpsPerBlock * 32, 0, st>>>(f, (const int*)nbr, (const float*)w8, (float4*)out,
                                                                 m, n, c / 4);
  } else {
    const unsigned blocks = resident_blocks(gather8_kernel<false>, want);
    gather8_kernel<false><<<blocks, kWarpsPerBlock * 32, 0, st>>>(f, (const int*)nbr, (const float*)w8, (float4*)out,
                                                                  m, n, c / 4);
  }
  return (int)cudaGetLastError();
}

// The child-sum chain over `levels` (1-4) levels of `frames` frames: x f32
// [frames * caps[0], c] (each value rounded to bf16 as it is read, and each
// level's sum before the next level adds it, when round_bf16 != 0); child_l
// int32 [frames, caps[l + 1], 8], 8-byte aligned, for l < levels (a value
// outside [0, caps[l]) is the sentinel; the pointers past `levels` are not read);
// counts int32 [frames, caps[levels]]; out f32 [frames * caps[levels], c] =
// the subtree sums divided by max(counts, 1).  All contiguous on the current
// device, x and out 16-byte aligned, c % 4 == 0 and c <= 512.  Returns
// cudaGetLastError() after the launch.
extern "C" int lidal_child_sum(const void* x, const void* child0, const void* child1, const void* child2,
                               const void* child3, const void* counts, void* out, int frames, int levels, int cap0,
                               int cap1, int cap2, int cap3, int cap4, int c, int round_bf16, void* stream) {
  if (levels < 1 || levels > kMaxChainLevels || frames < 0 || c < 0 || c % 4 != 0 || c > kMaxChainC) {
    return (int)cudaErrorInvalidValue;
  }
  Chain a{(const float4*)x, {(const int*)child0, (const int*)child1, (const int*)child2, (const int*)child3},
          {cap0, cap1, cap2, cap3, cap4}, c / 4};
  for (int l = 0; l <= levels; ++l) {
    if (a.caps[l] < 0) return (int)cudaErrorInvalidValue;
  }
  if (frames == 0 || c == 0 || a.caps[levels] == 0) return (int)cudaSuccess;
  const auto st = (cudaStream_t)stream;
  const auto* cnt = (const int*)counts;
  auto* y = (float4*)out;
  switch (levels) {
    case 1: return launch_chain_s<1>(a, cnt, y, frames, round_bf16, st);
    case 2: return launch_chain_s<2>(a, cnt, y, frames, round_bf16, st);
    case 3: return launch_chain_s<3>(a, cnt, y, frames, round_bf16, st);
    default: return launch_chain_s<4>(a, cnt, y, frames, round_bf16, st);
  }
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

// dy: f32 [m, c] (with bf16 != 0 each value of dy and of w8 is rounded to
// bf16 as it is read); w8: f32 [m, 8]; nbr: int32 [m, 8]; counts, offsets,
// order, tmp: the scratch of lidal_transpose8; out: f32 [n, c]; all
// contiguous on the current device, dy and out 16-byte aligned, c % 4 == 0
// and c <= 1024.  Builds the transposed map, then sums.
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
  const auto* d = (const float4*)dy;
  const float* w = (const float*)w8;
  const int* o = (const int*)order;
  const int* off = (const int*)offsets;
  float4* y = (float4*)out;
  if (c4 <= 32) {
    launch_sum<1>(bf16, blocks, st, d, w, o, off, y, n, c4);
  } else if (c4 <= 64) {
    launch_sum<2>(bf16, blocks, st, d, w, o, off, y, n, c4);
  } else if (c4 <= 128) {
    launch_sum<4>(bf16, blocks, st, d, w, o, off, y, n, c4);
  } else {
    launch_sum<8>(bf16, blocks, st, d, w, o, off, y, n, c4);
  }
  return (int)cudaGetLastError();
}
