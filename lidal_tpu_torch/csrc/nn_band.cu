// Band-pairwise nearest neighbour for hash-grid matching (LiDAL scoring).
//
// Replaces lidal_tpu/ops/pallas_nnband.py:nn_band_pallas.  For every neighbour
// slot s and query j, over the table rows of the query tile's band
//   [blo[s, t] * TN, (blo[s, t] + nb[s, t]) * TN),  t = j / TILE,
// it returns the minimum of the f32 squared distance and the lowest row that
// attains it; (inf, 0) when the band is empty.  TILE = 256 and TN = 1024 are
// part of the function: they fix the band, and the band fixes the answer for a
// query that has no match.
//
// The TPU kernel broadcasts a [SUB, 128, TILE] distance block over the vector
// unit and brings table blocks in through two DMA rings.  None of that carries
// over.  Here one block of 256 threads serves one (query tile, slot), one query
// per thread, and stages the band into shared memory 2048 rows (a window) at a
// time with coalesced 16-byte loads.
//
// What bounds it on an H100: operations.  The table and the queries are read
// once (41 MB + 1.5 MB at 26 slots x 131072 rows), but a brute-force scan
// meets every row of the band with every query of its tile: 5.04e9 pairs a
// launch at the main-path shape, 8 unfused f32 operations each (3 subtractions,
// 3 products, 2 sums; FMA contraction is forbidden, below) plus a compare and
// two selects.  At the card's ~33.5e12 unfused f32 lanes a second that scan
// cannot go under ~1.2 ms, and the first version of this kernel, which did
// exactly that, took 2.2 ms.  So this kernel evaluates fewer pairs, exactly:
//
// * Group boxes.  The band's rows are cell-sorted, so 32 consecutive rows (a
//   group) lie close together.  Staging a window, the block reduces each
//   group's axis-aligned box [lo, hi]^3 (BIG padding rows included) into
//   shared memory.
// * A lower bound that is exact under rounding.  Per axis the gap is
//   fl(lo - q) if q < lo, fl(q - hi) if q > hi, else 0, and the gaps combine
//   with the distance's own expression, LB = (gx*gx + gy*gy) + gz*gz, each
//   product and sum rounded on its own.  For a row t of the box, |fl(t - q)|
//   >= the axis gap, because round-to-nearest is monotone (t >= lo gives
//   fl(t - q) >= fl(lo - q)) and odd (fl(q - t) = -fl(t - q)); squaring a
//   non-negative value and adding non-negative values are monotone too.  So
//   LB <= d2(row) for every row of the group, bit for bit.
// * The skip rule.  A lane may skip a group only when LB > best, strictly:
//   then no row of the group can be below best or tie with it.  The warp
//   skips the group when every lane may (__any_sync); a group that some lane
//   needs is scanned by the whole warp.  Before those tests, the warp drops
//   at once every group whose bound against the warp's query box (computed
//   the same way, so never above a lane's own) exceeds its lanes' largest best.
// * Visiting order.  A warp visits the window's groups in buckets of their
//   distance from the warp's own query box (<= 0.01, 0.04, 0.16, 0.64, then
//   the rest), ascending rows inside a bucket, so that each query meets its
//   nearest rows first and its best falls early.  Because the order is not
//   that of the rows, the update is lexicographic on (d2, row), which gives
//   the plain version's answer (the minimum, then the lowest row) in any
//   order.  It costs no instruction a pair: a group is scanned in descending
//   row order against a threshold `thr` that is best itself when the lane's
//   best row lies above the group (a tie wins) and the next float below best
//   when it lies below (a tie loses); after an update thr is the new d2, so a
//   later (lower) row that ties wins.  Each pair is then one compare and two
//   selects, as in a plain strict `<` scan.
//
// Several queries per thread (a row read from shared memory serving two or
// four queries) were considered and not taken: shared-memory reads are 3 per
// 4 pairs against ~11 ALU instructions a pair, and a wider warp box prunes
// fewer groups.
//
// Measured on an NVIDIA H100 80GB HBM3 (700.00 W) at the main-path shape (26
// slots x 131072 queries of registered frames, tools/kernel_shapes.py and
// chip_smoke.py phase 11): 1.12-1.14 ms a launch against the brute-force
// scan's 2.17-2.21, 41.6 % of the bands' 5.04e9 pairs evaluated.  A query's
// own bound excludes 78-90 % of its band's groups, but a warp scans every
// group one of its 32 lanes needs.  Before the warp-box exclusion, this order took 1.32 ms and
// ascending row order 1.69 ms (58 % of the pairs); with it, groups of 16 rows
// took 1.13 ms (30 %) and windows of 4096 rows 1.14 ms.
//
// Bit-equality with the plain PyTorch version: the sum is written with
// __fmul_rn / __fadd_rn in the order (dx*dx + dy*dy) + dz*dz.  nvcc would
// otherwise contract a*a + b into one FMA, which rounds once where the plain
// version rounds twice; the last bit of d2 then differs and can flip a match at
// exactly 0.1 m, or a tie.
//
// Statistics (only when their pointers are not null; the main path passes
// null): the pairs the warps evaluated, added per block with one integer
// atomic, and per (slot, query) the number of groups its own lane could not
// exclude.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 256;  // queries per block, one per thread
constexpr int kTN = 1024;   // table rows per band block
constexpr int kGroup = 32;  // rows per box
constexpr int kWindow = 2048;  // rows staged in shared memory at once
constexpr int kWindowGroups = kWindow / kGroup;
constexpr int kWords = kWindowGroups / 32;  // 32-bit masks of a window's groups
constexpr int kSmemBytes = 3 * kWindow * 4 + 2 * kWindowGroups * 16;  // the window rows and group boxes
static_assert(kGroup % 4 == 0 && kGroup / 4 <= 32 && kWindow % kTN == 0 && kWords >= 1, "group and window sizes");
static_assert(kSmemBytes <= 48 * 1024, "dynamic shared memory above 48 KB needs cudaFuncSetAttribute");
constexpr int kBuckets = 5;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bucket_edge(int b) {
  // squared distances from the warp's query box; the last bucket takes the rest
  return b == 0 ? 0.01f : b == 1 ? 0.04f : b == 2 ? 0.16f : b == 3 ? 0.64f : CUDART_INF_F;
}

__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  // no FMA contraction: each product and each sum is rounded on its own
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ float axis_gap(float q, float lo, float hi) {
  return q < lo ? __fsub_rn(lo, q) : (q > hi ? __fsub_rn(q, hi) : 0.0f);
}

// The largest float below b >= 0 (b = +inf gives FLT_MAX); -1 when b == 0,
// since no squared distance is below 0.
__device__ __forceinline__ float below(float b) {
  return b > 0.0f ? __int_as_float(__float_as_int(b) - 1) : -1.0f;
}

__device__ __forceinline__ void visit(float tx, float ty, float tz, float qx, float qy, float qz,
                                      int row, float& thr, int& best_row) {
  const float d2 = dist2(tx - qx, ty - qy, tz - qz);
  if (d2 <= thr) {
    thr = d2;
    best_row = row;
  }
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ void box_of_lanes(float& lo, float& hi) {
#pragma unroll
  for (int o = 1; o < kGroup / 4; o <<= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
  }
}

__global__ void __launch_bounds__(kTile, 2)
nn_band_kernel(const float* __restrict__ tbl, const float* __restrict__ q,
               const int* __restrict__ blo, const int* __restrict__ nb,
               float* __restrict__ out_d2, int* __restrict__ out_row, int cap, int p, int tiles,
               unsigned long long* __restrict__ pairs, int* __restrict__ needed) {
  extern __shared__ float4 smem[];  // kSmemBytes: the window's x, y, z rows, then the group boxes
  float* sx = reinterpret_cast<float*>(smem);
  float* sy = sx + kWindow;
  float* sz = sy + kWindow;
  float4* box_lo = smem + 3 * kWindow / 4;
  float4* box_hi = box_lo + kWindowGroups;
  __shared__ unsigned int block_groups;

  const int t = blockIdx.x;
  const int s = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int j = t * kTile + threadIdx.x;
  const float qx = q[j];
  const float qy = q[p + j];
  const float qz = q[2 * p + j];

  // the warp's query box: it orders the groups, and it excludes a group for
  // every lane at once (its bound below never exceeds a lane's own)
  const float wlx = warp_min(qx), wly = warp_min(qy), wlz = warp_min(qz);
  const float whx = warp_max(qx), why = warp_max(qy), whz = warp_max(qz);

  // the band, clamped to the table so that no input can read outside it
  const int nblk = cap / kTN;
  int b0 = blo[s * tiles + t];
  int n = nb[s * tiles + t];
  b0 = max(0, min(b0, nblk));
  n = max(0, min(n, nblk - b0));

  const float* tx = tbl + (size_t)s * 3 * cap;
  const float* ty = tx + cap;
  const float* tz = ty + cap;

  if (threadIdx.x == 0) block_groups = 0;
  __syncthreads();
  float best = CUDART_INF_F;
  int best_row = -1;  // none yet; an empty band answers row 0
  int need_count = 0;
  unsigned int visited = 0;  // groups this warp scanned
  for (int c0 = 0; c0 < n; c0 += kWindow / kTN) {
    const int chunks = min(kWindow / kTN, n - c0);
    const int row0 = (b0 + c0) * kTN;
    __syncthreads();  // the previous window has been read by every warp
    for (int c = 0; c < chunks; ++c) {
      const int r = c * kTN + 4 * threadIdx.x;
      const float4 x4 = reinterpret_cast<const float4*>(tx + row0)[r >> 2];
      const float4 y4 = reinterpret_cast<const float4*>(ty + row0)[r >> 2];
      const float4 z4 = reinterpret_cast<const float4*>(tz + row0)[r >> 2];
      reinterpret_cast<float4*>(sx)[r >> 2] = x4;
      reinterpret_cast<float4*>(sy)[r >> 2] = y4;
      reinterpret_cast<float4*>(sz)[r >> 2] = z4;
      // the box of this thread's 4 rows, then of the group's kGroup / 4 lanes
      float lx = fminf(fminf(x4.x, x4.y), fminf(x4.z, x4.w)), hx = fmaxf(fmaxf(x4.x, x4.y), fmaxf(x4.z, x4.w));
      float ly = fminf(fminf(y4.x, y4.y), fminf(y4.z, y4.w)), hy = fmaxf(fmaxf(y4.x, y4.y), fmaxf(y4.z, y4.w));
      float lz = fminf(fminf(z4.x, z4.y), fminf(z4.z, z4.w)), hz = fmaxf(fmaxf(z4.x, z4.y), fmaxf(z4.z, z4.w));
      box_of_lanes(lx, hx);
      box_of_lanes(ly, hy);
      box_of_lanes(lz, hz);
      if ((lane & (kGroup / 4 - 1)) == 0) {
        box_lo[r / kGroup] = make_float4(lx, ly, lz, 0.0f);
        box_hi[r / kGroup] = make_float4(hx, hy, hz, 0.0f);
      }
    }
    __syncthreads();
    const int groups = chunks * (kTN / kGroup);

    // each lane takes groups lane, lane + 32, ...: their bound against the
    // warp's query box and their bucket (an order only: any estimate would do)
    float lbw[kWords];
    int bucket[kWords];
#pragma unroll
    for (int h = 0; h < kWords; ++h) {
      const int g = lane + 32 * h;
      lbw[h] = CUDART_INF_F;
      bucket[h] = -1;
      if (g < groups) {
        const float4 lo = box_lo[g], hi = box_hi[g];
        const float gx = fmaxf(fmaxf(lo.x - whx, wlx - hi.x), 0.0f);
        const float gy = fmaxf(fmaxf(lo.y - why, wly - hi.y), 0.0f);
        const float gz = fmaxf(fmaxf(lo.z - whz, wlz - hi.z), 0.0f);
        lbw[h] = dist2(gx, gy, gz);
        int b = kBuckets - 1;
        for (int e = kBuckets - 2; e >= 0; --e) b = lbw[h] <= bucket_edge(e) ? e : b;
        bucket[h] = b;
      }
    }
    for (int b = 0; b < kBuckets; ++b) {
      const float worst = warp_max(best);  // a group whose warp bound exceeds it is excluded for every lane
#pragma unroll
      for (int h = 0; h < kWords; ++h) {
        unsigned mask = __ballot_sync(kFull, bucket[h] == b && !(lbw[h] > worst));
        while (mask) {  // warp-uniform
          const int g = 32 * h + __ffs(mask) - 1;
          mask &= mask - 1;
          const float4 lo = box_lo[g], hi = box_hi[g];
          const float lb = dist2(axis_gap(qx, lo.x, hi.x), axis_gap(qy, lo.y, hi.y), axis_gap(qz, lo.z, hi.z));
          const bool need = !(lb > best);
          need_count += need;
          if (!__any_sync(kFull, need)) continue;
          ++visited;
          const int base = row0 + g * kGroup;
          float thr = best_row > base ? best : below(best);
          const int before = best_row;
          const float* gx = sx + g * kGroup;
          const float* gy = sy + g * kGroup;
          const float* gz = sz + g * kGroup;
#pragma unroll
          for (int k = kGroup - 4; k >= 0; k -= 4) {
            const float4 x4 = *reinterpret_cast<const float4*>(gx + k);
            const float4 y4 = *reinterpret_cast<const float4*>(gy + k);
            const float4 z4 = *reinterpret_cast<const float4*>(gz + k);
            visit(x4.w, y4.w, z4.w, qx, qy, qz, base + k + 3, thr, best_row);
            visit(x4.z, y4.z, z4.z, qx, qy, qz, base + k + 2, thr, best_row);
            visit(x4.y, y4.y, z4.y, qx, qy, qz, base + k + 1, thr, best_row);
            visit(x4.x, y4.x, z4.x, qx, qy, qz, base + k, thr, best_row);
          }
          if (best_row != before) best = thr;
        }
      }
    }
  }
  out_d2[(size_t)s * p + j] = best;
  out_row[(size_t)s * p + j] = max(best_row, 0);
  if (needed != nullptr) needed[(size_t)s * p + j] = need_count;
  if (pairs != nullptr) {
    if (lane == 0) atomicAdd(&block_groups, visited);
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(pairs, (unsigned long long)block_groups * kGroup * 32);
  }
}

}  // namespace

// tbl: f32 [S, 3, cap] (16-byte aligned, cap % 1024 == 0); q: f32 [3, p]
// (p % 256 == 0); blo/nb: int32 [S, p / 256]; out_d2: f32 [S, p]; out_row:
// int32 [S, p]; all contiguous, on the current device.  pairs (one uint64,
// added to) and needed (int32 [S, p]) may be null.  Returns
// cudaGetLastError() after the launch.
extern "C" int lidal_nn_band(const void* tbl, const void* q, const void* blo, const void* nb,
                             void* out_d2, void* out_row, int num_slots, int cap, int p,
                             void* pairs, void* needed, void* stream) {
  if (num_slots == 0 || p == 0) return (int)cudaSuccess;
  if (num_slots < 0 || num_slots > 65535 || cap < 0 || cap % kTN != 0 || p < 0 || p % kTile != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = p / kTile;
  const dim3 grid((unsigned)tiles, (unsigned)num_slots);
  nn_band_kernel<<<grid, kTile, kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)tbl, (const float*)q, (const int*)blo, (const int*)nb, (float*)out_d2,
      (int*)out_row, cap, p, tiles, (unsigned long long*)pairs, (int*)needed);
  return (int)cudaGetLastError();
}
