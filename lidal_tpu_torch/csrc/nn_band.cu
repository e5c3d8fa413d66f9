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
// over.  Here one block of 256 threads serves one (query tile, slot): each
// thread keeps one query in registers, the block stages the band into shared
// memory 1024 rows at a time with coalesced 16-byte loads (3 x 4 KB), and every
// thread scans the chunk in ascending row order, updating on strict `<`, which
// yields the lowest row among ties with no second pass.  All threads of a warp
// read the same shared address, so the reads are broadcasts.
//
// What bounds it on an H100: operations.  The table and the queries are read
// once (41 MB + 1.5 MB at 26 slots x 131072 rows) but every query meets every
// row of its band, about 10 f32 operations a pair and thousands of rows a
// query; the bytes would take ~0.02 ms, the pairs take milliseconds.
//
// Bit-equality with the plain PyTorch version: the sum is written with
// __fmul_rn / __fadd_rn in the order (dx*dx + dy*dy) + dz*dz.  nvcc would
// otherwise contract a*a + b into one FMA, which rounds once where the plain
// version rounds twice; the last bit of d2 then differs and can flip a match at
// exactly 0.1 m, or a tie.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 256;  // queries per block, one per thread
constexpr int kTN = 1024;   // table rows per band block

__device__ __forceinline__ void visit(float tx, float ty, float tz, float qx, float qy, float qz,
                                      int row, float& best, int& best_row) {
  const float dx = tx - qx;
  const float dy = ty - qy;
  const float dz = tz - qz;
  // no FMA contraction: each product and each sum is rounded on its own
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  if (d2 < best) {
    best = d2;
    best_row = row;
  }
}

__global__ void __launch_bounds__(kTile)
nn_band_kernel(const float* __restrict__ tbl, const float* __restrict__ q,
               const int* __restrict__ blo, const int* __restrict__ nb,
               float* __restrict__ out_d2, int* __restrict__ out_row, int cap, int p, int tiles) {
  __shared__ __align__(16) float sx[kTN];
  __shared__ __align__(16) float sy[kTN];
  __shared__ __align__(16) float sz[kTN];

  const int t = blockIdx.x;
  const int s = blockIdx.y;
  const int j = t * kTile + threadIdx.x;
  const float qx = q[j];
  const float qy = q[p + j];
  const float qz = q[2 * p + j];

  // the band, clamped to the table so that no input can read outside it
  const int nblk = cap / kTN;
  int b0 = blo[s * tiles + t];
  int n = nb[s * tiles + t];
  b0 = max(0, min(b0, nblk));
  n = max(0, min(n, nblk - b0));

  const float* tx = tbl + (size_t)s * 3 * cap;
  const float* ty = tx + cap;
  const float* tz = ty + cap;

  float best = CUDART_INF_F;
  int best_row = 0;
  for (int b = 0; b < n; ++b) {
    const int row0 = (b0 + b) * kTN;
    __syncthreads();  // the previous chunk has been read by every thread
    reinterpret_cast<float4*>(sx)[threadIdx.x] = reinterpret_cast<const float4*>(tx + row0)[threadIdx.x];
    reinterpret_cast<float4*>(sy)[threadIdx.x] = reinterpret_cast<const float4*>(ty + row0)[threadIdx.x];
    reinterpret_cast<float4*>(sz)[threadIdx.x] = reinterpret_cast<const float4*>(tz + row0)[threadIdx.x];
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kTN; r += 4) {
      const float4 x4 = *reinterpret_cast<const float4*>(sx + r);
      const float4 y4 = *reinterpret_cast<const float4*>(sy + r);
      const float4 z4 = *reinterpret_cast<const float4*>(sz + r);
      visit(x4.x, y4.x, z4.x, qx, qy, qz, row0 + r, best, best_row);
      visit(x4.y, y4.y, z4.y, qx, qy, qz, row0 + r + 1, best, best_row);
      visit(x4.z, y4.z, z4.z, qx, qy, qz, row0 + r + 2, best, best_row);
      visit(x4.w, y4.w, z4.w, qx, qy, qz, row0 + r + 3, best, best_row);
    }
  }
  out_d2[(size_t)s * p + j] = best;
  out_row[(size_t)s * p + j] = best_row;
}

}  // namespace

// tbl: f32 [S, 3, cap] (16-byte aligned, cap % 1024 == 0); q: f32 [3, p]
// (p % 256 == 0); blo/nb: int32 [S, p / 256]; out_d2: f32 [S, p]; out_row:
// int32 [S, p]; all contiguous, on the current device.  Returns
// cudaGetLastError() after the launch.
extern "C" int lidal_nn_band(const void* tbl, const void* q, const void* blo, const void* nb,
                             void* out_d2, void* out_row, int num_slots, int cap, int p,
                             void* stream) {
  if (num_slots == 0 || p == 0) return (int)cudaSuccess;
  if (num_slots < 0 || num_slots > 65535 || cap < 0 || cap % kTN != 0 || p < 0 || p % kTile != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = p / kTile;
  const dim3 grid((unsigned)tiles, (unsigned)num_slots);
  nn_band_kernel<<<grid, kTile, 0, (cudaStream_t)stream>>>(
      (const float*)tbl, (const float*)q, (const int*)blo, (const int*)nb, (float*)out_d2,
      (int*)out_row, cap, p, tiles);
  return (int)cudaGetLastError();
}
