// Both products of the sparse-conv backward, deterministic and without atomics.
//
// Replaces lidal_tpu/ops/pallas_conv.py:conv_dx_dw_pallas.  For a map nbr
// [m, K] into src [n, c_src] (sentinel: any index >= n) it computes
//
//   dx[i]  = sum_k src[nbr[i, k]] @ w2[k]          -> [m, c_dst]       f32
//   dwg[k] = sum_i f[i]^T src[nbr[i, k]]           -> [K, c_f, c_src]  f32
//
// and ops/conv.py turns dwg into dW through each map's mirror or pairing
// identity.  The TPU kernel pays its one-hot "gather" once for both products,
// in a banded pass whose sequential grid revisits one whole-dW accumulator in
// VMEM.  None of that carries over: CUDA blocks run in no order, and no block
// may carry a sum to another.  So the two products are separate kernels here
// (the fused single-gather design is left to the PR that makes this fast):
//
// * dx is the forward's gather-GEMM with no epilogue: the tile kernel of
//   gather_gemm.cuh, which subm_conv.cu launches too.
// * dwg is a reduction over all m rows (655k at level 0 of a B = 5 batch).
//   The rows are split into S fixed chunks of at most 4096 rows.  A block
//   owns one (chunk, c_f tile, c_src tile, tap); it walks its chunk in
//   order, 32 rows a step, gathers src[nbr[i, k]] for the tile's columns and
//   the f rows beside them into shared memory, and accumulates
//   f_tile^T . gathered in 4x4 register tiles, each step's sum apart before
//   it joins the chunk's (a blocked sum: a single running register over
//   tens of thousands of same-signed terms was measured 14-110x further
//   from an f64 reference than cuBLAS).  Narrow tiles (c_f = 4 at the
//   stem) split the rows of a step over several thread groups, summed at
//   the end in a fixed order.
//   A step whose 32 rows are all sentinel for this tap is skipped, and a
//   sentinel row loads neither operand.  Each block writes its partial to
//   a workspace [S, K, c_f, c_src]; a second kernel sums the S partials in
//   order.  The same input therefore gives bit-equal dwg on every run.
//
// The map arrives twice: [m, K] for dx and transposed [K, m] for dwg, so a
// dwg block reads its tap's column coalesced.  No column is assumed sorted
// (the up map's parents are not monotonic).
//
// What bounds it on an H100: like the forward, f32 FFMA throughput and shared-
// memory traffic for the wide tiles; for the stem's c_f = 4 the gathered
// src rows (device-memory bandwidth).  wgmma with bf16 operands, TMA
// gathers and gathering each row once for both products are later work.

#include "gather_gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // rows staged per step

// partial[s][tap][a0 + a][b0 + b] = sum over the rows i of chunk s of
// f[i, a0 + a] * src[nbr_t[tap, i], b0 + b]
template <int BF, int BS>
__global__ void __launch_bounds__(kThreads)
dwg_partial_kernel(const float* __restrict__ src, const int* __restrict__ nbr_t,
                   const float* __restrict__ f, float* __restrict__ part, int m, int n, int k,
                   int c_src, int c_f, int rows_per_chunk) {
  constexpr int TB = BS / 4;            // thread tiles across the c_src tile
  constexpr int TILES = (BF / 4) * TB;  // 4x4 thread tiles in the block tile
  constexpr int RG = kThreads / TILES;  // row groups sharing a step
  static_assert(kThreads % TILES == 0 && kRows % RG == 0, "tile shape");

  __shared__ int s_idx[kRows];
  __shared__ __align__(16) float s_f[kRows * BF];
  __shared__ __align__(16) float s_g[kRows * BS];
  __shared__ __align__(16) float s_red[RG > 1 ? kThreads * 16 : 1];

  const int tid = threadIdx.x;
  const int tile = tid % TILES;
  const int grp = tid / TILES;
  const int ta = tile / TB;
  const int tb = tile % TB;
  const int tiles_b = c_src / BS;
  const int a0 = (blockIdx.y / tiles_b) * BF;
  const int b0 = (blockIdx.y % tiles_b) * BS;
  const int tap = blockIdx.z;
  const int r_begin = blockIdx.x * rows_per_chunk;
  const int r_end = min(m, r_begin + rows_per_chunk);
  const int* col = nbr_t + (long long)tap * m;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kRows) {
    bool real = false;
    if (tid < kRows) {
      const int i = r0 + tid;
      const int v = i < r_end ? col[i] : n;
      real = (unsigned)v < (unsigned)n;
      s_idx[tid] = real ? v : -1;
    }
    if (!__syncthreads_or(real)) continue;  // uniform: no real source in this step
    for (int e = tid; e < kRows * BF / 4; e += kThreads) {
      const int r = e / (BF / 4);
      const int c = (e % (BF / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s_idx[r] >= 0) v = *reinterpret_cast<const float4*>(f + (long long)(r0 + r) * c_f + a0 + c);
      *reinterpret_cast<float4*>(&s_f[r * BF + c]) = v;
    }
    for (int e = tid; e < kRows * BS / 4; e += kThreads) {
      const int r = e / TB;
      const int c = (e % TB) * 4;
      const int j = s_idx[r];
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j >= 0) v = *reinterpret_cast<const float4*>(src + (long long)j * c_src + b0 + c);
      *reinterpret_cast<float4*>(&s_g[r * BS + c]) = v;
    }
    __syncthreads();
    // the step's rows sum on their own, then join the chunk's total: a long
    // run of same-signed terms into one register would lose precision
    float step[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) step[i][j] = 0.f;
#pragma unroll
    for (int rr = grp; rr < kRows; rr += RG) {
      const float4 a = *reinterpret_cast<const float4*>(&s_f[rr * BF + ta * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&s_g[rr * BS + tb * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) step[i][j] = fmaf(av[i], bv[j], step[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += step[i][j];
  }

  float* out = part + ((long long)blockIdx.x * k + tap) * c_f * c_src;
  if (RG == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(out + (long long)(a0 + ta * 4 + i) * c_src + b0 + tb * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    return;
  }
  // sum the row groups' tiles in a fixed order
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s_red[(grp * TILES + tile) * 16 + i * 4 + j] = acc[i][j];
  __syncthreads();
  for (int e = tid; e < BF * BS; e += kThreads) {
    const int a = e / BS;
    const int b = e % BS;
    const int slot = ((a / 4) * TB + b / 4) * 16 + (a % 4) * 4 + b % 4;
    float sum = 0.f;
    for (int g = 0; g < RG; ++g) sum += s_red[g * TILES * 16 + slot];
    out[(long long)(a0 + a) * c_src + b0 + b] = sum;
  }
}

// dwg[e] = sum_{s < S} part[s][e], s in order
__global__ void dwg_reduce_kernel(const float4* __restrict__ part, float4* __restrict__ dwg,
                                  long long total4, int chunks) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total4;
       e += (long long)gridDim.x * blockDim.x) {
    float4 acc = part[e];
    for (int s = 1; s < chunks; ++s) {
      const float4 v = part[s * total4 + e];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    dwg[e] = acc;
  }
}

template <int BF, int BS>
cudaError_t launch_partial(const float* src, const int* nbr_t, const float* f, float* part, int m,
                           int n, int k, int c_src, int c_f, int chunks, int rows_per_chunk,
                           cudaStream_t stream) {
  const dim3 grid(chunks, (c_f / BF) * (c_src / BS), k);
  dwg_partial_kernel<BF, BS><<<grid, kThreads, 0, stream>>>(src, nbr_t, f, part, m, n, k, c_src,
                                                            c_f, rows_per_chunk);
  return cudaGetLastError();
}

cudaError_t launch_dwg(const float* src, const int* nbr_t, const float* f, float* dwg, float* ws,
                       int m, int n, int k, int c_src, int c_f, int chunks, int rows_per_chunk,
                       cudaStream_t stream) {
  float* part = chunks == 1 ? dwg : ws;
  const int bf = c_f % 64 == 0 ? 64 : (c_f % 32 == 0 ? 32 : 4);
  const bool bs64 = c_src % 64 == 0;
  cudaError_t err;
  if (bf == 64)
    err = bs64 ? launch_partial<64, 64>(src, nbr_t, f, part, m, n, k, c_src, c_f, chunks, rows_per_chunk, stream)
               : launch_partial<64, 32>(src, nbr_t, f, part, m, n, k, c_src, c_f, chunks, rows_per_chunk, stream);
  else if (bf == 32)
    err = bs64 ? launch_partial<32, 64>(src, nbr_t, f, part, m, n, k, c_src, c_f, chunks, rows_per_chunk, stream)
               : launch_partial<32, 32>(src, nbr_t, f, part, m, n, k, c_src, c_f, chunks, rows_per_chunk, stream);
  else
    err = bs64 ? launch_partial<4, 64>(src, nbr_t, f, part, m, n, k, c_src, c_f, chunks, rows_per_chunk, stream)
               : launch_partial<4, 32>(src, nbr_t, f, part, m, n, k, c_src, c_f, chunks, rows_per_chunk, stream);
  if (err != cudaSuccess || chunks == 1) return err;
  const long long total4 = (long long)k * c_f * c_src / 4;
  const int blocks = (int)((total4 + 255) / 256 < 4096 ? (total4 + 255) / 256 : 4096);
  dwg_reduce_kernel<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(ws),
                                                reinterpret_cast<float4*>(dwg), total4, chunks);
  return cudaGetLastError();
}

}  // namespace

// src [n, c_src], w2 [k, c_src, c_dst], nbr [m, k] and nbr_t [k, m] int32 (the
// same map), f [m, c_f]; outputs dx [m, c_dst] (written only when need_dx) and
// dwg [k, c_f, c_src]; ws [chunks, k, c_f, c_src] (unused when chunks == 1).
// Rows [s * rows_per_chunk, (s + 1) * rows_per_chunk) form chunk s, and
// chunks * rows_per_chunk >= m.  All contiguous on the current device and
// 16-byte aligned.  Needs k <= 27, c_src % 32 == 0, c_f % 4 == 0 and, with
// need_dx, c_dst % 32 == 0.  Returns the first CUDA error of its launches.
extern "C" int lidal_conv_dx_dw(const void* src, const void* w2, const void* nbr,
                                const void* nbr_t, const void* f, void* dx, void* dwg, void* ws,
                                int m, int n, int k, int c_src, int c_dst, int c_f, int chunks,
                                int rows_per_chunk, int need_dx, void* stream) {
  const auto s = (cudaStream_t)stream;
  if (m < 0 || n < 0 || k <= 0 || k > gather_gemm::kKMax || c_src <= 0 || c_src % 32 != 0 ||
      c_f <= 0 || c_f % 4 != 0 || chunks < 1 || rows_per_chunk < 1 ||
      (long long)chunks * rows_per_chunk < m || (need_dx && !gather_gemm::shapes_ok(m, n, k, c_src, c_dst)))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaMemsetAsync(dwg, 0, sizeof(float) * (size_t)k * c_f * c_src, s);
  if (need_dx) {
    const auto* sp = (const float*)src;
    const auto* wp = (const float*)w2;
    const auto* np = (const int*)nbr;
    auto* dp = (float*)dx;
    const cudaError_t err =
        c_dst % 64 == 0
            ? gather_gemm::launch<64, 0>(sp, wp, np, nullptr, nullptr, dp, m, n, k, c_src, c_dst, s)
            : gather_gemm::launch<32, 0>(sp, wp, np, nullptr, nullptr, dp, m, n, k, c_src, c_dst, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_dwg((const float*)src, (const int*)nbr_t, (const float*)f, (float*)dwg,
                         (float*)ws, m, n, k, c_src, c_f, chunks, rows_per_chunk, s);
}
