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
// rows directly, in f32.
//
// What bounds both on an H100: bytes.  gather8 does 2 operations for every 4
// bytes it reads; the trilinear call at B = 4 writes 537 MB and reads an 8 MB
// table that stays in the 50 MB L2.  Measured by chip_smoke.py on an NVIDIA
// H100 80GB HBM3 (700.00 W) with a map that has no sentinel: gather8 0.30 ms
// against a bound of 0.17 ms (m = 524288, n = 8192, c = 256); scatter8 1.9 ms
// after 0.39 ms for the transposed map against a bound of 0.22 ms (m = 655360,
// n = 10240, c = 256, 512 pairs a target).
//
// gather8: one warp per output row.  Lanes 0-7 read the row's 8 indices and
// weights once and share them by shuffle; each lane then owns 16-byte column
// slices (float4, neighbouring lanes on neighbouring addresses), loads its
// slice of the 8 source rows (a sentinel tap loads nothing and counts as a
// zero row) and sums over k in ascending order.  Every product and every sum
// is rounded on its own (__fmul_rn / __fadd_rn, no FMA contraction), which is
// the arithmetic of the plain PyTorch version, so the two are bit-equal.
//
// scatter8: deterministic, no atomics.  The wrapper sorts the real (row, tap)
// pairs by target once (a stable integer sort, so pairs of one target stay in
// ascending i * 8 + k order) and hands the kernel the order and the CSR
// offsets.  One block per target row: its 256 threads form `groups` groups of
// c / 4 lanes, group g takes the pairs g, g + groups, ... of the segment and
// sums them in blocks of kBlockSum pairs (a block's sum is added to the
// group's total, so no single register carries a sum of thousands of terms);
// the groups' totals meet in shared memory and are added in group order.  The
// order of every sum depends on the map alone, so one input gives the same
// bits on every run.  A dy row is read once per real tap (up to 8 times the
// bound's bytes): the simple form; reading each row once and keeping the 8
// targets' partial sums on chip is what a faster kernel would do.

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 8;
constexpr int kWarpsPerBlock = 8;
constexpr int kScatterThreads = 256;
constexpr int kBlockSum = 16;

__device__ __forceinline__ void axpy_rn(float4& acc, float w, const float4& v) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, v.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, v.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, v.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w, v.w));
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather8_kernel(const float4* __restrict__ feats, const int* __restrict__ nbr,
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
      v[k] = (j >= 0 && j < n) ? __ldg(feats + (size_t)j * c4 + col) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kTaps; ++k) axpy_rn(acc, ws[k], v[k]);
    o[col] = acc;
  }
}

__global__ void __launch_bounds__(kScatterThreads)
scatter8_kernel(const float4* __restrict__ dy, const float* __restrict__ w8,
                const int* __restrict__ order, const int* __restrict__ offsets,
                float4* __restrict__ out, int c4, int groups) {
  __shared__ float4 part[kScatterThreads];
  const int t = blockIdx.x;
  const int g = threadIdx.x / c4;
  const int col = threadIdx.x - g * c4;
  const int begin = offsets[t];
  const int end = offsets[t + 1];
  if (g < groups) {
    float4 total = make_float4(0.f, 0.f, 0.f, 0.f);
    int p = begin + g;
    while (p < end) {
      float4 blk = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int s = 0; s < kBlockSum && p < end; ++s, p += groups) {
        const int pair = order[p];  // i * 8 + k
        const float w = w8[pair];
        const float4 v = __ldg(dy + (size_t)(pair >> 3) * c4 + col);
        blk.x += w * v.x;
        blk.y += w * v.y;
        blk.z += w * v.z;
        blk.w += w * v.w;
      }
      total.x += blk.x;
      total.y += blk.y;
      total.z += blk.z;
      total.w += blk.w;
    }
    part[g * c4 + col] = total;
  }
  __syncthreads();
  if (g == 0) {
    float4 s = part[col];
    for (int gg = 1; gg < groups; ++gg) {
      const float4 q = part[gg * c4 + col];
      s.x += q.x;
      s.y += q.y;
      s.z += q.z;
      s.w += q.w;
    }
    out[(size_t)t * c4 + col] = s;
  }
}

}  // namespace

// feats: f32 [n, c]; nbr: int32 [m, 8]; w8: f32 [m, 8]; out: f32 [m, c]; all
// contiguous on the current device, feats and out 16-byte aligned, c % 4 == 0.
// Returns cudaGetLastError() after the launch.
extern "C" int lidal_gather8(const void* feats, const void* nbr, const void* w8, void* out,
                             int m, int n, int c, void* stream) {
  if (m == 0 || c == 0) return (int)cudaSuccess;
  if (m < 0 || n < 0 || c < 0 || c % 4 != 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((m + kWarpsPerBlock - 1) / kWarpsPerBlock);
  gather8_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const float4*)feats, (const int*)nbr, (const float*)w8, (float4*)out, m, n, c / 4);
  return (int)cudaGetLastError();
}

// dy: f32 [m, c]; w8: f32 [m, 8]; order: int32 [m * 8], the (row, tap) pairs
// i * 8 + k sorted by target (stable), real pairs first; offsets: int32
// [n + 1], target t owns order[offsets[t] : offsets[t + 1]]; out: f32 [n, c];
// all contiguous on the current device, dy and out 16-byte aligned, c % 4 == 0
// and c <= 1024.  Returns cudaGetLastError() after the launch.
extern "C" int lidal_scatter8(const void* dy, const void* w8, const void* order,
                              const void* offsets, void* out, int n, int c, void* stream) {
  if (n == 0 || c == 0) return (int)cudaSuccess;
  if (n < 0 || c < 0 || c % 4 != 0 || c / 4 > kScatterThreads) return (int)cudaErrorInvalidValue;
  const int c4 = c / 4;
  scatter8_kernel<<<(unsigned)n, kScatterThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)dy, (const float*)w8, (const int*)order, (const int*)offsets, (float4*)out,
      c4, kScatterThreads / c4);
  return (int)cudaGetLastError();
}
