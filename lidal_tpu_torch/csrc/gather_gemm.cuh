// Gather-GEMM tile kernel shared by subm_conv.cu (the forward convs) and
// conv_dx_dw.cu (the input gradient of the backward).
//
//   out[i] = sum_k feats[nbr[i, k]] @ w[k]          (f32; nbr >= n gives 0)
//
// and, with the epilogue EPI > 0, y = acc * scale + shift, then relu if
// EPI == 2, then 0 on rows whose taps are all sentinel.
//
// Each block owns a BM-row x BN-column output tile.  For every tap it gathers
// the tile's source rows straight from device memory into shared memory, KC
// channels at a time (zeros for the sentinel), stages w[k][chunk, cols] beside
// them, and accumulates a 4x4 f32 register tile per thread with FFMA, each
// tap's sum apart before it joins the total.  A tap whose rows are all
// sentinel inside the tile is skipped.

#pragma once

#include <cuda_runtime.h>

namespace gather_gemm {

constexpr int kThreads = 256;
constexpr int kKC = 16;    // input channels staged per step
constexpr int kKMax = 27;  // taps held in shared memory per row

template <int BN, int EPI>  // EPI: 0 none, 1 affine, 2 affine + relu
__global__ void __launch_bounds__(kThreads)
kernel(const float* __restrict__ feats, const float* __restrict__ w,
       const int* __restrict__ nbr, const float* __restrict__ scale,
       const float* __restrict__ shift, float* __restrict__ out, int m, int n, int k, int cin,
       int cout) {
  constexpr int TN = BN / 4;        // threads across the column tile
  constexpr int TM = kThreads / TN;  // threads across the row tile
  constexpr int BM = TM * 4;        // rows per block
  constexpr int AP = BM + 4;        // padded stride of the transposed A tile

  __shared__ int s_nbr[BM * kKMax];  // source row per (row, tap), -1 for sentinel
  __shared__ int s_tap[kKMax];       // tap has a real source somewhere in the tile
  __shared__ __align__(16) float s_a[kKC * AP];
  __shared__ __align__(16) float s_b[kKC * BN];

  const int tid = threadIdx.x;
  const int tx = tid % TN;
  const int ty = tid / TN;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  if (tid < kKMax) s_tap[tid] = 0;
  __syncthreads();
  for (int e = tid; e < BM * k; e += kThreads) {
    const int r = e / k;
    const int v = row0 + r < m ? nbr[(long long)row0 * k + e] : n;
    const bool real = (unsigned)v < (unsigned)n;
    s_nbr[e] = real ? v : -1;
    if (real) s_tap[e - r * k] = 1;
  }
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < k; ++tap) {
    if (!s_tap[tap]) continue;  // uniform across the block
    const float* wk = w + (long long)tap * cin * cout;
    float part[4][4];  // this tap's sum, joining acc after it: a blocked sum
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
    for (int c0 = 0; c0 < cin; c0 += kKC) {
      // gather BM source rows x kKC channels, stored channel-major
      for (int e = tid; e < BM * kKC / 4; e += kThreads) {
        const int r = e / (kKC / 4);
        const int c = (e % (kKC / 4)) * 4;
        const int src = s_nbr[r * k + tap];
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (src >= 0 && c0 + c < cin)
          v = *reinterpret_cast<const float4*>(feats + (long long)src * cin + c0 + c);
        s_a[(c + 0) * AP + r] = v.x;
        s_a[(c + 1) * AP + r] = v.y;
        s_a[(c + 2) * AP + r] = v.z;
        s_a[(c + 3) * AP + r] = v.w;
      }
      for (int e = tid; e < kKC * BN / 4; e += kThreads) {
        const int c = e / (BN / 4);
        const int j = (e % (BN / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c0 + c < cin)
          v = *reinterpret_cast<const float4*>(wk + (long long)(c0 + c) * cout + col0 + j);
        *reinterpret_cast<float4*>(&s_b[c * BN + j]) = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&s_a[kk * AP + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&s_b[kk * BN + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
  }

  const int col = col0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (row0 + r >= m) continue;
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = acc[i][j];
    if (EPI > 0) {
      bool row_ok = false;
      for (int t = 0; t < k; ++t) row_ok |= s_nbr[r * k + t] >= 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = y[j] * scale[col + j] + shift[col + j];
        if (EPI == 2) v = fmaxf(v, 0.f);
        y[j] = row_ok ? v : 0.f;
      }
    }
    *reinterpret_cast<float4*>(out + (long long)(row0 + r) * cout + col) =
        make_float4(y[0], y[1], y[2], y[3]);
  }
}

template <int BN, int EPI>
cudaError_t launch(const float* feats, const float* w, const int* nbr, const float* scale,
                   const float* shift, float* out, int m, int n, int k, int cin, int cout,
                   cudaStream_t stream) {
  constexpr int BM = (kThreads / (BN / 4)) * 4;
  const dim3 grid((m + BM - 1) / BM, cout / BN);
  kernel<BN, EPI><<<grid, kThreads, 0, stream>>>(feats, w, nbr, scale, shift, out, m, n, k, cin,
                                                 cout);
  return cudaGetLastError();
}

// True when the kernel takes these sizes: k <= 27, cin % 4 == 0, cout % 32 == 0.
inline bool shapes_ok(int m, int n, int k, int cin, int cout) {
  return m >= 0 && n >= 0 && k > 0 && k <= kKMax && cin > 0 && cin % 4 == 0 && cout > 0 &&
         cout % 32 == 0;
}

}  // namespace gather_gemm
