// Gather-GEMM tile kernel shared by subm_conv.cu (the forward convs) and
// conv_dx_dw.cu (the input gradient of the backward).
//
//   out[i] = sum_k feats[nbr[i, k]] @ w[k]          (f32; nbr >= n gives 0)
//
// and, with the epilogue EPI > 0, y = acc * scale + shift, then relu if
// EPI == 2, then 0 on rows whose taps are all sentinel.
//
// f32 accuracy on the tensor cores: split TF32 ("3xTF32", tf32_mma.cuh), three
// tf32 mma.sync.m16n8k8 products per f32 product.  The feature and weight
// values are split in registers as their fragments are loaded.
//
// A block of 8 warps owns a BM-row x BN-column output tile: all of cout up to
// 128 columns (cout = 256 and 384 take 2 and 3 column tiles), so each (row,
// tap) of the map is gathered once per column tile.  The block lists the taps
// that name a real row somewhere in the tile (the others are skipped) and
// walks the flattened reduction (active tap, input channel) in stages of KS
// columns: KS = 64 when cin % 64 == 0 (and the tile fits twice in an SM's
// shared memory), else 32; at the stem's cin = 4 a stage spans 8 taps.  Each
// stage's 16-byte pieces go straight to shared memory with cp.async (zero-fill
// for the sentinel and past the end), the gathered rows as A[BM][KS] and the
// weight rows as B[KS][BN], rows padded so that fragment loads hit 32 distinct
// banks.  Two stage buffers: stage s + 1 loads while stage s multiplies, one
// barrier per stage; shared memory and registers are sized for two blocks an
// SM.
//
// Each stage's products are summed apart and join the total with one rounded
// f32 add (a blocked sum: the tensor cores truncate when they add into a large
// accumulator).  The output tile goes through shared memory so that the
// epilogue and the stores run on float4 rows.  No atomics and one fixed order
// of sums: the same input gives bit-equal output on every run.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "tf32_mma.cuh"

namespace gather_gemm {

using namespace cp_async_util;
using namespace tf32_mma;

constexpr int kThreads = 256;  // 8 warps
constexpr int kKMax = 27;      // taps held in shared memory per row
constexpr int kSmemTwoBlocks = 113 * 1024;  // shared memory of a block when two share an SM

// 8 warps, each owning 32 rows x BN / WN columns of the BM x BN tile.
template <int BN, int KS>
struct Tile {
  static constexpr int BM = BN >= 96 ? 64 : 128;  // rows per block
  static constexpr int WM = BM / 32;              // warps across the rows
  static constexpr int WN = 8 / WM;               // warps across the columns
  static constexpr int NT = BN / WN / 8;          // 8-column mma tiles per warp
  static constexpr int AS = KS + 4;               // A row stride: (4 g + t) % 32 distinct
  static constexpr int BS = BN + 8;               // B row stride: (8 t + g) % 32 distinct
  static constexpr int OS = BN + 4;               // output tile row stride
  static constexpr int STAGE = BM * AS + KS * BS;  // floats per stage buffer
  static constexpr int HEADER = (BM * kKMax + BM + 32) * 4;  // s_nbr, s_row, s_act (bytes)
  static constexpr int SMEM = HEADER + 2 * STAGE * 4;  // two stage buffers
  static_assert(BN % (8 * WN) == 0 && BM * OS <= 2 * STAGE && HEADER % 16 == 0, "tile shape");
};

template <int BN, int KS, int EPI>  // EPI: 0 none, 1 affine, 2 affine + relu
__global__ void __launch_bounds__(kThreads, 2)
kernel(const float* __restrict__ feats, const float* __restrict__ w, const int* __restrict__ nbr,
       const float* __restrict__ scale, const float* __restrict__ shift, float* __restrict__ out,
       int m, int n, int k, int cin, int cout) {
  using T = Tile<BN, KS>;
  constexpr int BM = T::BM;
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_nbr = reinterpret_cast<int*>(smem);  // source row per (row, tap), -1 for the sentinel
  int* s_row = s_nbr + BM * kKMax;            // row has a real tap
  int* s_act = s_row + BM;                    // active taps in order; [kKMax] = how many
  float* stages = reinterpret_cast<float*>(smem + T::HEADER);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp % T::WM;
  const int wn = warp / T::WM;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  if (tid < 32) s_act[tid] = 0;
  for (int r = tid; r < BM; r += kThreads) s_row[r] = 0;
  __syncthreads();
  for (int e = tid; e < BM * k; e += kThreads) {
    const int r = e / k;
    const int v = row0 + r < m ? nbr[(long long)row0 * k + e] : n;
    const bool real = (unsigned)v < (unsigned)n;
    s_nbr[e] = real ? v : -1;
    if (real) {
      s_act[e - r * k] = 1;
      s_row[r] = 1;
    }
  }
  __syncthreads();
  if (tid == 0) {  // the flags become the list of active taps, in tap order
    int count = 0;
    for (int t = 0; t < k; ++t)
      if (s_act[t]) s_act[count++] = t;
    s_act[kKMax] = count;
  }
  __syncthreads();
  const int depth = s_act[kKMax] * cin;  // flattened reduction length over the active taps
  const int nstages = (depth + KS - 1) / KS;

  // Stage `s` into buffer `buf`: A[r][c] = feats[src(r, tap)][ch], B[c][j] =
  // w[tap][ch][col0 + j] for the reduction columns c of the stage.
  auto stage_in = [&](int s, int buf) {
    float* sa = stages + buf * T::STAGE;
    float* sb = sa + BM * T::AS;
    {
      constexpr int PA = KS / 4;  // 16-byte pieces per gathered row
      const int p = tid % PA;
      const int kk = s * KS + p * 4;
      const bool live = kk < depth;
      const int j = live ? kk / cin : 0;
      const float* base = feats + (kk - j * cin);
      const int* srcs = s_nbr + s_act[j];
      for (int r = tid / PA; r < BM; r += kThreads / PA) {
        const int src = srcs[r * k];
        const bool real = live && src >= 0;
        cp_async16(sa + r * T::AS + p * 4, real ? base + (long long)src * cin : feats, real);
      }
    }
    constexpr int PB = BN / 4;         // 16-byte pieces per weight row
    constexpr int RB = kThreads / PB;  // weight rows per pass
    if (tid < RB * PB) {
      const int q = tid % PB;
      int c = tid / PB;
      int kk = s * KS + c;
      int j = kk / cin;  // the (active tap, channel) of row c, carried from pass to pass
      int ch = kk - j * cin;
      for (; c < KS; c += RB, kk += RB) {
        const bool live = kk < depth;
        const float* src = w + ((long long)s_act[live ? j : 0] * cin + ch) * cout + col0 + q * 4;
        cp_async16(sb + c * T::BS + q * 4, live ? src : w, live);
        for (ch += RB; ch >= cin; ch -= cin) ++j;
      }
    }
    cp_async_commit();
  };

  float acc[2][T::NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < T::NT; ++t)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][t][v] = 0.f;

  if (nstages > 0) stage_in(0, 0);
  for (int s = 0; s < nstages; ++s) {
    const int buf = s & 1;
    cp_async_wait<0>();
    __syncthreads();  // stage s has landed, and every warp is done with stage s - 1
    if (s + 1 < nstages) stage_in(s + 1, buf ^ 1);
    const float* sa = stages + buf * T::STAGE + (wm * 32 + gid) * T::AS + tig;
    const float* sb = stages + buf * T::STAGE + BM * T::AS + tig * T::BS + wn * (BN / T::WN) + gid;
    float part[2][T::NT][4];  // this stage's sum, joining acc after it
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < T::NT; ++t)
#pragma unroll
        for (int v = 0; v < 4; ++v) part[i][t][v] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < KS; k0 += 8) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* a = sa + i * 16 * T::AS + k0;
        split_tf32(a[0], ab[i][0], as[i][0]);
        split_tf32(a[8 * T::AS], ab[i][1], as[i][1]);
        split_tf32(a[4], ab[i][2], as[i][2]);
        split_tf32(a[8 * T::AS + 4], ab[i][3], as[i][3]);
      }
#pragma unroll
      for (int t = 0; t < T::NT; ++t) {
        const float* b = sb + k0 * T::BS + t * 8;
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(b[0], bb0, bs0);
        split_tf32(b[4 * T::BS], bb1, bs1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // the small products first, then the big one
          mma_tf32(part[i][t], as[i], bb0, bb1);
          mma_tf32(part[i][t], ab[i], bs0, bs1);
          mma_tf32(part[i][t], ab[i], bb0, bb1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < T::NT; ++t)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][t][v] += part[i][t][v];
  }

  // the output tile through shared memory (the stage buffers are free now)
  __syncthreads();
  float* so = stages;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < T::NT; ++t) {
      const int r = wm * 32 + i * 16 + gid;
      const int c = wn * (BN / T::WN) + t * 8 + 2 * tig;
      *reinterpret_cast<float2*>(so + r * T::OS + c) = make_float2(acc[i][t][0], acc[i][t][1]);
      *reinterpret_cast<float2*>(so + (r + 8) * T::OS + c) = make_float2(acc[i][t][2], acc[i][t][3]);
    }
  __syncthreads();
  constexpr int PR = BN / 4;
  for (int e = tid; e < BM * PR; e += kThreads) {
    const int r = e / PR;
    const int c = (e - r * PR) * 4;
    if (row0 + r >= m) continue;
    float4 y = *reinterpret_cast<const float4*>(so + r * T::OS + c);
    if (EPI > 0) {
      const float* sc = scale + col0 + c;
      const float* sh = shift + col0 + c;
      y = make_float4(y.x * sc[0] + sh[0], y.y * sc[1] + sh[1], y.z * sc[2] + sh[2], y.w * sc[3] + sh[3]);
      if (EPI == 2) y = make_float4(fmaxf(y.x, 0.f), fmaxf(y.y, 0.f), fmaxf(y.z, 0.f), fmaxf(y.w, 0.f));
      if (!s_row[r]) y = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    *reinterpret_cast<float4*>(out + (long long)(row0 + r) * cout + col0 + c) = y;
  }
}

template <int BN, int KS, int EPI>
cudaError_t launch_tile(const float* feats, const float* w, const int* nbr, const float* scale,
                        const float* shift, float* out, int m, int n, int k, int cin, int cout,
                        cudaStream_t stream) {
  using T = Tile<BN, KS>;
  static_assert(T::SMEM <= kSmemTwoBlocks, "two blocks an SM");
  auto kern = kernel<BN, KS, EPI>;
  // more than 48 KB of shared memory is dynamic and has to be asked for
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + T::BM - 1) / T::BM, cout / BN);
  kern<<<grid, kThreads, T::SMEM, stream>>>(feats, w, nbr, scale, shift, out, m, n, k, cin, cout);
  return cudaGetLastError();
}

template <int BN, int EPI>
cudaError_t launch_cols(const float* feats, const float* w, const int* nbr, const float* scale,
                        const float* shift, float* out, int m, int n, int k, int cin, int cout,
                        cudaStream_t stream) {
  if constexpr (Tile<BN, 64>::SMEM <= kSmemTwoBlocks) {
    if (cin % 64 == 0) return launch_tile<BN, 64, EPI>(feats, w, nbr, scale, shift, out, m, n, k, cin, cout, stream);
  }
  return launch_tile<BN, 32, EPI>(feats, w, nbr, scale, shift, out, m, n, k, cin, cout, stream);
}

// The widest column tile that divides cout (128, 96, 64 or 32), and stages of
// 64 reduction columns when cin % 64 == 0 and two such blocks fit an SM (not
// at BN = 64, whose tile has 128 rows), else 32.
template <int EPI>
cudaError_t launch(const float* feats, const float* w, const int* nbr, const float* scale,
                   const float* shift, float* out, int m, int n, int k, int cin, int cout,
                   cudaStream_t stream) {
  if (cout % 128 == 0) return launch_cols<128, EPI>(feats, w, nbr, scale, shift, out, m, n, k, cin, cout, stream);
  if (cout % 96 == 0) return launch_cols<96, EPI>(feats, w, nbr, scale, shift, out, m, n, k, cin, cout, stream);
  if (cout % 64 == 0) return launch_cols<64, EPI>(feats, w, nbr, scale, shift, out, m, n, k, cin, cout, stream);
  return launch_cols<32, EPI>(feats, w, nbr, scale, shift, out, m, n, k, cin, cout, stream);
}

// True when the kernel takes these sizes: k <= 27, cin % 4 == 0, cout % 32 == 0.
inline bool shapes_ok(int m, int n, int k, int cin, int cout) {
  return m >= 0 && n >= 0 && k > 0 && k <= kKMax && cin > 0 && cin % 4 == 0 && cout > 0 &&
         cout % 32 == 0;
}

}  // namespace gather_gemm
