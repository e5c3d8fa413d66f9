// Both products of the sparse-conv backward from ONE gather per (row tile, tap),
// on bf16 operands, deterministic and without atomics.
//
// Replaces tools/probe_dxdw_features.py:launch with its three bodies: kA (dx
// only), kB (dx, and a second output dw that is all zeros) and kC (dx and dw).
// For a map nbr [m, K] into src [n, c_src] (sentinel: any index outside [0, n))
//
//   dx[i] = sum_k src[nbr[i, k]] @ w2[k]          -> [m, c_dst]       f32
//   dw[k] = sum_i f[i]^T src[nbr[i, k]]           -> [K, c_f, c_src]  f32
//
// with src, w2 and f rounded to bf16 and f32 sums.  conv_dx_dw.cu computes the
// same two products in f32 with two kernels that each gather for themselves;
// this is the design the TPU probe tried out, the gather paid once.
//
// The two products want opposite loops: dx sums over the taps of one row, dw
// sums one [c_f, c_src] matrix per tap over all rows.  On the TPU the grid
// runs in order and one dw accumulator in VMEM is revisited by every tile;
// CUDA blocks run in no order and carry nothing over.  What was chosen:
//
// * The rows are split into S fixed chunks (at most 4096 rows, a multiple of
//   64).  A block owns (chunk, 32-column slice j): columns [32 j, 32 j + 32) of
//   dx and rows [32 j, 32 j + 32) of every dw[k].  It walks the taps OUTSIDE
//   and the chunk's 64-row tiles INSIDE, so its [32, c_src] slice of dw[k] stays
//   in registers (c_src <= 256: 32 f32 a thread) for the whole chunk and is
//   written once, to a workspace [S, K, c_f, c_src]; a second kernel sums the S
//   partials in order.  The same input gives bit-equal dw on every run.
// * dx is what gets spilled: after each (tile, tap) the block adds the tap's
//   [64, 32] product into its own rows and columns of dx in device memory (dx
//   arrives zero-filled; no other block touches those elements, so plain loads
//   and stores, in tap order).  A (tile, tap) with no real row is skipped, and
//   a row whose tap is the sentinel is not touched.
// * Per (tile, tap) the block gathers src[nbr[tile, k]] once into shared memory
//   (cp.async, zeros for the sentinel) as G[64][c_src], stages f's slice
//   transposed, F[32][64] (the wrapper hands f over as [c_f, m]), and runs
//   mma.sync.m16n8k16 (bf16 in, f32 out) twice on the same G:
//   dx_tile = G . w2[k][:, slice] with G as the row-major A operand, and
//   dw_slice += F . G with G as the B operand through ldmatrix.trans.  A
//   tile's 64 rows are summed apart and join the chunk's running sum with one
//   rounded f32 addition (a blocked sum), so a chunk is a chain of at most 64
//   additions.
//
// Every slice block gathers whole rows, so the gather is repeated c / 32 times
// for wide channels; the map arrives transposed [K, m], so a block reads its
// tap's column coalesced.  No column is assumed sorted.
//
// What bounds it on an H100: the read-modify-write of dx (2 x K passes over
// [m, c_dst] f32 at most) and the gathered rows for narrow channels, mma.sync
// throughput and shared-memory fragment loads for wide ones.

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16_util;

constexpr int kThreads = 256;
constexpr int kBM = 64;      // rows per tile
constexpr int kSlice = 32;   // dx columns and dw rows per block
constexpr int kKMax = 27;
constexpr int kCMax = 256;   // c_src the registers hold a dw slice for
constexpr int kPad = 8;      // bf16 elements of row padding
constexpr int kFStride = kBM + kPad;

__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}

// The B fragment of a 16 x 8 block stored row-major [k][n] in shared memory:
// lanes 0-15 name the 16 rows.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1, const void* row) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

// DW: also the weight gradient (else dx only).
template <bool DW>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const uint16_t* __restrict__ src, const uint16_t* __restrict__ w2t,
             const int* __restrict__ nbr_t, const uint16_t* __restrict__ f_t,
             float* __restrict__ dx, float* __restrict__ part, int m, int n, int k, int c_src,
             int c_dst, int c_f, int m_pad, int rows_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int gstride = c_src + kPad;
  int* s_idx = reinterpret_cast<int*>(smem);                       // [kBM]
  uint16_t* s_g = reinterpret_cast<uint16_t*>(smem + kBM * 4);     // [kBM][gstride] gathered rows
  uint16_t* s_w = s_g + kBM * gstride;                             // [kSlice][gstride] w2[k][:, slice]^T
  uint16_t* s_f = s_w + kSlice * gstride;                          // [kSlice][kFStride] f[tile, slice]^T

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int slice0 = blockIdx.y * kSlice;
  const bool do_dx = slice0 < c_dst;
  const bool do_dw = DW && slice0 < c_f;
  const int r_begin = blockIdx.x * rows_per_chunk;
  const int r_end = min(m, r_begin + rows_per_chunk);
  const int ppr = c_src / 8;      // 16-byte pieces per row
  const int ntiles = c_src / 8;   // 8-column mma tiles across c_src
  // dx: warp -> 16 rows (wm) x 16 columns (wn); dw: warp -> 16 f channels (fm), every 4th column tile from fq
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int fm = warp & 1;
  const int fq = warp >> 1;

  for (int tap = 0; tap < k; ++tap) {
    const int* col = nbr_t + (long long)tap * m;
    if (do_dx) {
      for (int e = tid; e < kSlice * ppr; e += kThreads) {
        const int c = e / ppr;
        const int p = e - c * ppr;
        cp_async16(s_w + c * gstride + p * 8, w2t + ((size_t)tap * c_dst + slice0 + c) * c_src + p * 8);
      }
    }
    float acc[kCMax / 32][4];  // this block's slice of dw[tap]
#pragma unroll
    for (int i = 0; i < kCMax / 32; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int r0 = r_begin; r0 < r_end; r0 += kBM) {
      bool real = false;
      if (tid < kBM) {
        const int i = r0 + tid;
        const int v = i < r_end ? col[i] : n;
        real = (unsigned)v < (unsigned)n;
        s_idx[tid] = real ? v : -1;
      }
      if (!__syncthreads_or(real)) continue;  // uniform: no real source in this tile for this tap
      for (int e = tid; e < kBM * ppr; e += kThreads) {
        const int r = e / ppr;
        const int p = e - r * ppr;
        const int j = s_idx[r];
        uint16_t* dst = s_g + r * gstride + p * 8;
        if (j >= 0)
          cp_async16(dst, src + (size_t)j * c_src + p * 8);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
      if (do_dw) {  // 32 channels x 64 rows of f^T: one 16-byte piece a thread
        const int c = tid >> 3;
        const int p = tid & 7;
        cp_async16(s_f + c * kFStride + p * 8, f_t + (size_t)(slice0 + c) * m_pad + r0 + p * 8);
      }
      cp_async_wait_all();  // also the tap's weights, staged before the first tile
      __syncthreads();

      if (do_dx) {
        float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const uint16_t* arow = s_g + (wm * 16 + gid) * gstride + tig * 2;
        const uint16_t* brow = s_w + (wn * 16 + gid) * gstride + tig * 2;
        for (int k0 = 0; k0 < c_src; k0 += 16) {
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(arow + k0);
          a[1] = *reinterpret_cast<const uint32_t*>(arow + 8 * gstride + k0);
          a[2] = *reinterpret_cast<const uint32_t*>(arow + k0 + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(arow + 8 * gstride + k0 + 8);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const uint16_t* bp = brow + t * 8 * gstride + k0;
            mma_bf16(d[t], a, *reinterpret_cast<const uint32_t*>(bp),
                     *reinterpret_cast<const uint32_t*>(bp + 8));
          }
        }
        // add the tap's product into this block's own rows and columns of dx
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 16 + gid + 8 * h;
          if (s_idx[r] < 0) continue;  // a sentinel tap adds nothing to its row
          float* row = dx + (long long)(r0 + r) * c_dst + slice0 + wn * 16 + tig * 2;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            float2* p = reinterpret_cast<float2*>(row + t * 8);
            float2 v = *p;
            v.x += d[t][2 * h];
            v.y += d[t][2 * h + 1];
            *p = v;
          }
        }
      }

      if (do_dw) {
        const uint16_t* frow = s_f + (fm * 16 + gid) * kFStride + tig * 2;
        // the tile's 64 rows sum on their own, then join the chunk's total with a rounded f32 add:
        // the tensor cores truncate when they add into a large accumulator, and a chain of 156
        // such steps was measured up to 12x further from f64 than the plain version
        float step[kCMax / 32][4];
#pragma unroll
        for (int i = 0; i < kCMax / 32; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) step[i][j] = 0.f;
#pragma unroll
        for (int k0 = 0; k0 < kBM; k0 += 16) {
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(frow + k0);
          a[1] = *reinterpret_cast<const uint32_t*>(frow + 8 * kFStride + k0);
          a[2] = *reinterpret_cast<const uint32_t*>(frow + k0 + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(frow + 8 * kFStride + k0 + 8);
          const uint16_t* grow = s_g + (k0 + (lane & 15)) * gstride;
#pragma unroll
          for (int i = 0; i < kCMax / 32; ++i) {
            const int t = fq + 4 * i;
            if (t < ntiles) {
              uint32_t b0, b1;
              ldmatrix_x2_trans(b0, b1, grow + t * 8);
              mma_bf16(step[i], a, b0, b1);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kCMax / 32; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += step[i][j];
      }
      __syncthreads();  // every warp is done with the tile before the next one is staged
    }

    if (do_dw) {
      float* out = part + (((long long)blockIdx.x * k + tap) * c_f + slice0 + fm * 16 + gid) * c_src + tig * 2;
#pragma unroll
      for (int i = 0; i < kCMax / 32; ++i) {
        const int t = fq + 4 * i;
        if (t < ntiles) {
          *reinterpret_cast<float2*>(out + t * 8) = make_float2(acc[i][0], acc[i][1]);
          *reinterpret_cast<float2*>(out + 8LL * c_src + t * 8) = make_float2(acc[i][2], acc[i][3]);
        }
      }
    }
    // the tap's weights may still be in flight if every tile was skipped
    cp_async_wait_all();
    __syncthreads();
  }
}

// dw[e] = sum_{s < S} part[s][e], s in order
__global__ void dw_reduce_kernel(const float4* __restrict__ part, float4* __restrict__ dw,
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
    dw[e] = acc;
  }
}

template <bool DW>
cudaError_t launch(const void* src, const void* w2t, const void* nbr_t, const void* f_t, void* dx,
                   void* part, int m, int n, int k, int c_src, int c_dst, int c_f, int m_pad,
                   int chunks, int rows_per_chunk, cudaStream_t stream) {
  const int gstride = c_src + kPad;
  const int smem = kBM * 4 + ((kBM + kSlice) * gstride + kSlice * kFStride) * 2;
  auto kern = fused_kernel<DW>;
  // more than 48 KB of shared memory is dynamic and has to be asked for
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int slices = (DW && c_f > c_dst ? c_f : c_dst) / kSlice;
  const dim3 grid(chunks, slices);
  kern<<<grid, kThreads, smem, stream>>>((const uint16_t*)src, (const uint16_t*)w2t,
                                         (const int*)nbr_t, (const uint16_t*)f_t, (float*)dx,
                                         (float*)part, m, n, k, c_src, c_dst, c_f, m_pad,
                                         rows_per_chunk);
  return cudaGetLastError();
}

}  // namespace

// src bf16 [n, c_src]; w2t bf16 [k, c_dst, c_src] (w2 with c_src contiguous);
// nbr_t int32 [k, m] (the map, transposed); f_t bf16 [c_f, m_pad] (f transposed,
// zeros past row m; read only in mode 2); dx f32 [m, c_dst], ZERO-FILLED by the
// caller; dw f32 [k, c_f, c_src] (written in modes 1 and 2); ws f32 [chunks, k,
// c_f, c_src] (mode 2, unused when chunks == 1).  mode: 0 dx only, 1 dx and
// dw = 0, 2 dx and dw.  Rows [s * rows_per_chunk, (s + 1) * rows_per_chunk)
// form chunk s; rows_per_chunk % 64 == 0, chunks * rows_per_chunk >= m,
// m_pad % 64 == 0 and m_pad >= m.  All contiguous on the current device and
// 16-byte aligned.  Needs k <= 27, c_src % 16 == 0, c_src <= 256,
// c_dst % 32 == 0, c_f % 32 == 0.  Returns the first CUDA error of its launches.
extern "C" int lidal_conv_dx_dw_fused(const void* src, const void* w2t, const void* nbr_t,
                                      const void* f_t, void* dx, void* dw, void* ws, int m, int n,
                                      int k, int c_src, int c_dst, int c_f, int m_pad, int chunks,
                                      int rows_per_chunk, int mode, void* stream) {
  const auto s = (cudaStream_t)stream;
  if (m < 0 || n < 0 || k <= 0 || k > kKMax || c_src <= 0 || c_src % 16 != 0 || c_src > kCMax ||
      c_dst <= 0 || c_dst % kSlice != 0 || c_f <= 0 || c_f % kSlice != 0 || mode < 0 || mode > 2 ||
      chunks < 1 || rows_per_chunk < kBM || rows_per_chunk % kBM != 0 ||
      (long long)chunks * rows_per_chunk < m || m_pad % kBM != 0 || m_pad < m)
    return (int)cudaErrorInvalidValue;
  const size_t dw_bytes = sizeof(float) * (size_t)k * c_f * c_src;
  if (mode == 1 || (mode == 2 && m == 0)) {
    const cudaError_t err = cudaMemsetAsync(dw, 0, dw_bytes, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (m == 0) return (int)cudaSuccess;
  if (mode < 2)
    return (int)launch<false>(src, w2t, nbr_t, f_t, dx, nullptr, m, n, k, c_src, c_dst, c_f, m_pad,
                              chunks, rows_per_chunk, s);
  void* part = chunks == 1 ? dw : ws;
  const cudaError_t err = launch<true>(src, w2t, nbr_t, f_t, dx, part, m, n, k, c_src, c_dst, c_f,
                                       m_pad, chunks, rows_per_chunk, s);
  if (err != cudaSuccess || chunks == 1) return (int)err;
  const long long total4 = (long long)k * c_f * c_src / 4;
  const int blocks = (int)((total4 + 255) / 256 < 4096 ? (total4 + 255) / 256 : 4096);
  dw_reduce_kernel<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(ws),
                                          reinterpret_cast<float4*>(dw), total4, chunks);
  return (int)cudaGetLastError();
}
