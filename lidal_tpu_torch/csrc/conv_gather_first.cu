// Gather-first sparse convolution on bf16 operands, from a bf16 table or from
// two int8 byte planes.
//
// Replaces tools/probe_conv_v3.py:subm_conv_v3 (the bf16 table, with and
// without `pipelined`) and tools/probe_int8_gather.py:subm_conv_i8 (the byte
// planes).  Both compute the function of subm_conv.cu without its epilogue,
//
//   out[i] = sum_k feats[nbr[i, k]] @ w[k]      (f32 sums; an index outside [0, n) gives 0)
//
// on operands rounded to bf16, and both first ASSEMBLE the gathered rows of a
// group of taps and then contract the whole group once, where subm_conv.cu
// gathers and contracts tap by tap.
//
// The TPU probes gather with one-hot matmuls over banded DMA blocks and pad
// channels to 128 lanes; none of that carries over.  Here a block of 8 warps
// owns a 64-row x BN-column output tile.  It lists the taps that name a real
// row somewhere in the tile (the others are skipped), walks them in groups of
// up to 9 and the channels in chunks of KC = 32 (16 when cin % 32 != 0), and
// for each (group, chunk) stages
//
//   A[64][taps x KC]   the gathered rows, zeros for the sentinel, and
//   W[BN][taps x KC]   the weights of those taps, channel-contiguous
//                      (the wrapper hands w over as [K, cout, cin]),
//
// in shared memory, then contracts [64, taps x KC] x [taps x KC, BN] with
// mma.sync.m16n8k16 (bf16 in, f32 out).  Each stage's sum is kept apart and
// joins the total after it (a blocked sum).  Products of bf16 values are
// exact in f32, so the result differs from the plain version only by the
// order of the f32 sums.
//
// * PIPE stages (group, chunk) i + 1 with cp.async into a second buffer while
//   i is contracted.  The arithmetic and its order are the same, so the output
//   is bit-equal to the unpipelined kernel.
// * PLANES reads each gathered row from two int8 planes (row i: cin low bytes,
//   then cin high bytes of the bf16 bit patterns) and rebuilds the bits,
//   (hi & 0xFF) << 8 | (lo & 0xFF), on the way into shared memory: a lossless
//   re-encoding, so the output is bit-equal to the bf16 table's.  On the TPU
//   the planes let the one-hot product run at the int8 rate; here there is no
//   such product, and what the variant measures is two 1-byte-plane row reads
//   against one 2-byte row read.
//
// What bounds it on an H100: the gathered rows (device memory and L2
// bandwidth; half the bytes of the f32 kernel) for narrow channels, and
// mma.sync throughput plus shared-memory fragment loads for wide ones.  wgmma and
// TMA are left to the redesign; no column of the map is assumed sorted.

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16_util;

constexpr int kThreads = 256;
constexpr int kBM = 64;     // rows per block
constexpr int kKMax = 27;   // taps
constexpr int kGroup = 9;   // taps contracted at once
constexpr int kKCMax = 32;  // channels per stage
constexpr int kPad = 8;     // bf16 elements of row padding: fragment loads hit 32 distinct banks
constexpr int kStrideMax = kGroup * kKCMax + kPad;
// s_idx [kBM][kKMax], then the active-tap list and its length
constexpr int kHeaderBytes = (kBM * kKMax + 32) * 4;

template <int BN, bool PLANES, bool PIPE>
__global__ void __launch_bounds__(kThreads)
gather_first_kernel(const unsigned char* __restrict__ table, const uint16_t* __restrict__ wt,
                    const int* __restrict__ nbr, float* __restrict__ out, int m, int n, int k,
                    int cin, int cout) {
  constexpr int NT = BN / 16;  // 8-column mma tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_idx = reinterpret_cast<int*>(smem);  // source row per (row, tap), -1 for the sentinel
  int* s_act = s_idx + kBM * kKMax;           // taps with a real source in the tile; [kKMax] = how many
  uint16_t* stages = reinterpret_cast<uint16_t*>(smem + kHeaderBytes);
  constexpr int kStageElems = (kBM + BN) * kStrideMax;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;  // the fragment's row (A, C) or column (B)
  const int tig = lane & 3;
  const int wm = warp & 3;   // 16-row slice of the tile
  const int wn = warp >> 2;  // BN / 2-column slice
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * BN;

  if (tid < 32) s_act[tid] = 0;
  __syncthreads();
  for (int e = tid; e < kBM * k; e += kThreads) {
    const int r = e / k;
    const int v = row0 + r < m ? nbr[(long long)row0 * k + e] : n;
    const bool real = (unsigned)v < (unsigned)n;
    s_idx[e] = real ? v : -1;
    if (real) s_act[e - r * k] = 1;
  }
  __syncthreads();
  if (tid == 0) {  // the flags become the list of active taps, in tap order
    int count = 0;
    for (int t = 0; t < k; ++t)
      if (s_act[t]) s_act[count++] = t;
    s_act[kKMax] = count;
  }
  __syncthreads();
  const int nact = s_act[kKMax];
  const int kc = cin % kKCMax == 0 ? kKCMax : 16;
  const int stride = kGroup * kc + kPad;
  const int nchunks = cin / kc;
  const int nstages = ((nact + kGroup - 1) / kGroup) * nchunks;
  const int ppt = kc / 8;  // 16-byte pieces per (row, tap)

  // Stage (group, chunk) `it` into buffer `buf`: the gathered rows and the weights.
  auto stage_in = [&](int it, int buf) {
    const int g = it / nchunks;
    const int c0 = (it - g * nchunks) * kc;
    const int gcount = min(kGroup, nact - g * kGroup);
    const int ppr = gcount * ppt;
    uint16_t* sa = stages + buf * kStageElems;
    uint16_t* sw = sa + kBM * stride;
    for (int e = tid; e < kBM * ppr; e += kThreads) {
      const int r = e / ppr;
      const int q = e - r * ppr;
      const int j = q / ppt;
      const int p = q - j * ppt;
      const int src = s_idx[r * k + s_act[g * kGroup + j]];
      uint16_t* dst = sa + r * stride + j * kc + p * 8;
      if (src < 0) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      } else if (PLANES) {
        const unsigned char* rowp = table + (size_t)src * 2 * cin + c0 + p * 8;
        const uint2 lo = *reinterpret_cast<const uint2*>(rowp);
        const uint2 hi = *reinterpret_cast<const uint2*>(rowp + cin);
        // bytes (l0 h0 l1 h1), (l2 h2 l3 h3): the bf16 bit patterns, low byte first
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(__byte_perm(lo.x, hi.x, 0x5140), __byte_perm(lo.x, hi.x, 0x7362),
                       __byte_perm(lo.y, hi.y, 0x5140), __byte_perm(lo.y, hi.y, 0x7362));
      } else {
        cp_async16(dst, table + ((size_t)src * cin + c0 + p * 8) * 2);
      }
    }
    for (int e = tid; e < BN * ppr; e += kThreads) {
      const int c = e / ppr;
      const int q = e - c * ppr;
      const int j = q / ppt;
      const int p = q - j * ppt;
      const int tap = s_act[g * kGroup + j];
      cp_async16(sw + c * stride + j * kc + p * 8,
                 wt + ((size_t)tap * cout + col0 + c) * cin + c0 + p * 8);
    }
    cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;

  if (PIPE && nstages > 0) stage_in(0, 0);
  for (int it = 0; it < nstages; ++it) {
    const int buf = PIPE ? (it & 1) : 0;
    if (PIPE) {
      if (it + 1 < nstages) {
        stage_in(it + 1, buf ^ 1);
        cp_async_wait<1>();  // stage `it` has landed; `it + 1` is in flight
      } else {
        cp_async_wait<0>();
      }
    } else {
      stage_in(it, 0);
      cp_async_wait<0>();
    }
    __syncthreads();

    const int g = it / nchunks;
    const int ksteps = min(kGroup, nact - g * kGroup) * kc / 16;
    const uint16_t* sa = stages + buf * kStageElems;
    const uint16_t* sw = sa + kBM * stride;
    const uint16_t* arow = sa + (wm * 16 + gid) * stride + tig * 2;
    const uint16_t* brow = sw + (wn * (BN / 2) + gid) * stride + tig * 2;
    float part[NT][4];  // this stage's sum, joining acc after it
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[t][i] = 0.f;
    for (int ks = 0; ks < ksteps; ++ks) {
      const int k0 = ks * 16;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(arow + k0);
      a[1] = *reinterpret_cast<const uint32_t*>(arow + 8 * stride + k0);
      a[2] = *reinterpret_cast<const uint32_t*>(arow + k0 + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(arow + 8 * stride + k0 + 8);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const uint16_t* bp = brow + t * 8 * stride + k0;
        mma_bf16(part[t], a, *reinterpret_cast<const uint32_t*>(bp),
                 *reinterpret_cast<const uint32_t*>(bp + 8));
      }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][i] += part[t][i];
    __syncthreads();  // every warp is done with `buf` before it is staged again
  }

#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int col = col0 + wn * (BN / 2) + t * 8 + tig * 2;
    const int r = row0 + wm * 16 + gid;
    if (r < m) *reinterpret_cast<float2*>(out + (long long)r * cout + col) = make_float2(acc[t][0], acc[t][1]);
    if (r + 8 < m)
      *reinterpret_cast<float2*>(out + (long long)(r + 8) * cout + col) = make_float2(acc[t][2], acc[t][3]);
  }
}

template <int BN, bool PLANES, bool PIPE>
cudaError_t launch(const void* table, const void* wt, const void* nbr, void* out, int m, int n,
                   int k, int cin, int cout, cudaStream_t stream) {
  const int smem = kHeaderBytes + (PIPE ? 2 : 1) * (kBM + BN) * kStrideMax * 2;
  auto kern = gather_first_kernel<BN, PLANES, PIPE>;
  // more than 48 KB of shared memory is dynamic and has to be asked for
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kBM - 1) / kBM, cout / BN);
  kern<<<grid, kThreads, smem, stream>>>((const unsigned char*)table, (const uint16_t*)wt,
                                         (const int*)nbr, (float*)out, m, n, k, cin, cout);
  return cudaGetLastError();
}

}  // namespace

// table: bf16 [n, cin] (planes == 0) or int8 [n, 2 * cin], low-byte plane then
// high-byte plane (planes == 1); wt: bf16 [k, cout, cin], the weights with the
// input channels contiguous; nbr: int32 [m, k]; out: f32 [m, cout].  All
// contiguous on the current device and 16-byte aligned.  Needs k <= 27,
// cin % 16 == 0, cout % 32 == 0; `pipelined` only with planes == 0.  Returns
// the first CUDA error of the launch.
extern "C" int lidal_conv_gather_first(const void* table, const void* wt, const void* nbr, void* out,
                                       int m, int n, int k, int cin, int cout, int planes,
                                       int pipelined, void* stream) {
  const auto s = (cudaStream_t)stream;
  if (m < 0 || n < 0 || k <= 0 || k > kKMax || cin <= 0 || cin % 16 != 0 || cout <= 0 ||
      cout % 32 != 0 || (planes && pipelined))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  const bool wide = cout % 64 == 0;
  if (planes)
    return (int)(wide ? launch<64, true, false>(table, wt, nbr, out, m, n, k, cin, cout, s)
                      : launch<32, true, false>(table, wt, nbr, out, m, n, k, cin, cout, s));
  if (pipelined)
    return (int)(wide ? launch<64, false, true>(table, wt, nbr, out, m, n, k, cin, cout, s)
                      : launch<32, false, true>(table, wt, nbr, out, m, n, k, cin, cout, s));
  return (int)(wide ? launch<64, false, false>(table, wt, nbr, out, m, n, k, cin, cout, s)
                    : launch<32, false, false>(table, wt, nbr, out, m, n, k, cin, cout, s));
}
