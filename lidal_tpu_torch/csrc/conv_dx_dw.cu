// Both products of the sparse-conv backward, deterministic: every sum in a fixed order.
//
// Replaces lidal_tpu/ops/pallas_conv.py:conv_dx_dw_pallas.  For a map nbr
// [m, K] into src [n, c_src] (sentinel: any index outside [0, n)) it computes
//
//   dx[i]  = sum_k src[nbr[i, k]] @ w2[k]          -> [m, c_dst]       f32
//   dwg[k] = sum_i f[i]^T src[nbr[i, k]]           -> [K, c_f, c_src]  f32
//
// and ops/conv.py turns dwg into dW through each map's mirror or pairing
// identity.  The TPU kernel pays its one-hot "gather" once for both products,
// in a banded pass whose sequential grid revisits one whole-dW accumulator in
// VMEM.  None of that carries over: CUDA blocks run in no order, and no block
// may carry a sum to another.  So the two products are separate kernels here,
// each with the loop it wants: dx sums over the taps of a row, dwg over the
// rows of a tap.  The bf16 probe's backward (conv_dx_dw_fused.cu) is split the
// same way: its first, one-gather design made dx a read-modify-write of
// [m, c_dst] once per tap, and that dx lost to the row-tile dx below even on
// bf16 operands.
//
// * dx is the forward's gather-GEMM with no epilogue: the split-TF32 tensor-
//   core tile kernel of gather_gemm.cuh, which subm_conv.cu launches too.
//
// * dwg[k] is a product F_k^T S_k over the real pairs of tap k: F_k = f[i] and
//   S_k = src[nbr[i, k]] for the rows i whose tap k is real.  Most (row, tap)
//   entries of a map are not: a down conv's backward map has at most one real
//   tap of 8 a row, and at level 0 of a B = 5 train step 4 % of the [m, 27]
//   entries are real (the caps leave rows empty).  So:
//
//   1. Pair lists (pair_lists.cuh, shared with conv_dx_dw_fused.cu): two
//      small kernels compact nbr_t [K, m] (the map transposed) into each
//      tap's ascending list of the rows i with a real nbr_t[k, i], and its
//      count, which stays on the device: the host never waits on it.
//   2. Products.  A block owns (column tile, chunk of P pairs, tap) and walks
//      its chunk in stages of 64 pairs.  Each stage gathers, with cp.async
//      into shared memory, the pairs' f rows and src rows (zero-fill past the
//      list's end); two stage buffers, so stage s + 1 loads while stage s
//      multiplies, and the pair indices of stage s + 2 (a row from the list,
//      then its source row from nbr_t) are loaded a stage ahead of that.  The
//      reduction axis of the mma is the pair axis: both operands are read
//      "transposed" from their pair-major rows, a fragment element (pair t,
//      column g) at t * stride + g, so both strides are 8 mod 32 and lane
//      (g, t) hits bank (8 t + g) % 32, 32 distinct banks for the A and the B
//      loads alike.  The products are split TF32 (tf32_mma.cuh), three tf32
//      mma.sync.m16n8k8 per f32 product, each warp a 32 x 32 output tile.
//      With c_f % 32 == 0 the M operand is f (tiles of 128, 64 or 32 of c_f)
//      and N is src (64 or 32 of c_src).  Otherwise (the stem's c_f = 4) M is
//      src and N is f in tiles of 8 columns, zero-filled past c_f: a 16-row M
//      tile over 4 channels would leave 3/4 of the tensor cores idle.  Tiles
//      of fewer than 8 warps' outputs split each stage's pairs over 2, 4 or 8
//      warp groups, summed at the end in group order.
//   3. Order.  Each stage's products are summed apart, starting from zero, and
//      join the group's total with one rounded f32 add (the tensor cores
//      truncate when they add into a large accumulator).  The grid is sized
//      from m, the worst case: a block whose chunk starts at or past its tap's
//      count exits at once, except chunk 0, which writes zeros for an empty
//      tap.  Each block writes its partial to a workspace [K, S, c_f, c_src]
//      (straight to dwg when S == 1), and a second kernel (pair_lists.cuh)
//      sums, per tap, the first max(1, ceil(count / P)) partials in chunk order.  P depends on
//      the shape only, so the same input gives bit-equal dwg on every run: 1024
//      pairs, or more where the workspace would not fit (smaller chunks
//      measured slower, since the blocks past a tap's count still launch).
//
// No column of the map is assumed sorted (the up map's parents are not
// monotonic); the list is in row order whatever the columns hold.
//
// What bounds the dwg half on an H100: the split-TF32 products (495 / 3
// TFLOP/s) on the real pairs of the wide tiles, and the gathered rows for
// the narrow ones (the stem gathers 128 + 16 bytes a pair for 4 x 32
// products).  A tile gathers each pair's rows once per column tile.

#include "gather_gemm.cuh"
#include "pair_lists.cuh"

namespace {

using namespace cp_async_util;
using namespace tf32_mma;

constexpr int kThreads = 256;  // 8 warps
constexpr int kStage = 64;      // pairs a dwg block stages at a time (_PAIRS_PER_STAGE in the wrapper)

// The output tile of a dwg block: TM rows of the M operand X by TN columns of
// the N operand Y, out[a][b] = sum_p X[p][a] Y[p][b] over the block's pairs.
// TN >= 32: X = f (a over c_f), Y = src (b over c_src), out = dwg[tap].
// TN == 8: X = src, Y = f (8 columns, zero past c_f), out = dwg[tap]^T.
// Each warp owns 32 rows x 32 (or 8) columns; WK warp groups share a stage.
template <int TM, int TN>
struct DwTile {
  static constexpr bool F_IS_X = TN >= 32;
  static constexpr int WM = TM / 32;                 // warps across the rows
  static constexpr int WN = F_IS_X ? TN / 32 : 1;    // warps across the columns
  static constexpr int WK = 8 / (WM * WN);           // warp groups splitting a stage's pairs
  static constexpr int NT = TN / WN / 8;             // 8-column mma tiles per warp
  static constexpr int KPW = kStage / 8 / WK;        // 8-pair steps per warp group and stage
  static constexpr int XS = TM + 8;                  // X row stride, 8 mod 32: bank (8 t + g) % 32
  static constexpr int YS = F_IS_X ? TN + 8 : TN;    // Y row stride, 8 mod 32 as well (TN = 8: 8)
  static constexpr int STAGE = kStage * (XS + YS);   // floats per stage buffer
  static constexpr int HEADER = 4 * kStage * 4;      // s_i, s_j: two stages each (bytes)
  static constexpr int SMEM = HEADER + 2 * STAGE * 4;
  static_assert(WM * WN * WK == 8 && KPW >= 1 && WK * TM * TN <= 2 * STAGE, "tile shape");
  static_assert(XS % 32 == 8 && YS % 32 == 8, "fragment loads on 32 distinct banks");
};

// part[tap][chunk] (a [c_f, c_src] partial) = the products of the tap's pairs
// [chunk * P, (chunk + 1) * P) of its list, for one column tile.
template <int TM, int TN>
__global__ void __launch_bounds__(kThreads, 2)
dwg_partial_kernel(const float* __restrict__ src, const int* __restrict__ nbr_t,
                   const float* __restrict__ f, const int* __restrict__ rows,
                   const int* __restrict__ counts, float* __restrict__ part, int m, int c_src,
                   int c_f, int chunks, int pairs_per_chunk) {
  using T = DwTile<TM, TN>;
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_i = reinterpret_cast<int*>(smem);  // [2][kStage]: row i of each pair, -1 past the list
  int* s_j = s_i + 2 * kStage;              // [2][kStage]: its source row nbr_t[tap, i]
  float* stages = reinterpret_cast<float*>(smem + T::HEADER);

  const int tap = blockIdx.z;
  const int chunk = blockIdx.y;
  const int count = counts[tap];
  const int q0 = chunk * pairs_per_chunk;
  if (chunk > 0 && q0 >= count) return;  // uniform: nothing of this tap's list here
  const int npairs = max(0, min(pairs_per_chunk, count - q0));
  const int nstages = (npairs + kStage - 1) / kStage;
  const int tiles_b = T::F_IS_X ? c_src / TN : (c_f + TN - 1) / TN;
  const int a0 = (blockIdx.x / tiles_b) * TM;
  const int b0 = (blockIdx.x % tiles_b) * TN;
  const int* list = rows + (long long)tap * m + q0;
  const int* col = nbr_t + (long long)tap * m;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp % T::WM;
  const int wn = (warp / T::WM) % T::WN;
  const int wk = warp / (T::WM * T::WN);

  // pair indices, by the first kStage threads: stage s's in s_i / s_j[s & 1]
  auto row_at = [&](int s) {
    const int q = s * kStage + tid;
    return q < npairs ? list[q] : -1;
  };
  int i_next = -1;  // the row of stage s + 2, loaded during stage s - 1
  if (tid < kStage) {
    const int i0 = row_at(0);
    const int i1 = row_at(1);
    s_i[tid] = i0;
    s_j[tid] = i0 >= 0 ? col[i0] : -1;
    s_i[kStage + tid] = i1;
    s_j[kStage + tid] = i1 >= 0 ? col[i1] : -1;
    i_next = row_at(2);
  }
  __syncthreads();

  // Stage `s` into buffer `buf`: X[p][a] and Y[p][b] for its kStage pairs.
  auto stage_in = [&](int s, int buf) {
    float* sx = stages + buf * T::STAGE;
    float* sy = sx + kStage * T::XS;
    const int* si = s_i + (s & 1) * kStage;
    const int* sj = s_j + (s & 1) * kStage;
    constexpr int PX = TM / 4;  // 16-byte pieces per X row
    for (int e = tid; e < kStage * PX; e += kThreads) {
      const int p = e / PX;
      const int c = (e - p * PX) * 4;
      const bool real = si[p] >= 0;
      const float* g = !real ? f
                       : T::F_IS_X ? f + (long long)si[p] * c_f + a0 + c
                                   : src + (long long)sj[p] * c_src + a0 + c;
      cp_async16(sx + p * T::XS + c, g, real);
    }
    constexpr int PY = TN / 4;  // 16-byte pieces per Y row
    for (int e = tid; e < kStage * PY; e += kThreads) {
      const int p = e / PY;
      const int c = (e - p * PY) * 4;
      const bool real = si[p] >= 0 && (T::F_IS_X || b0 + c < c_f);
      const float* g = !real ? f
                       : T::F_IS_X ? src + (long long)sj[p] * c_src + b0 + c
                                   : f + (long long)si[p] * c_f + b0 + c;
      cp_async16(sy + p * T::YS + c, g, real);
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
    int j_next = -1, i_after = -1;
    if (tid < kStage) {  // issued now, stored after the products: stage s + 2's source row, s + 3's row
      j_next = i_next >= 0 ? col[i_next] : -1;
      i_after = row_at(s + 3);
    }
    const int p0 = wk * T::KPW * 8 + tig;  // this lane's first pair of the stage
    const float* sx = stages + buf * T::STAGE + p0 * T::XS + wm * 32 + gid;
    const float* sy = stages + buf * T::STAGE + kStage * T::XS + p0 * T::YS + wn * (TN / T::WN) + gid;
    float part[2][T::NT][4];  // this stage's sum, joining acc after it
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < T::NT; ++t)
#pragma unroll
        for (int v = 0; v < 4; ++v) part[i][t][v] = 0.f;
#pragma unroll
    for (int kk = 0; kk < T::KPW; ++kk) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // A (row a, pair p) = X[p][a]
        const float* a = sx + kk * 8 * T::XS + i * 16;
        split_tf32(a[0], ab[i][0], as[i][0]);
        split_tf32(a[8], ab[i][1], as[i][1]);
        split_tf32(a[4 * T::XS], ab[i][2], as[i][2]);
        split_tf32(a[4 * T::XS + 8], ab[i][3], as[i][3]);
      }
#pragma unroll
      for (int t = 0; t < T::NT; ++t) {  // B (pair p, column b) = Y[p][b]
        const float* b = sy + kk * 8 * T::YS + t * 8;
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(b[0], bb0, bs0);
        split_tf32(b[4 * T::YS], bb1, bs1);
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
    if (tid < kStage) {  // stage s + 2 uses this buffer: every thread is past stage_in(s)
      s_i[buf * kStage + tid] = i_next;
      s_j[buf * kStage + tid] = j_next;
      i_next = i_after;
    }
  }

  // the warp groups' tiles through shared memory (the stage buffers are free
  // now), summed in group order
  __syncthreads();
  float* red = stages;  // [WK][TM][TN]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < T::NT; ++t) {
      const int r = wm * 32 + i * 16 + gid;
      const int c = wn * (TN / T::WN) + t * 8 + 2 * tig;
      float* o = red + (wk * TM + r) * TN + c;
      o[0] = acc[i][t][0];
      o[1] = acc[i][t][1];
      o[8 * TN] = acc[i][t][2];
      o[8 * TN + 1] = acc[i][t][3];
    }
  __syncthreads();
  float* out = part + ((long long)tap * chunks + chunk) * c_f * c_src;
  for (int e = tid; e < TM * TN; e += kThreads) {
    const int r = T::F_IS_X ? e / TN : e % TM;  // consecutive threads on consecutive addresses
    const int c = T::F_IS_X ? e % TN : e / TM;
    float v = red[r * TN + c];
#pragma unroll
    for (int w = 1; w < T::WK; ++w) v += red[(w * TM + r) * TN + c];
    if (T::F_IS_X)
      out[(long long)(a0 + r) * c_src + b0 + c] = v;
    else if (b0 + c < c_f)
      out[(long long)(b0 + c) * c_src + a0 + r] = v;
  }
}

template <int TM, int TN>
cudaError_t launch_partial(const float* src, const int* nbr_t, const float* f, const int* rows,
                           const int* counts, float* part, int m, int k, int c_src, int c_f,
                           int chunks, int pairs_per_chunk, cudaStream_t stream) {
  using T = DwTile<TM, TN>;
  static_assert(T::SMEM <= gather_gemm::kSmemTwoBlocks, "two blocks an SM");
  auto kern = dwg_partial_kernel<TM, TN>;
  // more than 48 KB of shared memory is dynamic and has to be asked for
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = T::F_IS_X ? (c_f / TM) * (c_src / TN) : (c_src / TM) * ((c_f + TN - 1) / TN);
  const dim3 grid(tiles, chunks, k);
  kern<<<grid, kThreads, T::SMEM, stream>>>(src, nbr_t, f, rows, counts, part, m, c_src, c_f, chunks,
                                            pairs_per_chunk);
  return cudaGetLastError();
}

// The widest tile that divides the shape: c_f % 32 == 0 takes 128, 64 or 32
// rows of c_f by 64 or 32 columns of c_src; any other c_f takes 64 or 32 rows
// of c_src by 8 columns of c_f.
cudaError_t launch_dwg(const float* src, const int* nbr_t, const float* f, float* dwg, float* ws,
                       int* rows, int* counts, int* seg_counts, int m, int n, int k, int c_src,
                       int c_f, int chunks, int pairs_per_chunk, cudaStream_t stream) {
  cudaError_t err = pair_lists::launch_lists(nbr_t, rows, counts, seg_counts, m, n, k, stream);
  if (err != cudaSuccess) return err;
  float* part = chunks == 1 ? dwg : ws;
  const bool n64 = c_src % 64 == 0;
#define DWG_TILE(TM, TN) \
  launch_partial<TM, TN>(src, nbr_t, f, rows, counts, part, m, k, c_src, c_f, chunks, pairs_per_chunk, stream)
  if (c_f % 128 == 0)
    err = n64 ? DWG_TILE(128, 64) : DWG_TILE(128, 32);
  else if (c_f % 64 == 0)
    err = n64 ? DWG_TILE(64, 64) : DWG_TILE(64, 32);
  else if (c_f % 32 == 0)
    err = n64 ? DWG_TILE(32, 64) : DWG_TILE(32, 32);
  else
    err = n64 ? DWG_TILE(64, 8) : DWG_TILE(32, 8);
#undef DWG_TILE
  if (err != cudaSuccess || chunks == 1) return err;
  return pair_lists::launch_reduce(ws, counts, dwg, k, c_f, c_src, chunks, pairs_per_chunk, stream);
}

}  // namespace

// src [n, c_src], w2 [k, c_src, c_dst], nbr [m, k] and nbr_t [k, m] int32 (the
// same map), f [m, c_f]; outputs dx [m, c_dst] (written only when need_dx) and
// dwg [k, c_f, c_src]; scratch: ws [k, chunks, c_f, c_src] f32 (unused when
// chunks == 1), rows [k, m], counts [k] and seg_counts [k, ceil(m / 4096)]
// int32.  Pairs [s * pairs_per_chunk, (s + 1) * pairs_per_chunk) of a tap's
// list form its chunk s: pairs_per_chunk % 64 == 0 and chunks *
// pairs_per_chunk >= m.  All contiguous on the current device and 16-byte
// aligned.  Needs k <= 27, c_src % 32 == 0, c_f % 4 == 0 and, with need_dx,
// c_dst % 32 == 0.  Returns the first CUDA error of its launches.
extern "C" int lidal_conv_dx_dw(const void* src, const void* w2, const void* nbr,
                                const void* nbr_t, const void* f, void* dx, void* dwg, void* ws,
                                void* rows, void* counts, void* seg_counts, int m, int n, int k,
                                int c_src, int c_dst, int c_f, int chunks, int pairs_per_chunk,
                                int need_dx, void* stream) {
  const auto s = (cudaStream_t)stream;
  if (m < 0 || n < 0 || k <= 0 || k > gather_gemm::kKMax || c_src <= 0 || c_src % 32 != 0 ||
      c_f <= 0 || c_f % 4 != 0 || chunks < 1 || chunks > 65535 || pairs_per_chunk < kStage ||
      pairs_per_chunk % kStage != 0 || (long long)chunks * pairs_per_chunk < m ||
      (long long)chunks * pairs_per_chunk > 0x7fffffffLL || (m + pair_lists::kSegRows - 1) / pair_lists::kSegRows > 65535 ||
      (need_dx && !gather_gemm::shapes_ok(m, n, k, c_src, c_dst)))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaMemsetAsync(dwg, 0, sizeof(float) * (size_t)k * c_f * c_src, s);
  if (need_dx) {
    const auto* sp = (const float*)src;
    const auto* wp = (const float*)w2;
    const auto* np = (const int*)nbr;
    auto* dp = (float*)dx;
    const cudaError_t err = gather_gemm::launch<0>(sp, wp, np, nullptr, nullptr, dp, m, n, k, c_src, c_dst, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_dwg((const float*)src, (const int*)nbr_t, (const float*)f, (float*)dwg, (float*)ws,
                         (int*)rows, (int*)counts, (int*)seg_counts, m, n, k, c_src, c_f, chunks,
                         pairs_per_chunk, s);
}
