// Both products of the sparse-conv backward on bf16 operands, deterministic and
// without atomics.
//
// On the bf16 route (ops/conv.BF16_OPERANDS, the counterpart of
// lidal_tpu/ops/conv.py:USE_PALLAS) it takes the place of
// lidal_tpu/ops/pallas_conv.py:conv_dx_dw_pallas in the backward of every
// conv of a train step (dx and dw; dw alone, mode 3, where the conv's input
// needs no gradient: the stem).  It also replaces
// tools/probe_dxdw_features.py:launch with its three bodies: kA (dx only), kB
// (dx, and a second output dw that is all zeros) and kC (dx and dw).
// For a map nbr [m, K] into src [n, c_src] (sentinel: any index outside [0, n))
//
//   dx[i] = sum_k src[nbr[i, k]] @ w2[k]          -> [m, c_dst]       f32
//   dw[k] = sum_i f[i]^T src[nbr[i, k]]           -> [K, c_f, c_src]  f32
//
// with src, w2 and f rounded to bf16 and f32 sums.  The TPU probe paid one
// gather per (row tile, tap) for both products, revisiting one dw accumulator
// in VMEM from a grid that runs in order.  On this card that plan made dx a
// read-modify-write of [m, c_dst] in device memory once per tap and regathered
// whole rows for every 32-column slice; so the two products are two kernels
// here, each with the loop it wants, as in conv_dx_dw.cu:
//
// * dx sums over the taps of a row: the bf16 gather-GEMM tile of
//   gather_gemm_bf16.cuh (wgmma on 128-row tiles, the active taps of a tile
//   only, sums in registers, each output written once), on w2 handed over as
//   [K, c_dst, c_src].
// * dw sums over the rows of a tap, and only a few (row, tap) entries of a map
//   are real (4 % at level 0 of a B = 5 train step).  The per-tap lists of the
//   real pairs are built on the device from the map transposed there
//   (pair_lists.cuh, shared with conv_dx_dw.cu).  A block owns (column tile, chunk of P pairs, tap) and
//   walks its chunk in stages of 128 pairs: cp.async gathers the pairs' f rows
//   and src rows into shared memory, pair-major (zero-fill past the list's
//   end), two stage buffers so stage s + 1 loads while stage s multiplies, the
//   pair indices two stages ahead.  The reduction axis of the mma is the pair
//   axis, so both operands are read transposed, with ldmatrix.x4.trans from
//   rows whose stride is an odd number of 16-byte units (no bank conflict).
//   One mma.sync.m16n8k16 (bf16 in, f32 sums) per product.  A block's tile of
//   [c_f, c_src] is the widest of 128, 96, 64 or 32 that divides each (the
//   level-0 96 x 96 in one tile, so a pair's rows are gathered once), over 8
//   warps; tiles of fewer than 8 warps' outputs split a stage's pairs over 2,
//   4 or 8 warp groups, summed at the end in group order.
//   Each stage's products are summed apart and join the total with one
//   rounded f32 add (the tensor cores truncate when they add into an
//   accumulator).  Each block writes its partial to a workspace [K, S, c_f,
//   c_src], and pair_lists.cuh's second kernel sums, per tap, the partials
//   that hold pairs, in chunk order.  P depends on the shape only, so the same
//   input gives bit-equal dw on every run.
//
// No column of the map is assumed sorted.  What bounds it on an H100 (NVIDIA
// H100 80GB HBM3, 700.00 W): dx as the tile of gather_gemm_bf16.cuh; on the
// sparse maps of a B = 5 train step (4 % of the level-0 entries real) that is
// the products of active taps on rows without a real pair, 5-8x the real
// ones, and the dx tiles take ~10.7 of the ~18.8 ms of device time of a
// step's 42 calls.  dw: the bytes of the gathered rows out of L2 (a pair
// reads a c_f and a c_src row of bf16 for 2 c_f c_src operations; ~3 TB/s on
// the probe's dense level-0 map); over a step, its kernels (transpose, lists,
// products, ordered sums) take ~5.3 ms and the wrapper's casts of src and f
// to bf16 ~2.5 ms of device time.

#include "gather_gemm_bf16.cuh"
#include "mma_bf16.cuh"
#include "pair_lists.cuh"

namespace {

using namespace mma_bf16_util;

constexpr int kThreads = 256;  // 8 warps
constexpr int kStage = 128;    // pairs a dw block stages at a time (_PAIRS_PER_STAGE in the wrapper)

// Four 8 x 8 b16 matrices, transposed: lanes 8 q .. 8 q + 7 name the rows of matrix q.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The output tile of a dw block: TM rows of c_f by TN columns of c_src,
// out[a][b] = sum_p f[i_p][a] src[j_p][b] over the block's pairs.  WM x WN
// warps own (TM / WM) x (TN / WN) of it each, MI x NJ tiles of 16 x 8: the
// most warps on distinct outputs with at most 18 such tiles a warp (their sum
// and the stage's, 144 registers), then the fewest ldmatrix loads per mma;
// WK warp groups share a stage's pairs.
template <int TM, int TN>
struct DwTile {
  static constexpr int layout() {  // 16 WM + WN
    int best = 0, best_loads = 1 << 20;
    for (int wm = 1; wm <= 8; wm *= 2)
      for (int wn = 1; wm * wn <= 8; wn *= 2) {
        if (TM % (16 * wm) != 0 || TN % (16 * wn) != 0 || (TM / wm / 16) * (TN / wn / 8) > 18) continue;
        const int loads = (TM / wm / 16 + TN / wn / 16) * TM * TN / (TM / wm * TN / wn);  // per tile's mma step
        if (wm * wn > (best / 16) * (best % 16) || (wm * wn == (best / 16) * (best % 16) && loads < best_loads)) {
          best = 16 * wm + wn;
          best_loads = loads;
        }
      }
    return best;
  }
  static constexpr int WM = layout() / 16;         // warps across the rows
  static constexpr int WN = layout() % 16;         // warps across the columns
  static constexpr int WK = 8 / (WM * WN);         // warp groups splitting a stage's pairs
  static constexpr int MI = TM / WM / 16;          // 16-row mma tiles per warp
  static constexpr int NJ = TN / WN / 8;           // 8-column mma tiles per warp (even: two a load)
  static constexpr int KPW = kStage / 16 / WK;     // 16-pair steps per warp group and stage
  static constexpr int XS = TM + 8;                // f rows' stride (bf16): an odd number of 16-byte units
  static constexpr int YS = TN + 8;                // src rows' stride, likewise
  static constexpr int STAGE = kStage * (XS + YS);  // bf16 per stage buffer
  static constexpr int HEADER = 4 * kStage * 4;    // s_i, s_j: two stages each (bytes)
  static constexpr int SMEM = HEADER + 2 * STAGE * 2;
  static_assert(WM > 0 && MI * NJ <= 18 && NJ % 2 == 0 && WM * WN * WK == 8 && KPW >= 1, "warp layout");
  static_assert(WK * TM * TN * 4 <= 2 * STAGE * 2, "the warp groups' sums fit the stage buffers");
  static_assert((XS / 8) % 2 == 1 && (YS / 8) % 2 == 1, "ldmatrix rows on distinct banks");
};

// part[tap][chunk] (a [c_f, c_src] partial) = the products of the tap's pairs
// [chunk * P, (chunk + 1) * P) of its list, for one column tile.
template <int TM, int TN>
__global__ void __launch_bounds__(kThreads, 1)
dw_partial_kernel(const uint16_t* __restrict__ src, const int* __restrict__ nbr_t,
                  const uint16_t* __restrict__ f, const int* __restrict__ rows,
                  const int* __restrict__ counts, float* __restrict__ part, int m, int c_src, int c_f,
                  int chunks, int pairs_per_chunk) {
  using T = DwTile<TM, TN>;
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_i = reinterpret_cast<int*>(smem);  // [2][kStage]: row i of each pair, -1 past the list
  int* s_j = s_i + 2 * kStage;              // [2][kStage]: its source row nbr_t[tap, i]
  uint16_t* stages = reinterpret_cast<uint16_t*>(smem + T::HEADER);

  const int tap = blockIdx.z;
  const int chunk = blockIdx.y;
  const int count = counts[tap];
  const int q0 = chunk * pairs_per_chunk;
  if (chunk > 0 && q0 >= count) return;  // uniform: nothing of this tap's list here
  const int npairs = max(0, min(pairs_per_chunk, count - q0));
  const int nstages = (npairs + kStage - 1) / kStage;
  const int tiles_b = c_src / TN;
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

  // Stage `s` into buffer `buf`: X[p][a] = f[i_p][a0 + a] and Y[p][b] = src[j_p][b0 + b].
  auto stage_in = [&](int s, int buf) {
    uint16_t* sx = stages + buf * T::STAGE;
    uint16_t* sy = sx + kStage * T::XS;
    const int* si = s_i + (s & 1) * kStage;
    const int* sj = s_j + (s & 1) * kStage;
    constexpr int PX = TM / 8;  // 16-byte pieces per f row
    for (int e = tid; e < kStage * PX; e += kThreads) {
      const int p = e / PX;
      const int c = (e - p * PX) * 8;
      const bool real = si[p] >= 0;
      cp_async16(sx + p * T::XS + c, real ? f + (long long)si[p] * c_f + a0 + c : f, real);
    }
    constexpr int PY = TN / 8;  // 16-byte pieces per src row
    for (int e = tid; e < kStage * PY; e += kThreads) {
      const int p = e / PY;
      const int c = (e - p * PY) * 8;
      const bool real = si[p] >= 0;
      cp_async16(sy + p * T::YS + c, real ? src + (long long)sj[p] * c_src + b0 + c : src, real);
    }
    cp_async_commit();
  };

  float acc[T::MI][T::NJ][4];
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int t = 0; t < T::NJ; ++t)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][t][v] = 0.f;

  // ldmatrix lanes: matrix q = lane / 8, its row lane % 8
  const int q = lane >> 3;
  const int rr = lane & 7;
  const int am = wm * (TM / T::WM);  // this warp's first row of the tile
  const int bn = wn * (TN / T::WN);  // and first column
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
    const uint16_t* sx = stages + buf * T::STAGE;
    const uint16_t* sy = sx + kStage * T::XS;
    float step[T::MI][T::NJ][4];  // this stage's sum, joining acc after it
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int t = 0; t < T::NJ; ++t)
#pragma unroll
        for (int v = 0; v < 4; ++v) step[i][t][v] = 0.f;
#pragma unroll
    for (int kk = 0; kk < T::KPW; ++kk) {
      const int p0 = (wk * T::KPW + kk) * 16;
      uint32_t a[T::MI][4], b[T::NJ / 2][4];
#pragma unroll
      for (int i = 0; i < T::MI; ++i)  // A (row a, pair p) = X[p][a]: matrices (a 0-7 | 8-15) x (p 0-7 | 8-15)
        ldmatrix_x4_trans(a[i], sx + (p0 + 8 * (q >> 1) + rr) * T::XS + am + 16 * i + 8 * (q & 1));
#pragma unroll
      for (int h = 0; h < T::NJ / 2; ++h)  // B (pair p, column b) = Y[p][b]: two 8-column tiles a load
        ldmatrix_x4_trans(b[h], sy + (p0 + 8 * (q & 1) + rr) * T::YS + bn + 16 * h + 8 * (q >> 1));
#pragma unroll
      for (int i = 0; i < T::MI; ++i)
#pragma unroll
        for (int t = 0; t < T::NJ; ++t)
          mma_bf16(step[i][t], a[i], b[t >> 1][2 * (t & 1)], b[t >> 1][2 * (t & 1) + 1]);
    }
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int t = 0; t < T::NJ; ++t)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][t][v] += step[i][t][v];
    if (tid < kStage) {  // stage s + 2 uses this buffer: every thread is past stage_in(s)
      s_i[buf * kStage + tid] = i_next;
      s_j[buf * kStage + tid] = j_next;
      i_next = i_after;
    }
  }

  // the warp groups' tiles through shared memory (the stage buffers are free
  // now), summed in group order
  __syncthreads();
  float* red = reinterpret_cast<float*>(stages);  // [WK][TM][TN]
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int t = 0; t < T::NJ; ++t) {
      const int r = am + i * 16 + gid;
      const int c = bn + t * 8 + 2 * tig;
      float* o = red + (wk * TM + r) * TN + c;
      o[0] = acc[i][t][0];
      o[1] = acc[i][t][1];
      o[8 * TN] = acc[i][t][2];
      o[8 * TN + 1] = acc[i][t][3];
    }
  __syncthreads();
  float* out = part + ((long long)tap * chunks + chunk) * c_f * c_src;
  for (int e = tid; e < TM * TN; e += kThreads) {
    const int r = e / TN;
    const int c = e % TN;
    float v = red[r * TN + c];
#pragma unroll
    for (int w = 1; w < T::WK; ++w) v += red[(w * TM + r) * TN + c];
    out[(long long)(a0 + r) * c_src + b0 + c] = v;
  }
}

template <int TM, int TN>
cudaError_t launch_partial(const uint16_t* src, const int* nbr_t, const uint16_t* f, const int* rows,
                           const int* counts, float* part, int m, int k, int c_src, int c_f, int chunks,
                           int pairs_per_chunk, cudaStream_t stream) {
  using T = DwTile<TM, TN>;
  auto kern = dw_partial_kernel<TM, TN>;
  // more than 48 KB of shared memory is dynamic and has to be asked for
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((c_f / TM) * (c_src / TN), chunks, k);
  kern<<<grid, kThreads, T::SMEM, stream>>>(src, nbr_t, f, rows, counts, part, m, c_src, c_f, chunks,
                                            pairs_per_chunk);
  return cudaGetLastError();
}

template <int TM>
cudaError_t launch_cols(const uint16_t* src, const int* nbr_t, const uint16_t* f, const int* rows,
                        const int* counts, float* part, int m, int k, int c_src, int c_f, int chunks,
                        int pairs_per_chunk, cudaStream_t stream) {
#define DW_TILE(TN) \
  launch_partial<TM, TN>(src, nbr_t, f, rows, counts, part, m, k, c_src, c_f, chunks, pairs_per_chunk, stream)
  if (c_src % 128 == 0) return DW_TILE(128);
  if (c_src % 96 == 0) return DW_TILE(96);
  if (c_src % 64 == 0) return DW_TILE(64);
  return DW_TILE(32);
#undef DW_TILE
}

// The widest tile that divides the shape: 128, 96, 64 or 32 rows of c_f by
// 128, 96, 64 or 32 columns of c_src, so a pair's rows are gathered once per
// tile and as few tiles as the shape allows.
cudaError_t launch_dw(const uint16_t* src, const int* nbr, int* nbr_t, const uint16_t* f, float* dw, float* ws,
                      int* rows, int* counts, int* seg_counts, int m, int n, int k, int c_src, int c_f,
                      int chunks, int pairs_per_chunk, cudaStream_t stream) {
  cudaError_t err = pair_lists::launch_transpose(nbr, nbr_t, m, k, stream);
  if (err != cudaSuccess) return err;
  err = pair_lists::launch_lists(nbr_t, rows, counts, seg_counts, m, n, k, stream);
  if (err != cudaSuccess) return err;
  float* part = chunks == 1 ? dw : ws;
  if (c_f % 128 == 0)
    err = launch_cols<128>(src, nbr_t, f, rows, counts, part, m, k, c_src, c_f, chunks, pairs_per_chunk, stream);
  else if (c_f % 96 == 0)
    err = launch_cols<96>(src, nbr_t, f, rows, counts, part, m, k, c_src, c_f, chunks, pairs_per_chunk, stream);
  else if (c_f % 64 == 0)
    err = launch_cols<64>(src, nbr_t, f, rows, counts, part, m, k, c_src, c_f, chunks, pairs_per_chunk, stream);
  else
    err = launch_cols<32>(src, nbr_t, f, rows, counts, part, m, k, c_src, c_f, chunks, pairs_per_chunk, stream);
  if (err != cudaSuccess || chunks == 1) return err;
  return pair_lists::launch_reduce(ws, counts, dw, k, c_f, c_src, chunks, pairs_per_chunk, stream);
}

}  // namespace

// src bf16 [n, c_src]; w2t bf16 [k, c_dst, c_src] (w2 with c_src contiguous);
// nbr int32 [m, k]; f bf16 [m, c_f] (read only in mode 2); dx f32 [m, c_dst];
// dw f32 [k, c_f, c_src] (written in modes 1, 2 and 3); scratch for modes 2
// and 3: nbr_t [k, m] (the map transposed here), ws f32 [k, chunks, c_f,
// c_src] (unused when chunks == 1), rows [k, m], counts [k] and seg_counts
// [k, ceil(m / 4096)] int32.  mode: 0 dx only, 1 dx and dw = 0, 2 dx and dw,
// 3 dw only (dx is not written).  bn, bm and stages: dx's tile (columns,
// rows) and ring depth (gather_gemm_bf16::shapes_ok).
// Pairs [s * pairs_per_chunk, (s + 1) * pairs_per_chunk) of a tap's list form
// its chunk s: pairs_per_chunk % 128 == 0 and chunks * pairs_per_chunk >= m.
// All contiguous on the current device and 16-byte aligned.  Needs k <= 27,
// c_src % 32 == 0 and c_f % 32 == 0.  Returns the first CUDA error of its
// launches.
extern "C" int lidal_conv_dx_dw_fused(const void* src, const void* w2t, const void* nbr, const void* nbr_t,
                                      const void* f, void* dx, void* dw, void* ws, void* rows, void* counts,
                                      void* seg_counts, int m, int n, int k, int c_src, int c_dst, int c_f,
                                      int bn, int bm, int stages, int chunks, int pairs_per_chunk, int mode,
                                      void* stream) {
  const auto s = (cudaStream_t)stream;
  if (!gather_gemm_bf16::shapes_ok(m, n, k, c_src, c_dst, bn, bm, stages) || c_src % 32 != 0 || c_f <= 0 ||
      c_f % 32 != 0 || mode < 0 || mode > 3 || chunks < 1 || chunks > 65535 || pairs_per_chunk < kStage ||
      pairs_per_chunk % kStage != 0 || (long long)chunks * pairs_per_chunk < m ||
      (long long)chunks * pairs_per_chunk > 0x7fffffffLL ||
      (m + pair_lists::kSegRows - 1) / pair_lists::kSegRows > 65535)
    return (int)cudaErrorInvalidValue;
  if (mode != 3) {
    const cudaError_t err = gather_gemm_bf16::launch<false, 0>(src, w2t, (const int*)nbr, nullptr, nullptr,
                                                               (float*)dx, m, n, k, c_src, c_dst, bn, bm, stages, s);
    if (err != cudaSuccess || mode == 0) return (int)err;
  }
  if (mode == 1 || m == 0) return (int)cudaMemsetAsync(dw, 0, sizeof(float) * (size_t)k * c_f * c_src, s);
  return (int)launch_dw((const uint16_t*)src, (const int*)nbr, (int*)nbr_t, (const uint16_t*)f, (float*)dw, (float*)ws,
                        (int*)rows, (int*)counts, (int*)seg_counts, m, n, k, c_src, c_f, chunks,
                        pairs_per_chunk, s);
}
