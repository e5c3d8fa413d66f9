// Point Transformer V3's patch attention on the tensor cores, forward and
// backward, at head dimension 16:
//
//   o = softmax(q k^T * scale) v        per (patch, head), over its K tokens
//
// q, k, v, o, dO, dq, dk, dv [pairs, K, 16] f32 (pairs = patches x heads),
// lse [pairs, K] the rows' log-sum-exp of the scaled scores (natural log), D
// [pairs, K] = rowsum(dO o).
//
// It replaces no TPU kernel: Point Transformer V3 has no counterpart in the
// JAX package.  It takes the place of the library's memory-efficient
// attention (cutlass's sm80 f32 kernels, 64 x 64 tiles), which ran PTv3's
// attention at 6 % of its roofline.
//
// What bounds it on an H100.  At d = 16 a score takes 16 multiply-adds of
// q k^T and 16 of P v, so the products are few and each score's own work
// weighs as much: an exp2, a handful of f32 operations and the split of P
// (in the backward also of dS) into two tf32 halves, besides the shared-memory
// reads of the other side's operands.  Every product is split TF32 as in the
// conv kernels (tf32_mma.cuh: three tf32 mma.sync products per f32 product,
// f32 sums), so the results keep f32 accuracy; the softmax, its maxima, sums
// and the log-sum-exp are f32.
//
// Design.  The K x K scores never leave registers.  A block of 8 warps owns
// 128 rows of one (patch, head), 16 a warp: queries in the forward and in
// dq, keys in dk and dv.  It walks the other side in tiles of 64 rows, which
// the block stages in shared memory once, already split into tf32 halves
// (every warp reads them, so a value is split once a block rather than once a
// warp), the next tile's loads in flight while the warps work on the
// current one.  Two choices of index order take every shuffle and layout
// conversion out of the inner loop: the head dimension is summed in the order
// (4t, 4t + 1), (4t + 2, 4t + 3), so a lane's operands of a row are one
// 16-byte slice; and the rows summed over in P v (and dS k, P^T dO, dS^T q)
// are taken in the order 2t, 2t + 1, so the accumulator layout of a score
// tile is the operand layout of the next product and P is split in the
// registers it was computed in.  The forward is FA2's online softmax with
// log2(e) * scale folded into one multiplier (one exp2 a score).  The
// backward recomputes P from the saved log-sum-exp, in two kernels: dq per
// query tile over the key tiles (it also writes D), then dk and dv per key
// tile over the query tiles.  The tensor cores' own additions truncate, so a
// tile's share of a sum over K goes into a fresh accumulator and joins the
// whole with a rounded f32 add, and a score's small products run before its
// big ones.  No float atomics: every sum runs in an order the shape fixes, so
// two runs from one state give the same bits.  K need not
// be a multiple of 64: in the last tile keys past K score -inf and queries
// past K take an lse of +inf, so both add exact zeros.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using tf32_mma::mma_tf32;
using tf32_mma::split_tf32;

constexpr int kD = 16;                 // the head dimension
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;     // a block's own rows
constexpr int kTile = 64;              // rows of the other side staged a step
constexpr int kTS = kTile + 8;         // stride of a transposed tile: conflict-free 8-byte reads
constexpr int kRowWords = kTile * kD;  // one tf32 half of a tile as rows
constexpr int kColWords = kD * kTS;    // one tf32 half of a tile transposed
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kThreads * 4 == kTile * kD, "a thread stages one 16-byte slice of a tile's matrix");

// Shared memory of a stage (32-bit words); two stages a block.
constexpr int kFwdWords = 2 * kRowWords + 2 * kColWords;                   // k as rows, v transposed
constexpr int kDqWords = 4 * kRowWords + 2 * kColWords;                    // k and v as rows, k transposed
constexpr int kDkvWords = 4 * kRowWords + 4 * kColWords + 2 * kTile;       // q and dO both ways, lse, D

__device__ __forceinline__ float4 slice(const float* x, int row, int K, int q) {
  if (row < K) return __ldg(reinterpret_cast<const float4*>(x + (size_t)row * kD) + q);
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

struct Halves {
  uint4 big, small;
};

__device__ __forceinline__ Halves split4(const float4 v) {
  Halves h;
  split_tf32(v.x, h.big.x, h.small.x);
  split_tf32(v.y, h.big.y, h.small.y);
  split_tf32(v.z, h.big.z, h.small.z);
  split_tf32(v.w, h.big.w, h.small.w);
  return h;
}

// A thread's staged slice is row threadIdx.x / 4 of the tile, values
// 4 (threadIdx.x % 4) .. + 3.  As rows: [row][value] of each half.
__device__ __forceinline__ void put_rows(uint32_t* dst, const Halves& h) {
  const int at = (threadIdx.x >> 2) * kD + 4 * (threadIdx.x & 3);
  *reinterpret_cast<uint4*>(dst + at) = h.big;
  *reinterpret_cast<uint4*>(dst + kRowWords + at) = h.small;
}

// Transposed: [value][row] of each half.
__device__ __forceinline__ void put_cols(uint32_t* dst, const Halves& h) {
  const int row = threadIdx.x >> 2, at = 4 * (threadIdx.x & 3) * kTS + row;
  dst[at] = h.big.x;
  dst[at + kTS] = h.big.y;
  dst[at + 2 * kTS] = h.big.z;
  dst[at + 3 * kTS] = h.big.w;
  dst[kColWords + at] = h.small.x;
  dst[kColWords + at + kTS] = h.small.y;
  dst[kColWords + at + 2 * kTS] = h.small.z;
  dst[kColWords + at + 3 * kTS] = h.small.w;
}

// The A operand of a warp's rows r0 .. r0 + 15 of x (16 x 16), split: k-step s
// takes dimensions 4t + 2s (column t) and 4t + 2s + 1 (column t + 4).
struct Frag {
  uint32_t big[2][4], small[2][4];
};

__device__ __forceinline__ void load_frag(Frag& f, const float* x, int r0, int K) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float4 lo = slice(x, r0 + g, K, t), hi = slice(x, r0 + g + 8, K, t);
  split_tf32(lo.x, f.big[0][0], f.small[0][0]);
  split_tf32(hi.x, f.big[0][1], f.small[0][1]);
  split_tf32(lo.y, f.big[0][2], f.small[0][2]);
  split_tf32(hi.y, f.big[0][3], f.small[0][3]);
  split_tf32(lo.z, f.big[1][0], f.small[1][0]);
  split_tf32(hi.z, f.big[1][1], f.small[1][1]);
  split_tf32(lo.w, f.big[1][2], f.small[1][2]);
  split_tf32(hi.w, f.big[1][3], f.small[1][3]);
}

// c (16 x 8) += a x (rows 8n .. 8n + 7 of a tile staged as rows)^T: c[i][j] =
// sum_d a[i][d] x[8n + j][d].  The four small products first, then the two
// big ones: the tensor cores' own additions truncate, so only the last two
// run at the full magnitude of the sum.  kSwap: `a` holds what the forward and
// dq take from the tile (k and v in dk and dv, against q and dO): the small
// products then run in the same order, so S^T and dP^T there are S and dP of
// the forward and of dq bit for bit, and P is the P of the saved lse.
template <bool kSwap = false>
__device__ __forceinline__ void mma_rows(float (&c)[4], const Frag& a, const uint32_t* x, int n) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int at = (8 * n + g) * kD + 4 * t;
  const uint4 b = *reinterpret_cast<const uint4*>(x + at);
  const uint4 s = *reinterpret_cast<const uint4*>(x + kRowWords + at);
  if (kSwap) {
    mma_tf32(c, a.big[0], s.x, s.y);
    mma_tf32(c, a.small[0], b.x, b.y);
    mma_tf32(c, a.big[1], s.z, s.w);
    mma_tf32(c, a.small[1], b.z, b.w);
  } else {
    mma_tf32(c, a.small[0], b.x, b.y);
    mma_tf32(c, a.big[0], s.x, s.y);
    mma_tf32(c, a.small[1], b.z, b.w);
    mma_tf32(c, a.big[1], s.z, s.w);
  }
  mma_tf32(c, a.big[0], b.x, b.y);
  mma_tf32(c, a.big[1], b.z, b.w);
}

// acc[h] (16 x 8: dimensions 8h .. 8h + 7) += p x (rows 8n .. 8n + 7 of a tile
// staged transposed), p a 16 x 8 accumulator tile over those rows.  Operand
// column t is tile row 8n + 2t and column t + 4 is row 8n + 2t + 1, so p's
// accumulator registers (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
// are its operand registers a0, a2, a1, a3.
__device__ __forceinline__ void mma_cols(float (&acc)[2][4], const float (&p)[4], const uint32_t* xt, int n) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  uint32_t pb[4], ps[4];
  split_tf32(p[0], pb[0], ps[0]);
  split_tf32(p[2], pb[1], ps[1]);
  split_tf32(p[1], pb[2], ps[2]);
  split_tf32(p[3], pb[3], ps[3]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int at = (8 * h + g) * kTS + 8 * n + 2 * t;
    const uint2 b = *reinterpret_cast<const uint2*>(xt + at);
    const uint2 s = *reinterpret_cast<const uint2*>(xt + kColWords + at);
    mma_tf32(acc[h], ps, b.x, b.y);
    mma_tf32(acc[h], pb, s.x, s.y);
    mma_tf32(acc[h], pb, b.x, b.y);
  }
}

// acc = acc * scl[row] + part, rounded f32 operations.  A sum over all K rows
// takes each tile's partial (a fresh accumulator) this way, so the tensor
// cores' truncating additions run over one tile (24 products), not over K;
// the forward's row sums of P the same, with f32 adds.
__device__ __forceinline__ void add_into(float (&acc)[2][4], const float (&part)[2][4], const float (&scl)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[h][e] = fmaf(acc[h][e], scl[e >> 1], part[h][e]);
}

// Sum over the 4 lanes of a row (t = 0 .. 3); every lane gets the same bits.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Stores rows g and g + 8 of a warp's 16 x 16 result (acc[h][2r + e] is row
// r0 + g + 8r, dimension 8h + 2t + e), each times mul[r].
__device__ __forceinline__ void store_rows(float* x, const float (&acc)[2][4], const float (&mul)[2], int r0,
                                           int K) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= K) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(x + (size_t)row * kD + 8 * h + 2 * t) =
          make_float2(acc[h][2 * r] * mul[r], acc[h][2 * r + 1] * mul[r]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    float* __restrict__ o, float* __restrict__ lse, int K, float scale) {
  extern __shared__ __align__(16) uint32_t smem[];
  const size_t base = (size_t)blockIdx.x * K * kD;
  q += base, k += base, v += base, o += base, lse += (size_t)blockIdx.x * K;
  const int t = threadIdx.x & 3, g = (threadIdx.x & 31) >> 2;
  const int r0 = blockIdx.y * kRows + (threadIdx.x >> 5) * 16;
  const bool live = r0 < K;  // the same for a whole warp
  const float c = scale * kLog2e;
  Frag qf;
  load_frag(qf, q, r0, K);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[2][4] = {};
  const int srow = threadIdx.x >> 2, sq = threadIdx.x & 3, tiles = (K + kTile - 1) / kTile;
  float4 kn = slice(k, srow, K, sq), vn = slice(v, srow, K, sq);
  for (int j = 0; j < tiles; ++j) {
    uint32_t* kt = smem + (j & 1) * kFwdWords;
    uint32_t* vt = kt + 2 * kRowWords;
    put_rows(kt, split4(kn));
    put_cols(vt, split4(vn));
    __syncthreads();  // also: every warp is done with the stage written next
    if (j + 1 < tiles) {
      kn = slice(k, (j + 1) * kTile + srow, K, sq);
      vn = slice(v, (j + 1) * kTile + srow, K, sq);
    }
    if (!live) continue;
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      mma_rows(s[n], qf, kt, n);
    }
    const int valid = K - j * kTile;
    if (valid < kTile) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * n + 2 * t + (e & 1) >= valid) s[n][e] = -INFINITY;
    }
    float mc[2], scl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = quad_max(mx);
      mc[r] = mx * c;
      const float alpha = exp2f(fmaf(m[r], c, -mc[r]));  // 0 on the first tile (m = -inf)
      m[r] = mx;
      scl[r] = alpha;
    }
    float ls[2] = {0.f, 0.f}, pv[2][4] = {};  // the tile's partials (see add_into)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = exp2f(fmaf(s[n][e], c, -mc[e >> 1]));
      ls[0] += p[0] + p[1], ls[1] += p[2] + p[3];
      mma_cols(pv, p, vt, n);
    }
    l[0] = fmaf(l[0], scl[0], ls[0]), l[1] = fmaf(l[1], scl[1], ls[1]);
    add_into(acc, pv, scl);
  }
  if (!live) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / l[r];
    const int row = r0 + g + 8 * r;
    if (t == 0 && row < K) lse[row] = fmaf(m[r], scale, logf(l[r]));
  }
  store_rows(o, acc, inv, r0, K);
}

// dq = scale * dS k over the key tiles, dS = P o (dO v^T - D), P recomputed
// from the log-sum-exp; writes D = rowsum(dO o) of its own rows for dkv.
__global__ void __launch_bounds__(kThreads, 2)
    attn_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ o, const float* __restrict__ lse, const float* __restrict__ dout,
                   float* __restrict__ dq, float* __restrict__ dvec, int K, float scale) {
  extern __shared__ __align__(16) uint32_t smem[];
  const size_t base = (size_t)blockIdx.x * K * kD, rbase = (size_t)blockIdx.x * K;
  q += base, k += base, v += base, o += base, dout += base, dq += base, lse += rbase, dvec += rbase;
  const int t = threadIdx.x & 3, g = (threadIdx.x & 31) >> 2;
  const int r0 = blockIdx.y * kRows + (threadIdx.x >> 5) * 16;
  const bool live = r0 < K;
  const float c = scale * kLog2e;
  Frag qf, df;
  load_frag(qf, q, r0, K);
  load_frag(df, dout, r0, K);
  float dd[2], lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // rows past K: dO = 0, so D = 0; their lse is never read
    const int row = r0 + g + 8 * r;
    const float4 a = slice(dout, row, K, t), b = slice(o, row, K, t);
    float x = a.x * b.x;
    x = fmaf(a.y, b.y, x);
    x = fmaf(a.z, b.z, x);
    x = fmaf(a.w, b.w, x);
    dd[r] = quad_sum(x);
    lc[r] = row < K ? lse[row] * kLog2e : 0.f;
    if (t == 0 && row < K) dvec[row] = dd[r];
  }
  float acc[2][4] = {};
  const float one[2] = {1.f, 1.f}, mul[2] = {scale, scale};
  const int srow = threadIdx.x >> 2, sq = threadIdx.x & 3, tiles = (K + kTile - 1) / kTile;
  float4 kn = slice(k, srow, K, sq), vn = slice(v, srow, K, sq);
  for (int j = 0; j < tiles; ++j) {
    uint32_t* kr = smem + (j & 1) * kDqWords;
    uint32_t* vr = kr + 2 * kRowWords;
    uint32_t* kc = kr + 4 * kRowWords;
    const Halves hk = split4(kn);
    put_rows(kr, hk);
    put_cols(kc, hk);
    put_rows(vr, split4(vn));
    __syncthreads();
    if (j + 1 < tiles) {
      kn = slice(k, (j + 1) * kTile + srow, K, sq);
      vn = slice(v, (j + 1) * kTile + srow, K, sq);
    }
    if (!live) continue;
    const int valid = K - j * kTile;
    float part[2][4] = {};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f}, ds[4];
      mma_rows(s, qf, kr, n);
      mma_rows(dp, df, vr, n);
      if (valid < kTile) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * n + 2 * t + (e & 1) >= valid) s[e] = -INFINITY;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[e] = exp2f(fmaf(s[e], c, -lc[e >> 1])) * (dp[e] - dd[e >> 1]);
      mma_cols(part, ds, kc, n);
    }
    add_into(acc, part, one);
  }
  if (!live) return;
  store_rows(dq, acc, mul, r0, K);
}

// dv = P^T dO and dk = scale * dS^T q over the query tiles (the block's rows
// are keys); reads D from attn_dq_kernel.
__global__ void __launch_bounds__(kThreads, 2)
    attn_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ lse, const float* __restrict__ dout,
                    const float* __restrict__ dvec, float* __restrict__ dk, float* __restrict__ dv, int K,
                    float scale) {
  extern __shared__ __align__(16) uint32_t smem[];
  const size_t base = (size_t)blockIdx.x * K * kD, rbase = (size_t)blockIdx.x * K;
  q += base, k += base, v += base, dout += base, dk += base, dv += base, lse += rbase, dvec += rbase;
  const int t = threadIdx.x & 3;
  const int r0 = blockIdx.y * kRows + (threadIdx.x >> 5) * 16;
  const bool live = r0 < K;
  const float c = scale * kLog2e;
  Frag kf, vf;
  load_frag(kf, k, r0, K);
  load_frag(vf, v, r0, K);
  float ak[2][4] = {}, av[2][4] = {};
  const float one[2] = {1.f, 1.f}, mul[2] = {scale, scale};
  const int srow = threadIdx.x >> 2, sq = threadIdx.x & 3, tiles = (K + kTile - 1) / kTile;
  float4 qn = slice(q, srow, K, sq), dn = slice(dout, srow, K, sq);
  // queries past K: lse +inf (P = 0) and D = 0 (their dO is 0 too)
  const int lrow = threadIdx.x;
  float ln = 0.f, dl = 0.f;
  if (lrow < kTile && lrow < K) ln = lse[lrow] * kLog2e, dl = dvec[lrow];
  else if (lrow < kTile) ln = INFINITY;
  for (int j = 0; j < tiles; ++j) {
    uint32_t* qr = smem + (j & 1) * kDkvWords;
    uint32_t* dr = qr + 2 * kRowWords;
    uint32_t* qc = qr + 4 * kRowWords;
    uint32_t* dc = qc + 2 * kColWords;
    float* ls = reinterpret_cast<float*>(dc + 2 * kColWords);
    float* dsh = ls + kTile;
    const Halves hq = split4(qn), hd = split4(dn);
    put_rows(qr, hq);
    put_cols(qc, hq);
    put_rows(dr, hd);
    put_cols(dc, hd);
    if (lrow < kTile) ls[lrow] = ln, dsh[lrow] = dl;
    __syncthreads();
    if (j + 1 < tiles) {
      const int nxt = (j + 1) * kTile;
      qn = slice(q, nxt + srow, K, sq);
      dn = slice(dout, nxt + srow, K, sq);
      if (lrow < kTile && nxt + lrow < K) ln = lse[nxt + lrow] * kLog2e, dl = dvec[nxt + lrow];
      else if (lrow < kTile) ln = INFINITY, dl = 0.f;
    }
    if (!live) continue;
    float pk[2][4] = {}, pv[2][4] = {};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f}, p[4], dsv[4];
      mma_rows<true>(s, kf, qr, n);  // S^T: [key][query]
      mma_rows<true>(dp, vf, dr, n);  // dP^T
      const float2 lq = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(dsh + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(fmaf(s[e], c, -((e & 1) ? lq.y : lq.x)));
        dsv[e] = p[e] * (dp[e] - ((e & 1) ? d2.y : d2.x));
      }
      mma_cols(pv, p, dc, n);
      mma_cols(pk, dsv, qc, n);
    }
    add_into(av, pv, one);
    add_into(ak, pk, one);
  }
  if (!live) return;
  store_rows(dv, av, one, r0, K);
  store_rows(dk, ak, mul, r0, K);
}

bool shape_ok(int pairs, int K) { return pairs >= 0 && K >= 0 && (K + kRows - 1) / kRows <= 65535; }

template <typename Kernel>
cudaError_t ready(Kernel kern, int words) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * words * 4);
}

}  // namespace

// q, k, v [pairs, K, 16] f32 in, o [pairs, K, 16] and lse [pairs, K] f32 out;
// all contiguous on the current device, 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
extern "C" int lidal_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int pairs,
                              int K, float scale, void* stream) {
  if (!shape_ok(pairs, K)) return (int)cudaErrorInvalidValue;
  if (pairs == 0 || K == 0) return (int)cudaSuccess;
  cudaError_t err = ready(attn_fwd_kernel, kFwdWords);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(pairs, (K + kRows - 1) / kRows);
  attn_fwd_kernel<<<grid, kThreads, 2 * kFwdWords * 4, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, K, scale);
  return (int)cudaGetLastError();
}

// The forward's q, k, v, o, lse and dO [pairs, K, 16] in; dq, dk, dv [pairs,
// K, 16] out; dvec [pairs, K] f32 scratch (D).  Two launches on the stream, dq
// first.  Returns the first CUDA error.
extern "C" int lidal_attn_bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
                              const void* dout, void* dq, void* dk, void* dv, void* dvec, int pairs, int K,
                              float scale, void* stream) {
  if (!shape_ok(pairs, K)) return (int)cudaErrorInvalidValue;
  if (pairs == 0 || K == 0) return (int)cudaSuccess;
  const auto s = (cudaStream_t)stream;
  const dim3 grid(pairs, (K + kRows - 1) / kRows);
  cudaError_t err = ready(attn_dq_kernel, kDqWords);
  if (err != cudaSuccess) return (int)err;
  attn_dq_kernel<<<grid, kThreads, 2 * kDqWords * 4, s>>>((const float*)q, (const float*)k, (const float*)v,
                                                           (const float*)o, (const float*)lse,
                                                           (const float*)dout, (float*)dq, (float*)dvec, K,
                                                           scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = ready(attn_dkv_kernel, kDkvWords);
  if (err != cudaSuccess) return (int)err;
  attn_dkv_kernel<<<grid, kThreads, 2 * kDkvWords * 4, s>>>((const float*)q, (const float*)k, (const float*)v,
                                                             (const float*)lse, (const float*)dout,
                                                             (const float*)dvec, (float*)dk, (float*)dv, K,
                                                             scale);
  return (int)cudaGetLastError();
}
