// bf16 gather-GEMM tile for sm_90a, shared by conv_gather_first.cu (the convs
// of the bf16 route and of the probes) and conv_dx_dw_fused.cu (the bf16
// backward's dx):
//
//   out[i] = sum_k table[nbr[i, k]] @ w[k]      (f32 sums; an index outside [0, n) gives 0)
//
// on a bf16 table [n, cin] (or its two int8 byte planes) and bf16 weights
// handed over as [K, cout, cin], the input channels contiguous.  With the
// epilogue EPI > 0 (the eval BatchNorm of pallas_conv.py:162-166, in its
// order, on the f32 sums): y = acc * scale + shift, then relu if EPI == 2,
// then 0 on rows with no real tap (the row-valid mask min(nbr[i]) < n, read
// from the tile's map already in shared memory).
//
// A block of WGS consumer warpgroups owns a BM = 64 WGS row by BN-column output
// tile (BN = 32, 64, 96 or 128; a wider cout takes several column tiles; WGS
// = 3 at BN >= 96 where the grid stays full, else 2: the caller picks).  Its
// prologue loads the tile's [BM, K] map once, coalesced, into a (tap, row)
// table of source rows in shared memory, and lists the taps that name a real
// row somewhere in the tile (one warp ballot and its prefix by popcount); the
// others are skipped.  The reduction runs over the flattened (active tap,
// input channel) axis in stages of 64 columns, so a stage may span several
// taps (cin = 16 or 32) or part of two (cin = 96).  A stage is
//
//   A [BM][64] bf16   the gathered rows: one 16-byte cp.async per piece of 8
//                     channels, zero-filled for the sentinel and past the end,
//   B [BN][64] bf16   the weights of those (tap, channel) columns, likewise,
//
// each in the K-major layout with the 128-byte swizzle that wgmma reads
// (8-row groups of 1024 bytes, the 16-byte piece c of row r at c ^ (r % 8)),
// so no fragment passes through registers.  Each thread owns one 16-byte
// column of the stage for rows tid / 8 + 16 WGS i and carries its (tap,
// channel) from stage to stage without a division.  The stages form a ring
// of S buffers in shared memory (S = 3 .. 8, a run-time argument): stage
// s + S - 1 loads while stage s multiplies.  Warpgroup g takes rows 64 g ..
// 64 g + 63 with wgmma.mma_async m64nBNk16 (bf16 in, f32 sums in registers),
// four per stage, waited for before the next stage's barrier (a group left in
// flight across it made ptxas insert that wait itself, C7517, and measured no
// faster).  With PLANES the table is two int8 byte planes (row i: cin low
// bytes, then cin high bytes of the bf16 bit patterns), read into registers
// and rebuilt with __byte_perm on the way into the same layout: a lossless
// re-encoding, bit-equal to the bf16 table.
//
// Order of the sums: the products of kChain = 4 stages (256 reduction
// columns) chain in one accumulator, which then joins the running total with
// rounded f32 adds: the tensor cores truncate when they add into an
// accumulator, and a chain of 27 x 384 / 16 steps would drift from f64 by
// more than the f32 plain version does.  The order depends on the map, the
// shapes and the tile only, not on the ring's depth: every S gives bit-equal
// output, and no atomics are used.  Each output is written once.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700.00 W): the bytes L2
// hands the SMs.  Every (row, active tap) piece is gathered once per column
// tile and every stage's weights once per row tile; on the dense probe maps
// that is ~1 GB for the 57 GFLOP of a level-0 conv, and the tile reaches
// 200-225 TFLOP/s there, ~4 TB/s out of L2, not the 989 TFLOP/s of the
// tensor cores.  On sparse maps the products of a tile's active taps on
// rows without a real pair (5-11x the real ones) and the weights' bytes set
// the pace.  A third warpgroup on the 192-row tile serves each stage's
// weights to 50 % more rows.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace gather_gemm_bf16 {

using namespace cp_async_util;

constexpr int kKS = 64;        // reduction columns per stage: one 128-byte swizzle row of bf16
constexpr int kKMax = 27;      // taps
constexpr int kChain = 4;      // stages whose products chain in one accumulator
constexpr int kMaxStages = 8;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may ask for on sm_90
// The tile of BN columns and WGS consumer warpgroups of 64 rows each: BM =
// 64 WGS rows, the header (s_nbr [kKMax][BM], s_flag [32], s_act [32],
// s_count, rounded up to the 1024-byte swizzle atom), the stages, and 1024
// bytes to align the dynamic base.  Three warpgroups at BN = 128 hold 168
// registers a thread (BN / 2 f32 of the running sum and BN / 2 of the chain):
// what one block an SM may have.
template <int BN, int WGS>
struct Ring {
  static constexpr int THREADS = 128 * WGS;
  static constexpr int BM = 64 * WGS;
  static constexpr int HEADER = ((kKMax * BM + 65) * 4 + 1023) / 1024 * 1024;
  static constexpr int A_BYTES = BM * kKS * 2;
  static constexpr int STAGE = A_BYTES + BN * kKS * 2;  // a multiple of 1024
  static constexpr int smem(int stages) { return HEADER + stages * STAGE + 1024; }
  static_assert(BN % 32 == 0 && BN <= 128 && (WGS == 2 || (WGS == 3 && BN >= 96)), "tile");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of the 16-byte piece `chunk` of row `row` in a K-major tile of
// 128-byte rows with the 128-byte swizzle.
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return (row >> 3) * 1024 + (row & 7) * 128 + ((chunk ^ (row & 7)) << 4);
}

// wgmma descriptor of a K-major operand with the 128-byte swizzle at shared
// address `addr`: 8-row groups 1024 bytes apart (SBO); the leading offset is
// unused, since a stage's 64 columns are one swizzle row.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// Writes through the generic proxy (cp.async, st.shared) made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// The registers a wgmma writes asynchronously: no access may move across this.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// cp.async.wait_group takes an immediate: at most n of this thread's groups in flight.
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// d[64 x N] (+)= A[64 x 16] B[16 x N]: A and B K-major bf16 in shared memory,
// d f32 in registers (thread t of the warpgroup: rows 16 (t / 32) + (t % 32) / 4
// and + 8, columns 8 j + 2 (t % 4) and + 1 in d[4 j .. 4 j + 3]).
// scale_d == 0 overwrites d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<96> {
  __device__ __forceinline__ static void mma(float (&d)[48], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <int BN, int WGS, bool PLANES, int EPI>  // EPI: 0 none, 1 affine, 2 affine + relu
__global__ void __launch_bounds__(Ring<BN, WGS>::THREADS, 1)
kernel(const unsigned char* __restrict__ table, const uint16_t* __restrict__ wt, const int* __restrict__ nbr,
       const float* __restrict__ scale, const float* __restrict__ shift, float* __restrict__ out, int m, int n,
       int k, int cin, int cout, int stages) {
  using R = Ring<BN, WGS>;
  constexpr int kBM = R::BM;
  constexpr int kThreads = R::THREADS;
  constexpr int ACC = BN / 2;  // f32 registers a thread holds of its warpgroup's 64 x BN tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: align the base to it
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int* s_nbr = reinterpret_cast<int*>(smem);  // [kKMax][kBM]: source row per (tap, row), -1 for the sentinel
  int* s_flag = s_nbr + kKMax * kBM;          // [32]: the tap names a real row in the tile
  int* s_act = s_flag + 32;                   // [32]: the active taps in order
  int* s_count = s_act + 32;
  unsigned char* ring = smem + R::HEADER;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * BN;

  // ---- prologue: the tile's map, coalesced, and its active taps
  if (tid < 32) s_flag[tid] = 0;
  __syncthreads();
  for (int e = tid; e < kBM * k; e += kThreads) {
    const int r = e / k;
    const int t = e - r * k;
    const int v = row0 + r < m ? nbr[(long long)row0 * k + e] : n;
    const bool real = (unsigned)v < (unsigned)n;
    s_nbr[t * kBM + r] = real ? v : -1;
    if (real) s_flag[t] = 1;
  }
  __syncthreads();
  if (tid < 32) {  // the flags become the list of active taps, in tap order
    const bool act = tid < k && s_flag[tid] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, act);
    if (act) s_act[__popc(ballot & ((1u << tid) - 1u))] = tid;
    if (tid == 0) *s_count = __popc(ballot);
  }
  __syncthreads();
  const int nact = *s_count;
  const int nst = (nact * cin + kKS - 1) / kKS;  // stages over the flattened (active tap, channel) axis
  const int ahead = stages - 1;                  // stages loading while one multiplies

  // this thread's pieces: column chunk c (8 channels) of rows (A) and output
  // columns (B) rbase + RS i, at the same swizzled offset in both tiles
  constexpr int RS = kThreads / 8;          // rows (or columns) a pass of the block covers
  constexpr int RS_BYTES = RS / 8 * 1024;   // their bytes in the swizzled tile
  const int c = tid & 7;
  const int rbase = tid >> 3;
  const uint32_t off = sw128(rbase, c);
  int lj = (c * 8) / cin;       // active tap of the chunk in the next stage to load
  int lch = c * 8 - lj * cin;   // and its first channel
  auto advance = [&]() {
    lch += kKS;
    while (lch >= cin) {
      lch -= cin;
      ++lj;
    }
  };
  auto load_stage = [&](int slot) {
    unsigned char* sa = ring + slot * R::STAGE;
    unsigned char* sb = sa + R::A_BYTES;
    const bool live = lj < nact;
    const int tap = live ? s_act[lj] : 0;
    const int* srcs = s_nbr + tap * kBM + rbase;
    if (PLANES) {
      uint2 lo[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int src = live ? srcs[RS * i] : -1;
        lo[i] = hi[i] = make_uint2(0u, 0u);
        if (src >= 0) {
          const unsigned char* rowp = table + (size_t)src * 2 * cin + lch;
          lo[i] = *reinterpret_cast<const uint2*>(rowp);
          hi[i] = *reinterpret_cast<const uint2*>(rowp + cin);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)  // bytes (l0 h0 l1 h1), (l2 h2 l3 h3): the bf16 bit patterns, low byte first
        *reinterpret_cast<uint4*>(sa + off + RS_BYTES * i) =
            make_uint4(__byte_perm(lo[i].x, hi[i].x, 0x5140), __byte_perm(lo[i].x, hi[i].x, 0x7362),
                       __byte_perm(lo[i].y, hi[i].y, 0x5140), __byte_perm(lo[i].y, hi[i].y, 0x7362));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int src = live ? srcs[RS * i] : -1;
        cp_async16(sa + off + RS_BYTES * i, src >= 0 ? table + ((size_t)src * cin + lch) * 2 : table, src >= 0);
      }
    }
    const uint16_t* wrow = wt + ((size_t)tap * cout + col0 + rbase) * cin + lch;
#pragma unroll
    for (int i = 0; i < (BN + RS - 1) / RS; ++i)
      if (BN % RS == 0 || rbase + RS * i < BN)
        cp_async16(sb + off + RS_BYTES * i, live ? wrow + (size_t)RS * i * cin : wt, live);
    cp_async_commit();
  };

  float acc[ACC], part[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = part[i] = 0.f;

  for (int s = 0; s < ahead; ++s) {
    if (s < nst) load_stage(s);
    else cp_async_commit();  // an empty group keeps the count of groups per stage
    advance();
  }
  const uint32_t ring_addr = smem_u32(ring);
  const int wg = tid >> 7;
  for (int s = 0; s < nst; ++s) {
    cp_async_wait_dyn(ahead - 1);  // this thread's pieces of stage s have landed
    fence_proxy_async();
    __syncthreads();  // everyone's pieces; and every warpgroup is done with stage s - 1
    const uint32_t sa = ring_addr + (s % stages) * R::STAGE;
    const bool fresh = s % kChain == 0;  // a chain starts: its first product overwrites part
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKS / 16; ++kk)
      Wgmma<BN>::mma(part, desc_sw128(sa + wg * 64 * 128 + kk * 32), desc_sw128(sa + R::A_BYTES + kk * 32),
                     fresh && kk == 0 ? 0 : 1);
    wgmma_commit();
    // stage s + ahead goes into the slot stage s - 1 used, while the products run
    if (s + ahead < nst) load_stage((s + ahead) % stages);
    else cp_async_commit();
    advance();
    wgmma_wait_all();
    fence_regs(part);
    if (s % kChain == kChain - 1 || s == nst - 1) {  // the chain ends: its sum joins the total
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] += part[i];
    }
  }
  cp_async_wait<0>();  // no copy may still be in flight when the block exits

  // ---- epilogue: each output written once, float2 a fragment pair
  const int t = tid & 127;
  const int rl = wg * 64 + (t >> 5) * 16 + ((t & 31) >> 2);  // the thread's first row in the tile; the other is rl + 8
  const int r = row0 + rl;
  bool ok0 = true, ok1 = true;  // the rows have a real tap (their map rows are in s_nbr, -1 for the sentinel)
  if (EPI > 0) {
    ok0 = ok1 = false;
    for (int tap = 0; tap < k; ++tap) {
      ok0 |= s_nbr[tap * kBM + rl] >= 0;
      ok1 |= s_nbr[tap * kBM + rl + 8] >= 0;
    }
  }
  const int cc = col0 + 2 * (t & 3);
  float* o = out + (size_t)r * cout + cc;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    float2 y0 = make_float2(acc[4 * j], acc[4 * j + 1]);
    float2 y1 = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    if (EPI > 0) {  // acc * scale + shift, relu, row mask: pallas_conv.py:162-166
      const float s0 = __ldg(scale + cc + 8 * j), s1 = __ldg(scale + cc + 8 * j + 1);
      const float h0 = __ldg(shift + cc + 8 * j), h1 = __ldg(shift + cc + 8 * j + 1);
      y0 = make_float2(y0.x * s0 + h0, y0.y * s1 + h1);
      y1 = make_float2(y1.x * s0 + h0, y1.y * s1 + h1);
      if (EPI == 2) {
        y0 = make_float2(fmaxf(y0.x, 0.f), fmaxf(y0.y, 0.f));
        y1 = make_float2(fmaxf(y1.x, 0.f), fmaxf(y1.y, 0.f));
      }
      if (!ok0) y0 = make_float2(0.f, 0.f);
      if (!ok1) y1 = make_float2(0.f, 0.f);
    }
    if (r < m) *reinterpret_cast<float2*>(o + 8 * j) = y0;
    if (r + 8 < m) *reinterpret_cast<float2*>(o + (size_t)8 * cout + 8 * j) = y1;
  }
}

// Dynamic shared memory of the tile of bn columns and `rows` rows (the
// instances below) with `stages` stages; 0 for a tile that has no instance.
inline int smem_bytes(int bn, int rows, int stages) {
  if (rows == 192 && bn == 128) return Ring<128, 3>::smem(stages);
  if (rows == 192 && bn == 96) return Ring<96, 3>::smem(stages);
  if (rows != 128) return 0;
  switch (bn) {
    case 32: return Ring<32, 2>::smem(stages);
    case 64: return Ring<64, 2>::smem(stages);
    case 96: return Ring<96, 2>::smem(stages);
    case 128: return Ring<128, 2>::smem(stages);
    default: return 0;
  }
}

// True when the tile takes these sizes: k <= 27, cin % 8 == 0, a column tile
// bn of 32, 64, 96 or 128 that divides cout, 128 rows (or 192 at bn >= 96),
// and 3 .. 8 stages that fit.
inline bool shapes_ok(int m, int n, int k, int cin, int cout, int bn, int rows, int stages) {
  const int smem = smem_bytes(bn, rows, stages);
  return m >= 0 && n >= 0 && k > 0 && k <= kKMax && cin > 0 && cin % 8 == 0 && smem > 0 && cout > 0 &&
         cout % bn == 0 && stages >= 3 && stages <= kMaxStages && smem <= kSmemMax;
}

template <int BN, int WGS, bool PLANES, int EPI>
cudaError_t launch_tile(const void* table, const void* wt, const int* nbr, const float* scale, const float* shift,
                        float* out, int m, int n, int k, int cin, int cout, int stages, cudaStream_t stream) {
  using R = Ring<BN, WGS>;
  const int smem = R::smem(stages);
  auto kern = kernel<BN, WGS, PLANES, EPI>;
  // more than 48 KB of shared memory is dynamic and has to be asked for
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + R::BM - 1) / R::BM, cout / BN);
  kern<<<grid, R::THREADS, smem, stream>>>((const unsigned char*)table, (const uint16_t*)wt, nbr, scale, shift, out,
                                           m, n, k, cin, cout, stages);
  return cudaGetLastError();
}

// The tile of bn columns and `rows` rows (checked by shapes_ok first); scale
// and shift ([cout] f32) are read only when EPI > 0.
template <bool PLANES, int EPI>
cudaError_t launch(const void* table, const void* wt, const int* nbr, const float* scale, const float* shift,
                   float* out, int m, int n, int k, int cin, int cout, int bn, int rows, int stages,
                   cudaStream_t stream) {
  if (m == 0) return cudaSuccess;
#define TILE(BN, WGS) \
  launch_tile<BN, WGS, PLANES, EPI>(table, wt, nbr, scale, shift, out, m, n, k, cin, cout, stages, stream)
  if (rows == 192) return bn == 128 ? TILE(128, 3) : TILE(96, 3);
  switch (bn) {
    case 32: return TILE(32, 2);
    case 64: return TILE(64, 2);
    case 96: return TILE(96, 2);
    default: return TILE(128, 2);
  }
#undef TILE
}

}  // namespace gather_gemm_bf16
