// The warp-level m16n8k16 bf16 product of the bf16 backward's weight gradient
// (conv_dx_dw_fused.cu), with the 16-byte asynchronous copies of cp_async.cuh.
// The gather-GEMM tile (gather_gemm_bf16.cuh) multiplies with wgmma instead.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace mma_bf16_util {

using namespace cp_async_util;

// c[16x8] += a[16x16] b[16x8], bf16 operands, f32 sums.  With g = lane / 4 and
// t = lane % 4: a holds rows g, g + 8 at columns 2t, 2t + 1 and 2t + 8, 2t + 9
// (row-major pairs), b holds rows 2t, 2t + 1 and 2t + 8, 2t + 9 of column g,
// c holds rows g, g + 8 at columns 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma_bf16_util
