// f32-accurate products on the tensor cores ("3xTF32"), shared by the gather-GEMM
// tile (gather_gemm.cuh: the forward convs and the backward's dx) and the
// backward's weight gradient (conv_dx_dw.cu).
//
// Every f32 operand x is split into big = tf32(x) and small = tf32(x - big),
// both rounded to nearest, and each product is taken as small_a*big_b +
// big_a*small_b + big_a*big_b with mma.sync.m16n8k8 (tf32 in, f32 sums); only
// small_a*small_b (< 2^-22 of the product) is dropped.  Values within 2^-11 of
// the largest finite float overflow in the split.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32_mma {

// x = big + small + (at most 2^-22 |x|), big and small tf32 operands.  big is x
// rounded to nearest, ties away from zero (half a tf32 ulp added to the
// magnitude, the low 13 bits cleared: what cvt.rna.tf32.f32 gives, in two
// integer operations instead of a conversion); x - big is exact in f32.  small
// gets half an ulp added and keeps its low bits, which the tensor core drops.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// c[16x8] += a[16x8] b[8x8], tf32 operands, f32 sums.  With g = lane / 4 and
// t = lane % 4: a holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b holds
// (t, g), (t + 4, g); c holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tf32_mma
