// 16-byte asynchronous copies from device memory into shared memory, shared by
// the tensor-core kernels (gather_gemm.cuh, gather_gemm_bf16.cuh, conv_dx_dw.cu,
// and through mma_bf16.cuh conv_dx_dw_fused.cu).

#pragma once

#include <cuda_runtime.h>

namespace cp_async_util {

// real = false fills the 16 bytes with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool real = true) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(gmem), "r"(real ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace cp_async_util
