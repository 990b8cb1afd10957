// cp.async staging of 4, 8 or 16 bytes from global to shared memory, for
// kernels whose rows sit on 4- or 8-byte boundaries only (an fp32 row of
// N = 2 mod 4 elements), so that a 16-byte copy does not fit every row.
// The copies bypass the registers; a thread commits each batch as a group
// and waits on the groups before a __syncthreads() hands the stage to the
// block. Plain PTX: the kernels that include this header build with plain
// nvcc in seconds.
#pragma once

#include <stdint.h>

namespace async_copy {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy BYTES (4, 8 or 16) from src to dst; both aligned to BYTES. The 16-byte
// copy skips L1 (.cg); the smaller ones may only go through it (.ca).
template <int BYTES>
__device__ __forceinline__ void copy(void* dst, const void* src) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async copies 4, 8 or 16 bytes");
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(BYTES));
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace async_copy
