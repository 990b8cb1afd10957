// Raw PTX for Hopper's (and Ampere's) warp-level bf16 tensor-core path:
// cp.async staging, ldmatrix fragment loads and mma.sync m16n8k16 with fp32
// sums. No CUTLASS or CuTe: the kernels that include this header build with
// plain nvcc in seconds.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// for lane l of the warp, g = l / 4 (the row group) and t = l % 4:
//   A (16 x 16, row major), four 32-bit registers of two bf16 each, the
//     lower half the lower column:
//       a0 = A[g][2t, 2t+1]      a1 = A[g+8][2t, 2t+1]
//       a2 = A[g][2t+8, 2t+9]    a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, k by n, "col": k runs fastest for a fixed n), two registers:
//       b0 = B[2t, 2t+1][g]      b1 = B[2t+8, 2t+9][g]
//   C and D (16 x 8 fp32), four floats:
//       c0, c1 = C[g][2t, 2t+1]  c2, c3 = C[g+8][2t, 2t+1]
// So the C fragments of two neighbouring 8-column tiles are, converted to
// bf16 pairs, the A fragment of a 16-column slice: a0 = (c0, c1) and
// a1 = (c2, c3) of the left tile, a2 and a3 those of the right one. A
// product's output becomes the next product's input without leaving the
// registers.
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices; lanes 8i .. 8i+7 give the
// shared-memory addresses of matrix i's eight rows (16 bytes each), and
// register i of lane l receives row g, columns 2t and 2t+1 of matrix i. With
// .trans it receives rows 2t and 2t+1 of column g instead: the transpose, as
// a B fragment needs it from a row-major (k, n) tile.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared memory without passing through
// registers. With valid false nothing is read and the 16 bytes are zeros
// (src must still be a mapped address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b on the tensor cores: bf16 products, fp32 sums.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (flushes denormal results to 0), as
// exp2f under --use_fast_math compiles it; without that flag exp2f adds a
// range fix-up around the same instruction.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) rounded to bf16 as hi, and the rest rounded to bf16 as lo:
// hi + lo holds x and y to about 2^-16 of their size, where hi alone holds
// 2^-8. Two bf16 products, hi b + lo b, then carry an fp32 operand through
// the tensor cores at the precision the fp32 reference keeps.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = pack_bf16(h);
  lo = pack_bf16(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

}  // namespace mma_bf16
