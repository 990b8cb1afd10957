// sparse_aggregate for Hopper (sm_90a): the top-k codec's server average
//
//     out[idx[k, j]] += w[k] * vals[k, j]      idx: (K, k) int32, vals: (K, k) fp32 or bf16
//
// into a zeroed dense (n,) fp32 output, which the caller allocates.
//
// Replaces repro/kernels/sparse_agg.py::sparse_aggregate (the Pallas
// _sparse_kernel). That kernel walks client blocks on a sequential grid and
// scatter-adds each block into one (n,) accumulator that stays in VMEM
// across the grid; on Hopper the blocks run in parallel, so the shared
// accumulator takes atomic adds instead.
//
// What bounds it: HBM bytes. It does 2 flops per pair on 8 bytes read (a
// 4-byte index and a 4-byte value), and the output is written once by the
// zero fill. The least time is K*k*8 bytes read plus n*4 written, over the
// memory rate.
//
// What the design does about it: one thread per (client, pair) reads its
// index and value once, coalesced across the warp, and issues one fp32
// atomic add (a fire-and-forget RED, since the result is unused). The
// dense (K, n) client deltas never exist. Top-k indices are unique within a
// client but collide across clients; the adds land in L2, where the CNN's
// 6.65 MB output stays while they arrive (50 MB of L2). The order of the
// adds, and so the last bits of the fp32 sum, varies from run to run.
// Indices outside [0, n) are dropped, so a bad index cannot write outside
// the output; top-k emits none.
//
// The C entry points return cudaGetLastError() after the launch; the
// caller raises on a non-zero code. They launch on the stream they are
// given, allocate nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
sparse_agg_kernel(const int* __restrict__ idx, const T* __restrict__ vals,
                  const float* __restrict__ w, float* __restrict__ out, long long total,
                  long long k, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const long long i = idx[t];
    if (i >= 0 && i < n) atomicAdd(out + i, w[t / k] * to_f32(vals[t]));
  }
}

template <typename T>
int launch(const void* idx, const void* vals, const void* w, void* out, int K, long long k,
           long long n, void* stream) {
  if (K < 1 || k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)K * k;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  sparse_agg_kernel<T><<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const T*>(vals),
      static_cast<const float*>(w), static_cast<float*>(out), total, k, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sparse_aggregate_f32(const void* idx, const void* vals, const void* w, void* out, int K,
                         long long k, long long n, void* stream) {
  return launch<float>(idx, vals, w, out, K, k, n, stream);
}

int sparse_aggregate_bf16(const void* idx, const void* vals, const void* w, void* out, int K,
                          long long k, long long n, void* stream) {
  return launch<__nv_bfloat16>(idx, vals, w, out, K, k, n, stream);
}

const char* sparse_aggregate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
