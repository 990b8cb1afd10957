// fedavg_aggregate for Hopper (sm_90a): the FedAvg server average
//
//     out[n] = sum_k w[k] * x[k, n]        x: (K, N) fp32 or bf16, w: (K,) fp32
//
// accumulated in fp32 and written in the storage dtype.
//
// Replaces repro/kernels/fedavg_agg.py::fedavg_aggregate (the Pallas
// _agg_kernel). That kernel phrases the sum as a (K,) x (K, bn) dot_general
// so that it lands on the TPU's matrix unit; on Hopper the work is a plain
// reduction over K.
//
// What bounds it: HBM bytes. It does 2*K*N flops on 4*K*N (fp32) bytes read
// and 4*N written, a quarter to half a flop per byte, far below the card's
// fp32 ridge, so the least time is the bytes over the memory rate.
//
// What the design does about it: every input byte is read exactly once and
// every output byte written once; nothing is staged through shared memory
// except the (K,) weights, once per block. Each thread owns VEC contiguous
// columns and reads them with one access per row, as wide as N and the
// pointers' alignment allow (16 bytes when N is a multiple of 16/sizeof(T),
// down to one element: the scalar path for ragged N). Neighbouring threads
// read neighbouring addresses, so every warp access is coalesced. The K loop
// is unrolled so that several rows' loads are in flight per thread. Offsets
// are 64-bit. A grid-stride loop covers any N.
//
// The C entry points return cudaGetLastError() after the launch; the
// caller raises on a non-zero code. They launch on the stream they are
// given, allocate nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f32(float a, float* o) { *o = a; }
__device__ __forceinline__ void store_f32(float a, __nv_bfloat16* o) { *o = __float2bfloat16_rn(a); }

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
fedavg_agg_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  T* __restrict__ out, int K, long long N) {
  extern __shared__ float sw[];
  for (int k = threadIdx.x; k < K; k += blockDim.x) sw[k] = w[k];
  __syncthreads();

  using P = Pack<T, VEC>;
  const long long n_vec = N / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n_vec;
       v += stride) {
    const T* col = x + v * VEC;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const P p = *reinterpret_cast<const P*>(col + (long long)k * N);
      const float wk = sw[k];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = fmaf(wk, to_f32(p.v[j]), acc[j]);
    }
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) store_f32(acc[j], &o.v[j]);
    *reinterpret_cast<P*>(out + v * VEC) = o;
  }
}

template <typename T, int VEC>
void launch_vec(const T* x, const float* w, T* out, int K, long long N, cudaStream_t s) {
  const long long n_vec = N / VEC;
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  fedavg_agg_kernel<T, VEC><<<(unsigned)blocks, kThreads, K * sizeof(float), s>>>(
      x, w, out, K, N);
}

// The widest VEC (elements per access) that divides N and keeps every row
// start of x, and out, aligned to VEC * sizeof(T) bytes.
template <typename T>
int pick_vec(const void* x, const void* out, long long N) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  int vec = 16 / (int)sizeof(T);
  while (vec > 1 && (N % vec != 0 || addr % (vec * sizeof(T)) != 0)) vec /= 2;
  return vec;
}

template <typename T>
int launch(const void* x, const void* w, void* out, int K, long long N, void* stream) {
  if (K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  T* ot = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pick_vec<T>(x, out, N)) {
    case 8:
      if constexpr (sizeof(T) == 2) launch_vec<T, 8>(xt, wt, ot, K, N, s);
      break;
    case 4: launch_vec<T, 4>(xt, wt, ot, K, N, s); break;
    case 2: launch_vec<T, 2>(xt, wt, ot, K, N, s); break;
    default: launch_vec<T, 1>(xt, wt, ot, K, N, s); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fedavg_aggregate_f32(const void* x, const void* w, void* out, int K, long long N,
                         void* stream) {
  return launch<float>(x, w, out, K, N, stream);
}

int fedavg_aggregate_bf16(const void* x, const void* w, void* out, int K, long long N,
                          void* stream) {
  return launch<__nv_bfloat16>(x, w, out, K, N, stream);
}

// Elements per access the launch above picks for these pointers and N.
int fedavg_aggregate_vec(const void* x, const void* out, long long N, int elem_bytes) {
  return elem_bytes == 2 ? pick_vec<__nv_bfloat16>(x, out, N) : pick_vec<float>(x, out, N);
}

const char* fedavg_aggregate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
