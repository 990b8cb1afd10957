// Calibration kernels for kernels/probe.py: what the card's pipes deliver to
// instruction streams shaped like the port's kernels, with no memory traffic.
//
//   probe_ffma: 32 independent FFMA chains a thread (the fp32 peak);
//   probe_ex2: 16 independent ex2.approx chains a thread (the
//     special-function units' peak, the exp2 bound of ssm_scan);
//   probe_outer<R, C>: gossip_mix_dense_kernel's FMA pattern, acc[R][C] +=
//     w[r] * x[q], with w and x read from shared memory as the kernel reads
//     them (a k-major W row group of R values, a row of X of C values);
//   probe_stream: the streaming floor of the codec aggregates' bytes: K rows
//     of a payload read in coalesced 16-byte loads, one thread a 16-byte
//     column, their words summed, and per_col float4s a column written in
//     coalesced 16-byte stores (column j of the outputs at j * cols + c, so
//     that a warp's stores are contiguous). Nothing else is computed.
//
// Plain extern "C" entry points; each returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

__global__ void probe_ffma(float* out, int iters, float w, float x) {
  float a[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) a[j] = threadIdx.x * 0.001f + j;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 32; ++j) a[j] = fmaf(a[j], w, x);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) s += a[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void probe_ex2(float* out, int iters, float w) {
  float a[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = threadIdx.x * 1e-6f + j * 1e-3f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float r;
      asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a[j]));
      a[j] = r * w;
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) s += a[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int R, int C>
__global__ void __launch_bounds__(256) probe_outer(float* out, int iters) {
  __shared__ __align__(16) float sw[64 * 128];
  __shared__ __align__(16) float sx[64 * 64];
  for (int e = threadIdx.x; e < 64 * 128; e += blockDim.x) sw[e] = 1e-3f * (e % 97);
  for (int e = threadIdx.x; e < 64 * 64; e += blockDim.x) sx[e] = 1e-3f * (e % 89);
  __syncthreads();
  const int rgi = threadIdx.x / 16 % (128 / R), cgi = threadIdx.x % (64 / C);
  float acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < C; ++q) acc[r][q] = 0.f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll 4
    for (int k = 0; k < 64; ++k) {
      float wr[R], xr[C];
#pragma unroll
      for (int r = 0; r < R; r += 4) {
        const float4 v = *reinterpret_cast<const float4*>(sw + k * 128 + rgi * R + r);
        wr[r] = v.x;
        wr[r + 1] = v.y;
        wr[r + 2] = v.z;
        wr[r + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < C; q += 4) {
        const float4 v = *reinterpret_cast<const float4*>(sx + k * 64 + cgi * C + q);
        xr[q] = v.x;
        xr[q + 1] = v.y;
        xr[q + 2] = v.z;
        xr[q + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < C; ++q) acc[r][q] = fmaf(wr[r], xr[q], acc[r][q]);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < C; ++q) s += acc[r][q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void probe_stream(const uint4* __restrict__ in, int K, long long cols,
                             float4* __restrict__ out, int per_col) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < cols; c += stride) {
    unsigned s = 0;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const uint4 v = in[k * cols + c];
      s += v.x + v.y + v.z + v.w;
    }
    const float f = (float)s;
    for (int j = 0; j < per_col; ++j) out[j * cols + c] = make_float4(f, f, f, f);
  }
}

}  // namespace

extern "C" {

int probe_ffma_run(float* out, int blocks, int threads, int iters, void* stream) {
  probe_ffma<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters, 0.999f,
                                                                         0.001f);
  return (int)cudaGetLastError();
}

int probe_ex2_run(float* out, int blocks, int threads, int iters, void* stream) {
  probe_ex2<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters, 0.5f);
  return (int)cudaGetLastError();
}

// cols: 4 (the dense kernel's 8 x 4 tile) or 8.
int probe_outer_run(int cols, float* out, int blocks, int threads, int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols == 8)
    probe_outer<8, 8><<<blocks, threads, 0, s>>>(out, iters);
  else
    probe_outer<8, 4><<<blocks, threads, 0, s>>>(out, iters);
  return (int)cudaGetLastError();
}

// K rows of row_bytes (a multiple of 16) in, n_out floats (a multiple of
// 4 * row_bytes / 16) out.
int probe_stream_run(const void* in, int K, long long row_bytes, void* out, long long n_out,
                     void* stream) {
  const long long cols = row_bytes / 16;
  if (K < 1 || cols < 1 || row_bytes % 16 != 0 || n_out % (4 * cols) != 0)
    return (int)cudaErrorInvalidValue;
  long long blocks = (cols + 255) / 256;
  probe_stream<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), K, cols, static_cast<float4*>(out), (int)(n_out / 4 / cols));
  return (int)cudaGetLastError();
}

}  // extern "C"
