// ssm_scan for Hopper (sm_90a): the Mamba-1 selective scan
//
//     h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t      h: (D, N) per batch row
//     y_t = h_t . C_t
//
// over dt, x (B, T, D) and Bm, Cm (B, T, N), fp32 or bf16 (all four in one
// dtype); A (D, N) and h0 (B, D, N) fp32. y (B, T, D) is written in x's dtype
// and the final state h_T (B, D, N) in fp32. The D skip term and the gate
// stay outside, in mamba_apply, as in the reference. dt, x, Bm and Cm each
// have their own (batch, time) strides in elements and a contiguous last
// axis, so the time slices of a chunked scan and the column slices of the
// projection come in without a copy.
//
// Replaces repro/kernels/ssm_scan.py::ssm_scan (the Pallas _ssm_kernel).
// That kernel tiles D by block_d across the grid and keeps a (block_d, N)
// state resident in VMEM while a loop walks T. Here the channels, which are
// independent, are spread one to a thread: thread (b, d) keeps its N-long
// state in registers (N rounded up to NS = 4, 8 or 16, a template parameter;
// the padded entries stay 0) and walks T. A block of 128 threads covers 128
// channels of one batch row, and the last block of a row masks the ragged
// edge of D itself (the Pallas kernel asserts D % block_d == 0). For each run
// of kTT = 16 time steps the block stages B_t and C_t in shared memory (they
// are shared by all channels) and each thread first issues its 16 loads of
// dt and of x, coalesced across the channels of the block, so that their
// latency overlaps, then runs the 16 steps.
//
// What bounds it: at the Jamba prefill shape (B = 4, T = 2048, D = 8192,
// N = 16) dt, x and y are 805 MB in fp32 (B and C 1 MB), 0.24 ms at 3.35 TB/s,
// and the B * T * D * N = 1.07 G exponentials take about 0.26 ms on the
// special-function units (16 a clock per SM, 132 SMs, 1.98 GHz), so the
// bound is the exponentials, 0.26 ms. Each exponential is one ex2 of
// dt * (A log2 e), A log2 e formed once per channel. The sequential walk over
// T with B * D = 32,768 threads (about 8 warps an SM) leaves little to hide
// each step's latency with: on an H100 SXM at 700 W the kernel takes 0.86 ms
// at that shape, 30% of the bound (PERF.md keeps the numbers).
//
// The C entry points return cudaGetLastError() after the launch; the caller
// raises on a non-zero code. They launch on the stream they are given,
// allocate nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTT = 16;
constexpr int kMaxN = 16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Args {
  int T, D, N;
  long long dt_b, dt_t, x_b, x_t, B_b, B_t, C_b, C_t;   // strides in elements
};

template <typename T, int NS>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ dt, const T* __restrict__ Bm, const T* __restrict__ Cm,
                const T* __restrict__ x, const float* __restrict__ A,
                const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_out,
                Args a) {
  __shared__ float sB[kTT][NS];
  __shared__ float sC[kTT][NS];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < a.D;
  const long long hrow = ((long long)b * a.D + d) * a.N;

  float a2[NS], h[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const bool ok = live && i < a.N;
    a2[i] = ok ? A[(long long)d * a.N + i] * kLog2e : 0.f;
    h[i] = ok ? h0[hrow + i] : 0.f;
  }
  const T* dtb = dt + b * a.dt_b + d;
  const T* xb = x + b * a.x_b + d;
  const T* Bb = Bm + b * a.B_b;
  const T* Cb = Cm + b * a.C_b;
  T* yb = y + (long long)b * a.T * a.D + d;

  for (int t0 = 0; t0 < a.T; t0 += kTT) {
    const int n_t = min(kTT, a.T - t0);
    __syncthreads();   // the previous run's B_t, C_t are no longer read
    for (int e = threadIdx.x; e < kTT * NS; e += kThreads) {
      const int tt = e / NS, i = e % NS;
      const bool ok = tt < n_t && i < a.N;
      sB[tt][i] = ok ? to_f32(Bb[(t0 + tt) * a.B_t + i]) : 0.f;
      sC[tt][i] = ok ? to_f32(Cb[(t0 + tt) * a.C_t + i]) : 0.f;
    }
    float dtr[kTT], xr[kTT];
#pragma unroll
    for (int tt = 0; tt < kTT; ++tt) {
      const bool ok = live && tt < n_t;
      dtr[tt] = ok ? to_f32(dtb[(t0 + tt) * a.dt_t]) : 0.f;
      xr[tt] = ok ? to_f32(xb[(t0 + tt) * a.x_t]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < kTT; ++tt) {
      if (tt < n_t) {
        const float dtx = dtr[tt] * xr[tt];
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          h[i] = fmaf(exp2f(dtr[tt] * a2[i]), h[i], dtx * sB[tt][i]);
          acc = fmaf(h[i], sC[tt][i], acc);
        }
        if (live) store(yb + (long long)(t0 + tt) * a.D, acc);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (i < a.N) h_out[hrow + i] = h[i];
  }
}

template <typename T, int NS>
int launch_ns(const T* dt, const T* Bm, const T* Cm, const T* x, const float* A,
              const float* h0, T* y, float* h_out, int B, const Args& a, cudaStream_t s) {
  const dim3 grid((a.D + kThreads - 1) / kThreads, B);
  ssm_scan_kernel<T, NS><<<grid, kThreads, 0, s>>>(dt, Bm, Cm, x, A, h0, y, h_out, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* dt, const void* Bm, const void* Cm, const void* x, const void* A,
           const void* h0, void* y, void* h_out, int B, int T_, int D, int N,
           const long long* st, void* stream) {
  if (B < 1 || B > 65535 || T_ < 1 || D < 1 || N < 1 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.T = T_;
  a.D = D;
  a.N = N;
  a.dt_b = st[0];
  a.dt_t = st[1];
  a.x_b = st[2];
  a.x_t = st[3];
  a.B_b = st[4];
  a.B_t = st[5];
  a.C_b = st[6];
  a.C_t = st[7];
  const T* dtt = static_cast<const T*>(dt);
  const T* Bt = static_cast<const T*>(Bm);
  const T* Ct = static_cast<const T*>(Cm);
  const T* xt = static_cast<const T*>(x);
  const float* At = static_cast<const float*>(A);
  const float* h0t = static_cast<const float*>(h0);
  T* yt = static_cast<T*>(y);
  float* ht = static_cast<float*>(h_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 4) return launch_ns<T, 4>(dtt, Bt, Ct, xt, At, h0t, yt, ht, B, a, s);
  if (N <= 8) return launch_ns<T, 8>(dtt, Bt, Ct, xt, At, h0t, yt, ht, B, a, s);
  return launch_ns<T, 16>(dtt, Bt, Ct, xt, At, h0t, yt, ht, B, a, s);
}

}  // namespace

extern "C" {

// strides: 8 values in elements, (batch, time) of dt, x, Bm, Cm.
int ssm_scan_f32(const void* dt, const void* Bm, const void* Cm, const void* x, const void* A,
                 const void* h0, void* y, void* h_out, int B, int T, int D, int N,
                 const long long* strides, void* stream) {
  return launch<float>(dt, Bm, Cm, x, A, h0, y, h_out, B, T, D, N, strides, stream);
}

int ssm_scan_bf16(const void* dt, const void* Bm, const void* Cm, const void* x, const void* A,
                  const void* h0, void* y, void* h_out, int B, int T, int D, int N,
                  const long long* strides, void* stream) {
  return launch<__nv_bfloat16>(dt, Bm, Cm, x, A, h0, y, h_out, B, T, D, N, strides, stream);
}

const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
