// fused_cross_entropy for Hopper (sm_90a): per-token cross-entropy over a
// large vocabulary without materializing the logits
//
//     logits[t, v] = sum_k hidden[t, k] * head[k, v]          (fp32)
//     lse[t]  = log sum_v exp(logits[t, v])
//     loss[t] = lse[t] - logits[t, labels[t]]
//
// over hidden (T, d), head (d, V) and int32 labels (T,), fp32 or bf16 in,
// fp32 out. hidden has a row stride and a contiguous last axis; head is read
// through both of its strides, so the tied LM head (the (V, d) embedding
// table viewed as (d, V), strides (1, d)) comes in without a copy. Logits are
// accumulated in fp32 from fp32-widened inputs, as the Pallas _ce_kernel does
// (h.astype(f32), w.astype(f32)); bf16 products are exact in fp32, so a
// tensor-core version would compute the same function. Columns v >= V take the
// reference's finite sentinel -1e30 (with -INFINITY a masked tile would give
// exp(-inf + inf) = NaN); a label outside [0, V) picks no real column, and its
// loss is lse + 1e30, as in the reference.
//
// Replaces repro/kernels/ce_loss.py::fused_cross_entropy (the Pallas
// _ce_kernel). That kernel walks a (token block, vocab block) grid with the
// vocab axis innermost and carries the online max m, sum-exp l and the gold
// logit in VMEM scratch from one vocab step to the next. Blocks on Hopper run
// in parallel and carry nothing, and 4096 / 128 = 32 token tiles would leave
// most of the 132 SMs idle. So the vocab is split across blocks as well:
//
//   1. ce_partial_kernel: block (token tile i, vocab split s) loops over the
//      split's vocab tiles, carrying m, l and gold per row in registers, and
//      writes the split's partial (m, l, gold) for its 128 tokens;
//   2. ce_merge_kernel: one thread per token merges the splits,
//      m = max m_s, l = sum l_s exp(m_s - m), gold = max gold_s, and writes
//      lse = m + log(max(l, 1e-30)) and loss = lse - gold.
//
// The wrapper counts the two launches as one fused_cross_entropy launch. It
// picks the number of splits from the SMs and the blocks an SM holds
// (fused_cross_entropy_blocks_per_sm), so that the grid's waves end evenly.
//
// Tiles: 256 threads, 128 tokens x 128 vocab columns a tile, the depth d
// walked in chunks of 32. A chunk of hidden (128 x 32) and of head (32 x 128)
// is staged in shared memory as fp32, each with the depth index outermost and
// rows padded by 4 floats; thread (ty, tx) of a 16 x 16 grid holds the 8 x 8
// logits of rows {4ty..4ty+3, 64+4ty..} and columns {4tx..4tx+3, 64+4tx..},
// read as float4s (16 fp32 FMAs for each 16-byte shared-memory load). The row
// statistics need no shared memory: the 16 threads of a row are one
// half-warp, and shuffles reduce the tile's max and sum-exp over them.
// Ragged T and V are masked in the kernel; nothing is padded or copied.
//
// What bounds it: at the Gemma-2B training shape (T = 4096, d = 2048,
// V = 256,000, bf16) the product is 2 T d V = 4.29 TFLOP, 4.34 ms at the
// 989 TFLOP/s of the bf16 tensor cores; the bytes (head 1.05 GB once, hidden
// 16.8 MB) take 0.31 ms. So operations set the bound. This kernel runs on the
// fp32 FMA pipes (67 TFLOP/s peak, so 64 ms at best); mma.sync or wgmma on
// bf16 tiles, with TMA staging, is the work of a later change. PERF.md keeps
// its measured time beside that bound.
//
// The C entry points return cudaGetLastError() after the launches; the caller
// raises on a non-zero code. They launch on the stream they are given,
// allocate nothing (the caller passes the (3, splits, T) fp32 scratch) and do
// not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBT = 128;        // tokens a tile
constexpr int kBV = 128;        // vocab columns a tile
constexpr int kDK = 32;         // depth a staged chunk
constexpr int kThreads = 256;
constexpr int kLd = kBT + 4;    // padded row of a staged chunk (kBT == kBV)
constexpr int kMergeThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Args {
  int T, d, V, n_split, tiles_per_split;
  long long sh;       // hidden row stride (elements)
  long long sd, sv;   // head strides over d and V (elements)
};

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row (i < 4: 4 ty + i; else 64 + 4 ty + i - 4) of the tile; columns likewise with tx.
__device__ __forceinline__ int sub(int t, int i) { return i < 4 ? 4 * t + i : 60 + 4 * t + i; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_partial_kernel(const T* __restrict__ hidden, const T* __restrict__ head,
                  const int* __restrict__ labels, float* __restrict__ part, Args a) {
  __shared__ __align__(16) float sH[kDK][kLd];
  __shared__ __align__(16) float sW[kDK][kLd];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int t0 = blockIdx.x * kBT;
  const int split = blockIdx.y;
  const int n_vt = (a.V + kBV - 1) / kBV;
  const int vt_begin = split * a.tiles_per_split;
  const int vt_end = min(vt_begin + a.tiles_per_split, n_vt);

  int lbl[8];
  float m[8], l[8], g[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int tok = t0 + sub(ty, i);
    lbl[i] = tok < a.T ? labels[tok] : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
    g[i] = kNegInf;
  }

  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int v0 = vt * kBV;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < a.d; k0 += kDK) {
      __syncthreads();   // the previous chunk is no longer read
      for (int e = tid; e < kBT * kDK; e += kThreads) {
        const int row = e / kDK, kk = e % kDK;
        const int tok = t0 + row, k = k0 + kk;
        sH[kk][row] = (tok < a.T && k < a.d) ? to_f32(hidden[tok * a.sh + k]) : 0.f;
      }
      // neighbouring threads read neighbouring addresses of head, whichever
      // of its axes is the contiguous one
      if (a.sd == 1) {
        for (int e = tid; e < kBV * kDK; e += kThreads) {
          const int col = e / kDK, kk = e % kDK;
          const int v = v0 + col, k = k0 + kk;
          sW[kk][col] = (v < a.V && k < a.d) ? to_f32(head[k + v * a.sv]) : 0.f;
        }
      } else {
        for (int e = tid; e < kBV * kDK; e += kThreads) {
          const int kk = e / kBV, col = e % kBV;
          const int v = v0 + col, k = k0 + kk;
          sW[kk][col] = (v < a.V && k < a.d) ? to_f32(head[k * a.sd + v * a.sv]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kDK; ++kk) {
        const float4 h0 = *reinterpret_cast<const float4*>(&sH[kk][4 * ty]);
        const float4 h1 = *reinterpret_cast<const float4*>(&sH[kk][64 + 4 * ty]);
        const float4 w0 = *reinterpret_cast<const float4*>(&sW[kk][4 * tx]);
        const float4 w1 = *reinterpret_cast<const float4*>(&sW[kk][64 + 4 * tx]);
        const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(hv[i], wv[j], acc[i][j]);
      }
    }

    // online max, sum-exp and gold over this tile's columns
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int v = v0 + sub(tx, j);
        const float s = v < a.V ? acc[i][j] : kNegInf;
        acc[i][j] = s;
        mx = fmaxf(mx, s);
        if (v == lbl[i]) g[i] = fmaxf(g[i], s);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += expf(acc[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + half_warp_sum(sum);
      m[i] = m_new;
    }
  }

  const long long plane = (long long)a.n_split * a.T;
  float* pm = part;
  float* pl = part + plane;
  float* pg = part + 2 * plane;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float gold = half_warp_max(g[i]);
    const int tok = t0 + sub(ty, i);
    if (tx == 0 && tok < a.T) {
      const long long o = (long long)split * a.T + tok;
      pm[o] = m[i];
      pl[o] = l[i];
      pg[o] = gold;
    }
  }
}

__global__ void __launch_bounds__(kMergeThreads)
ce_merge_kernel(const float* __restrict__ part, float* __restrict__ loss,
                float* __restrict__ lse, int T, int n_split) {
  const int t = blockIdx.x * kMergeThreads + threadIdx.x;
  if (t >= T) return;
  const long long plane = (long long)n_split * T;
  float m = kNegInf, gold = kNegInf;
  for (int s = 0; s < n_split; ++s) {
    m = fmaxf(m, part[(long long)s * T + t]);
    gold = fmaxf(gold, part[2 * plane + (long long)s * T + t]);
  }
  float l = 0.f;
  for (int s = 0; s < n_split; ++s)
    l += part[plane + (long long)s * T + t] * expf(part[(long long)s * T + t] - m);
  const float v = m + logf(fmaxf(l, 1e-30f));
  lse[t] = v;
  loss[t] = v - gold;
}

template <typename T>
int launch(const void* hidden, const void* head, const int* labels, float* part, float* loss,
           float* lse, int n_tok, int d, int V, int n_split, int tiles_per_split,
           long long sh, long long sd, long long sv, void* stream) {
  const int n_vt = (V + kBV - 1) / kBV;
  if (n_tok < 1 || d < 1 || V < 1 || n_split < 1 || n_split > 65535 || tiles_per_split < 1 ||
      (long long)n_split * tiles_per_split < n_vt ||
      (long long)(n_split - 1) * tiles_per_split >= n_vt)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.T = n_tok;
  a.d = d;
  a.V = V;
  a.n_split = n_split;
  a.tiles_per_split = tiles_per_split;
  a.sh = sh;
  a.sd = sd;
  a.sv = sv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_tok + kBT - 1) / kBT, n_split);
  ce_partial_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(hidden),
                                                 static_cast<const T*>(head), labels, part, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ce_merge_kernel<<<(n_tok + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, s>>>(
      part, loss, lse, n_tok, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// scratch: (3, n_split, T) fp32; loss and lse: (T,) fp32.
int fused_cross_entropy_f32(const void* hidden, const void* head, const int* labels,
                            float* scratch, float* loss, float* lse, int T, int d, int V,
                            int n_split, int tiles_per_split, long long sh, long long sd,
                            long long sv, void* stream) {
  return launch<float>(hidden, head, labels, scratch, loss, lse, T, d, V, n_split,
                       tiles_per_split, sh, sd, sv, stream);
}

int fused_cross_entropy_bf16(const void* hidden, const void* head, const int* labels,
                             float* scratch, float* loss, float* lse, int T, int d, int V,
                             int n_split, int tiles_per_split, long long sh, long long sd,
                             long long sv, void* stream) {
  return launch<__nv_bfloat16>(hidden, head, labels, scratch, loss, lse, T, d, V, n_split,
                               tiles_per_split, sh, sd, sv, stream);
}

// How many ce_partial_kernel blocks one SM holds at once (the wrapper sizes
// its grid in whole waves of this times the SM count); 0 on error.
int fused_cross_entropy_blocks_per_sm(int bf16) {
  int n = 0;
  const cudaError_t e =
      bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, ce_partial_kernel<__nv_bfloat16>, kThreads, 0)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ce_partial_kernel<float>,
                                                           kThreads, 0);
  return e == cudaSuccess ? n : 0;
}

const char* fused_cross_entropy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
