// flash_attention for Hopper (sm_90a): the forward online-softmax attention
// of prefill and of training
//
//     o[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, h / G, :] * scale) v[b, j, h / G, :]
//
// over q (B, Sq, H, D), k and v (B, Sk, K, D), H = K * G (GQA/MQA), fp32 or
// bf16, D <= 256, with the causal mask (positions from 0, as in prefill), a
// sliding window (key j visible to query i only when i - j < window) and the
// padded-key mask j < Sk. Scores, the softmax statistics m and l and the
// accumulator are fp32; the output is written in q's dtype. scale is
// 1/sqrt(D). On request (a non-null lse) the kernel also writes each row's
// lse = m + log(max(l, 1e-30)) of the scaled scores into a (B, Sq, H) fp32
// array, as the reference's _blocked_attention_fwd_impl defines it: the
// training forward keeps it for the backward. Each of q, k, v, o has its own
// (batch, sequence, head) strides in elements and a contiguous last axis, so
// the (BH, S, D) single-head layout of the reference kernel and the
// (B, S, H, D) model layout both come in without a copy, and a KV head is
// read in place by every query head of its group (no repeat).
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the Pallas
// _flash_kernel). That kernel walks the key blocks as the innermost grid axis
// and carries m, l and the accumulator in VMEM scratch from one grid step to
// the next. On Hopper blocks run in parallel and carry nothing between them,
// so one block owns one (b, h) and one tile of 64 queries, and a loop inside
// the block walks the key tiles, with m, l in shared memory and the
// accumulator in registers. Masked scores take the reference's finite
// sentinel -1e30: a tile that is masked throughout for a row gives exp(0) = 1
// terms, and the first real key's corr = exp(-1e30 - m) = 0 wipes them, where
// -INFINITY would give exp(-inf + inf) = NaN. The causal loop stops at the
// query tile's last row and the window loop starts at its first visible key,
// so skipped tiles are the ones every row of the tile masks. (A row that sees
// no key at all, which only a window with Sq > Sk can make, comes out 0.)
//
// The design, 256 threads a block, tiles of kBQ = 64 queries by kBK = 64
// keys: the block stages Q (scaled, fp32) once, then for each key tile stages
// K and V in their own dtype in shared memory (keys past Sk as zeros, so that
// a masked V row never brings a NaN into the sum), and
//   1. S = Q K^T: thread (ty, tx) of a 16 x 16 grid holds the 4 x 4 scores of
//      rows ty + 16i and keys tx + 16j, scalar fp32 FMAs over D; masks them;
//      writes them to shared memory;
//   2. softmax: warp w takes rows 8w .. 8w+7, each lane two keys; a shuffle
//      max and sum give m_new, p = exp(s - m_new), l = l * corr + sum(p);
//   3. O += P V: the thread's accumulator is rows ty + 16i by columns
//      tx + 16j of D, j < NJ (NJ = 4, 8 or 16 for D up to 64, 128 or 256),
//      rescaled by corr, then one FMA per (row, column) for each of the 64
//      keys.
// Shared-memory rows of Q and K are padded to an odd number of 4-byte words,
// so the 16 keys a warp reads at one depth fall in 16 banks. D = 256 in fp32
// takes 214,528 bytes of shared memory (one block an SM); the launch opts in
// above 48 KB. Query tiles are issued longest first (the causal loop is
// longest for the last tile).
//
// What bounds it: at the prefill shapes the 4 * Sq * Sk * D * B * H / 2
// causal flops (Jamba, B = 4, S = 2048, H = 32, D = 128: 137 GFLOP; Gemma-2B,
// H = 8, D = 256: 69 GFLOP) over the 989 TFLOP/s of bf16 tensor cores give
// 0.139 and 0.069 ms; the bytes (q, k, v read once, GQA in place, o written
// once) about 0.05 and 0.03 ms. So the bound is the tensor-core rate. This
// kernel runs on the fp32 FMA pipes instead (67 TFLOP/s peak), and its inner
// loops issue one shared-memory load for every two FMAs in step 1. On an H100
// SXM at 700 W it takes 8.1 ms at the Jamba shape and 6.2 ms at the Gemma-2B
// shape: 1.7% and 1.1% of the bound, about 17 TFLOP/s, 32-42x the time of
// PyTorch's scaled_dot_product_attention. mma.sync or wgmma on bf16 tiles, and
// TMA staging, are the work of a later change (PERF.md keeps the numbers).
//
// The C entry points return cudaGetLastError() after the launch (or the error
// of raising the shared-memory limit); the caller raises on a non-zero code.
// They launch on the stream they are given, allocate nothing and do not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kLdp = kBK + 1;
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Strides {
  long long b, s, h;
};

struct Args {
  int H, G, Sq, Sk, D, causal, window;
  float scale;
  Strides q, k, v, o;
};

// Row pitch, in elements of `bytes` each, of D values padded to an odd
// number of 4-byte words.
__host__ __device__ inline int padded_ld(int D, int bytes) {
  const int words = ((D * bytes + 3) / 4) | 1;
  return words * 4 / bytes;
}

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

struct Layout {
  int ldq, ldk;
  size_t k_off, v_off, p_off, stat_off, bytes;
};

template <typename T>
__host__ __device__ inline Layout layout(int D) {
  Layout L;
  L.ldq = padded_ld(D, 4);
  L.ldk = padded_ld(D, (int)sizeof(T));
  L.k_off = round16((size_t)kBQ * L.ldq * 4);
  L.v_off = L.k_off + round16((size_t)kBK * L.ldk * sizeof(T));
  L.p_off = L.v_off + round16((size_t)kBK * D * sizeof(T));
  L.stat_off = L.p_off + round16((size_t)kBQ * kLdp * 4);
  L.bytes = L.stat_off + 3 * kBQ * 4;
  return L;
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D;
  const Layout L = layout<T>(D);
  float* sQ = reinterpret_cast<float*>(smem);
  T* sK = reinterpret_cast<T*>(smem + L.k_off);
  T* sV = reinterpret_cast<T*>(smem + L.v_off);
  float* sP = reinterpret_cast<float*>(smem + L.p_off);
  float* sM = reinterpret_cast<float*>(smem + L.stat_off);
  float* sL = sM + kBQ;
  float* sC = sL + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H, kvh = h / a.G;
  const T* qb = q + b * a.q.b + h * a.q.h;
  const T* kb = k + b * a.k.b + kvh * a.k.h;
  const T* vb = v + b * a.v.b + kvh * a.v.h;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int qpos = q0 + r;
    sQ[r * L.ldq + d] = qpos < a.Sq ? to_f32(qb[qpos * a.q.s + d]) * a.scale : 0.f;
  }
  if (tid < kBQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int last_q = min(q0 + kBQ, a.Sq) - 1;
  const int n_kt = (a.Sk + kBK - 1) / kBK;
  const int kt_end = a.causal ? min(n_kt, last_q / kBK + 1) : n_kt;
  const int kt_begin = a.window ? max(0, q0 - a.window + 1) / kBK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's P and V are no longer read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const int kpos = k0 + r;
      const bool ok = kpos < a.Sk;
      sK[r * L.ldk + d] = ok ? kb[kpos * a.k.s + d] : zero<T>();
      sV[r * D + d] = ok ? vb[kpos * a.v.s + d] : zero<T>();
    }
    __syncthreads();

    // 1. scores of rows ty + 16i, keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty + 16 * i) * L.ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = to_f32(sK[(tx + 16 * j) * L.ldk + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        bool ok = kpos < a.Sk;
        if (a.causal) ok = ok && qpos >= kpos;
        if (a.window) ok = ok && qpos - kpos < a.window;
        sP[r * kLdp + c] = ok ? s[i][j] : kNegInf;
      }
    }
    __syncthreads();

    // 2. online softmax, one warp per 8 rows, two keys a lane
    for (int rr = 0; rr < kBQ / (kThreads / 32); ++rr) {
      const int r = warp * (kBQ / (kThreads / 32)) + rr;
      const float v0 = sP[r * kLdp + lane], v1 = sP[r * kLdp + lane + 32];
      float mx = fmaxf(v0, v1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(v0 - m_new), p1 = expf(v1 - m_new);
      sP[r * kLdp + lane] = p0;
      sP[r * kLdp + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
        sC[r] = corr;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = sC[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * kLdp + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        vv[j] = d < D ? to_f32(sV[c * D + d]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  T* ob = o + b * a.o.b + h * a.o.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
    if (qpos >= a.Sq) continue;
    const float l = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(ob + qpos * a.o.s + d, acc[i][j] / l);
    }
  }
  if (lse != nullptr && tid < kBQ && q0 + tid < a.Sq)
    lse[((long long)b * a.Sq + q0 + tid) * a.H + h] = sM[tid] + logf(fmaxf(sL[tid], 1e-30f));
}

template <typename T, int NJ>
int launch_nj(const T* q, const T* k, const T* v, T* o, float* lse, int B, const Args& a,
              cudaStream_t s) {
  const size_t smem = layout<T>(a.D).bytes;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, B * a.H);
  flash_fwd_kernel<T, NJ><<<grid, kThreads, smem, s>>>(q, k, v, o, lse, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int K, int Sq, int Sk, int D, const long long* st, int causal, int window,
           void* stream) {
  if (B < 1 || H < 1 || K < 1 || H % K || Sq < 1 || Sk < 1 || D < 1 || D > kMaxD ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.H = H;
  a.G = H / K;
  a.Sq = Sq;
  a.Sk = Sk;
  a.D = D;
  a.causal = causal;
  a.window = window;
  a.scale = (float)(1.0 / sqrt((double)D));
  a.q = {st[0], st[1], st[2]};
  a.k = {st[3], st[4], st[5]};
  a.v = {st[6], st[7], st[8]};
  a.o = {st[9], st[10], st[11]};
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch_nj<T, 4>(qt, kt, vt, ot, lse, B, a, s);
  if (D <= 128) return launch_nj<T, 8>(qt, kt, vt, ot, lse, B, a, s);
  return launch_nj<T, 16>(qt, kt, vt, ot, lse, B, a, s);
}

}  // namespace

extern "C" {

// strides: 12 values in elements, (batch, sequence, head) of q, k, v, o.
// lse: a contiguous (B, Sq, H) fp32 output of m + log(l) over the scaled
// scores (the training forward keeps it for the backward), or null (prefill).
int flash_attention_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int H, int K, int Sq, int Sk, int D, const long long* strides,
                        int causal, int window, void* stream) {
  return launch<float>(q, k, v, o, lse, B, H, K, Sq, Sk, D, strides, causal, window, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                         int B, int H, int K, int Sq, int Sk, int D, const long long* strides,
                         int causal, int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, lse, B, H, K, Sq, Sk, D, strides, causal, window,
                               stream);
}

// Dynamic shared memory a block takes at head dim D for elements of elem_bytes.
long long flash_attention_smem_bytes(int D, int elem_bytes) {
  return (long long)(elem_bytes == 2 ? layout<__nv_bfloat16>(D).bytes : layout<float>(D).bytes);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
