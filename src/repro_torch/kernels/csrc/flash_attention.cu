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
// so one block owns one (b, h) and one tile of queries, and a loop inside the
// block walks the key tiles of 64. Masked scores take the reference's finite
// sentinel -1e30: a tile that is masked throughout for a row gives exp(0) = 1
// terms, and the first real key's corr = exp(-1e30 - m) = 0 wipes them, where
// -INFINITY would give exp(-inf + inf) = NaN. The causal loop stops at the
// query tile's last row and the window loop starts at its first visible key,
// so skipped tiles are the ones every row of the tile masks. (A row that sees
// no key at all, which only a window with Sq > Sk can make, comes out 0.)
// The grid walks the query tiles longest first (the causal loop is longest
// for the last tile). Keys past Sk are staged as zeros, so that a masked V
// row never brings a NaN into the sum.
//
// What bounds it: the unmasked (query, key) pairs' 4 * D flops on the bf16
// tensor cores. At the prefill shapes (B = 4, S = 2048, causal) Jamba's
// H = 32, D = 128 is 137 GFLOP and Gemma-2B's H = 8, D = 256 69 GFLOP: 0.139
// and 0.070 ms at 989 TFLOP/s; the bytes (q, k, v read once, GQA in place, o
// written once) take 0.05 and 0.03 ms at 3.35 TB/s. Gemma-2B's training
// forward (B = 2) is half the prefill: 0.035 ms.
//
// Two kernels, one route each; ops-level Python (flash_attention.py::_route)
// picks the route by dtype, D and alignment:
//
// flash_fwd_mma_kernel<D>: bf16 q, k, v with D in {64, 128, 192, 256}, every row
// on a 16-byte boundary (pointers 16-byte aligned, strides multiples of 8
// elements). It is the route of every prefill and training forward of the
// archs the port serves and trains. Built for the tensor cores, against the
// scalar kernel's three limits:
//   - both products run on mma.sync.m16n8k16 (bf16 in, fp32 sums), where the
//     scalar kernel runs fp32 FMAs at 67 TFLOP/s peak;
//   - fragments come from ldmatrix, four 8 x 8 tiles an instruction, where
//     the scalar kernel ran one shared-memory load for every two FMAs;
//     shared-memory rows are padded by 16 bytes, so the eight rows an
//     ldmatrix phase reads fall in eight different 16-byte bank groups;
//   - K and V tiles are copied by cp.async (16 bytes a thread) into a
//     two-stage ring: tile t + 1 is in flight while tile t is computed,
//     where the scalar kernel's plain loads overlapped nothing.
// Each warp owns 16 query rows; a block holds 4 warps (64 rows). K and V
// tiles are 64 keys at D = 64 and 128, and 32 keys at D = 192 and 256, so
// that two blocks fit an SM there too. Q is staged once; its A fragments
// are read by ldmatrix once and held in registers at D <= 128, and re-read
// from shared memory at each 16-wide slice of D at D = 192 and 256, where
// the 96 and 128 accumulator registers need the room. D = 192 is MLA's
// prefill (DeepSeek: qk_nope 128 + qk_rope 64, V zero-padded to 192): a row
// is 24 chunks of 16 bytes and 12 k-steps of 16, and no loop assumes a
// power of two. Shared memory, bf16 rows of D + 8: Q, two K and two V
// stages, 46,080 / 87,040 / 76,800 / 101,376 bytes at D = 64 / 128 / 192 /
// 256 (of the 227 KB a block may use). The occupancy query gives 3 / 2 /
// 2 / 2 blocks an SM (PERF.md keeps the registers ptxas reports).
//   S = Q K^T: fp32 sums of bf16 products; scale * log2(e) is folded into the
//     scores so the softmax takes 2^x (ex2.approx on the special-function
//     unit). Masks are applied in fragment coordinates, and only on the
//     tiles that need them (the diagonal, the window's first tiles, the Sk
//     edge); a warp skips a causal tile that lies wholly above its rows.
//   Online softmax in registers: each thread holds two rows (g, g + 8) of
//     the warp's 16; the row max is taken over the 4-lane quad that shares a
//     row (__shfl_xor_sync 1, 2), l keeps the thread's fp32 partial sums of
//     p and the quad adds them at the end.
//   O += P V: S's accumulator fragments are P's A fragments (mma_bf16.cuh),
//     so P never goes through shared memory; V's B fragments come from
//     ldmatrix.trans of the row-major tile.
//   Why P is split: P fed to the product once rounded to bf16 (2^-9 relative
//     error on every weight) misses the phase-3 allowance (one bf16 ulp of
//     the fp32 result plus 1e-5 max|v|) by up to 30x at S = 2047, and TF32
//     by up to 10x; the reference keeps P in fp32. So p = hi + lo with
//     hi = bf16(p), lo = bf16(p - hi), and two mma.sync run per fragment
//     pair into one fp32 accumulator: p is carried to about 2^-16, and the
//     result meets the allowance as the fp32 P does. It executes 6 * D flops
//     a pair where 4 * D are counted (the bound counts 4 * D).
//   Epilogue: o / max(l, 1e-30), rounded once to bf16, staged through the
//     warp's own Q rows and stored in 16-byte chunks; lse (natural log) when
//     asked, by the same arithmetic whether or not it is asked.
// Not done here (ROADMAP): wgmma with TMA and warp specialisation, and
// packing the G query heads of an MQA group into one block's rows.
//
// flash_fwd_kernel<T, NJ>: everything else (fp32 at any D, bf16 at other D or
// on unaligned views), 256 threads a block, tiles of kBQ = 64 queries by
// kBK = 64 keys: the block stages Q (scaled, fp32) once, then for each key
// tile stages K and V in their own dtype in shared memory, and
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
// takes 214,528 bytes of shared memory (one block an SM). Its fp32 path is
// what the fp32 card-vs-CPU checks take: no bf16 or TF32 tensor-core path
// meets their 1e-5. On an H100 SXM at 700 W it took 8.1 ms at the Jamba
// prefill shape and 6.2 ms at Gemma-2B's in bf16, 1-2% of the bound (PERF.md
// keeps both routes' times).
//
// The C entry points return cudaGetLastError() after the launch (or the error
// of raising the shared-memory limit); the caller raises on a non-zero code.
// They launch on the stream they are given, allocate nothing and do not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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
  float scale;        // 1/sqrt(D): the scalar kernel's
  float scale_log2;   // scale * log2(e): the tensor-core kernel's, for exp2f
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

// ---------------------------------------------------------------------------
// The tensor-core route: bf16, D in {64, 128, 192, 256}, 16-byte aligned rows.

using bf16 = __nv_bfloat16;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Mma {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;         // query rows a block, 16 a warp
  static constexpr int kLd = D + 8;               // row pitch in elements: 16 bytes of padding
  static constexpr int kChunks = D / 8;           // 16-byte chunks a row
  // keys a tile: 32 at D = 192 and 256, so that two blocks fit an SM
  static constexpr int kBK = D > 128 ? 32 : 64;
  static constexpr int kStage = kBK * kLd;        // elements of one K or V stage
  static constexpr size_t kSmem = (size_t)(kBQ + 4 * kBK) * kLd * sizeof(bf16);   // Q, K x 2, V x 2
  // Q's A fragments held in registers for the whole loop; at D > 128 the
  // accumulator needs the room, and they are re-read from shared memory
  static constexpr bool kQInRegs = D <= 128;
};

template <int D>
__global__ void __launch_bounds__(Mma<D>::kThreads, 1)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     Args a) {
  using C = Mma<D>;
  using namespace mma_bf16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + C::kBQ * C::kLd;
  bf16* sV = sK + 2 * C::kStage;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::kBQ;   // longest causal tiles first
  const int wq0 = q0 + 16 * warp;                          // the warp's first row
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H, kvh = h / a.G;
  const bf16* qb = q + b * a.q.b + h * a.q.h;
  const bf16* kb = k + b * a.k.b + kvh * a.k.h;
  const bf16* vb = v + b * a.v.b + kvh * a.v.h;

  // Q once; rows past Sq as zeros (their outputs are not stored)
  for (int e = tid; e < C::kBQ * C::kChunks; e += C::kThreads) {
    const int r = e / C::kChunks, c = e % C::kChunks;
    const bool ok = q0 + r < a.Sq;
    cp_async_16(sQ + r * C::kLd + c * 8, qb + (ok ? q0 + r : 0) * a.q.s + c * 8, ok);
  }
  // K and V tile kt into ring stage st; keys past Sk as zeros
  auto load_kv = [&](int st, int kt) {
    bf16* dK = sK + st * C::kStage;
    bf16* dV = sV + st * C::kStage;
    for (int e = tid; e < C::kBK * C::kChunks; e += C::kThreads) {
      const int r = e / C::kChunks, c = e % C::kChunks;
      const int kpos = kt * C::kBK + r;
      const bool ok = kpos < a.Sk;
      const long long row = ok ? kpos : 0;
      cp_async_16(dK + r * C::kLd + c * 8, kb + row * a.k.s + c * 8, ok);
      cp_async_16(dV + r * C::kLd + c * 8, vb + row * a.v.s + c * 8, ok);
    }
  };

  const int last_q = min(q0 + C::kBQ, a.Sq) - 1;
  const int n_kt = (a.Sk + C::kBK - 1) / C::kBK;
  const int kt_end = a.causal ? min(n_kt, last_q / C::kBK + 1) : n_kt;
  const int kt_begin = a.window ? max(0, q0 - a.window + 1) / C::kBK : 0;
  cp_async_commit();   // Q
  if (kt_begin < kt_end) load_kv(0, kt_begin);
  cp_async_commit();   // the first tile

  // lane offsets of the ldmatrix row addresses (see mma_bf16.cuh): Q's A
  // fragment (rows, then the right 8 columns), two K key groups' B fragments
  // (8 keys x 16 of D each), two 8-column groups of V (16 keys each, .trans)
  const int qa_row = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8, qa_col = (lane >> 4) * 8;
  const int kf_row = (lane & 7) + (lane >> 4) * 8, kf_col = ((lane >> 3) & 1) * 8;
  const int vf_row = (lane & 7) + ((lane >> 3) & 1) * 8, vf_col = (lane >> 4) * 8;
  const bf16* qa = sQ + qa_row * C::kLd + qa_col;

  cp_async_wait<1>();   // Q has landed
  __syncthreads();
  uint32_t qreg[C::kQInRegs ? D / 16 : 1][4];
  if constexpr (C::kQInRegs) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) ldmatrix_x4(qreg[ks], qa + ks * 16);
  }

  float acc[D / 8][4];   // O: rows g, g + 8 by columns 8n + 2t, 8n + 2t + 1
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  // m in log2 units of the scaled scores; l the thread's partial sums
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      load_kv(st ^ 1, kt + 1);   // in flight while this tile is computed
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kt * C::kBK;
    // a warp whose rows are all past Sq, or a causal tile wholly above the
    // warp's rows (it would add exp(-1e30 - m) = 0), is skipped
    if (wq0 < a.Sq && !(a.causal && k0 > wq0 + 15)) {
      const bf16* tK = sK + st * C::kStage;
      const bf16* tV = sV + st * C::kStage;

      // S = Q K^T over D, 16 at a time: key groups of 8
      float s[C::kBK / 8][4];
#pragma unroll
      for (int j = 0; j < C::kBK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t qs[4];
        if constexpr (!C::kQInRegs) ldmatrix_x4(qs, qa + ks * 16);
        const uint32_t(&qf)[4] = C::kQInRegs ? qreg[C::kQInRegs ? ks : 0] : qs;
#pragma unroll
        for (int np = 0; np < C::kBK / 16; ++np) {
          uint32_t kf[4];
          ldmatrix_x4(kf, tK + (np * 16 + kf_row) * C::kLd + ks * 16 + kf_col);
          mma_16816(s[2 * np], qf, kf[0], kf[1]);
          mma_16816(s[2 * np + 1], qf, kf[2], kf[3]);
        }
      }

      // scale into log2 units; mask the diagonal, the window's edge, the Sk edge
      const bool masked = (a.causal && k0 + C::kBK - 1 > wq0) ||
                          (a.window && k0 < wq0 + 16 - a.window) || k0 + C::kBK > a.Sk;
#pragma unroll
      for (int j = 0; j < C::kBK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[j][c] * a.scale_log2;
          if (masked) {
            const int qpos = wq0 + g + (c >> 1) * 8;
            const int kpos = k0 + 8 * j + 2 * t + (c & 1);
            bool ok = kpos < a.Sk;
            if (a.causal) ok = ok && qpos >= kpos;
            if (a.window) ok = ok && qpos - kpos < a.window;
            x = ok ? x : kNegInf;
          }
          s[j][c] = x;
        }

      // online softmax: rows g (c = 0, 1) and g + 8 (c = 2, 3), max over the quad
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int j = 0; j < C::kBK / 8; ++j) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      const float corr_lo = ex2(m_lo - mn_lo), corr_hi = ex2(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int j = 0; j < C::kBK / 8; ++j) {
        s[j][0] = ex2(s[j][0] - mn_lo);
        s[j][1] = ex2(s[j][1] - mn_lo);
        s[j][2] = ex2(s[j][2] - mn_hi);
        s[j][3] = ex2(s[j][3] - mn_hi);
        sum_lo += s[j][0] + s[j][1];
        sum_hi += s[j][2] + s[j][3];
      }
      l_lo = l_lo * corr_lo + sum_lo;
      l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= corr_lo;
        acc[n][1] *= corr_lo;
        acc[n][2] *= corr_hi;
        acc[n][3] *= corr_hi;
      }

      // O += P V, 16 keys at a time; P = hi + lo, two products each
#pragma unroll
      for (int kk = 0; kk < C::kBK / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, tV + (kk * 16 + vf_row) * C::kLd + nd * 16 + vf_col);
          mma_16816(acc[2 * nd], ph, vf[0], vf[1]);
          mma_16816(acc[2 * nd + 1], ph, vf[2], vf[3]);
          mma_16816(acc[2 * nd], pl, vf[0], vf[1]);
          mma_16816(acc[2 * nd + 1], pl, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();   // this stage is refilled by the next iteration
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: the quad's sums of l; o = acc / l rounded once to bf16, staged
  // in the warp's own Q rows, stored in 16-byte chunks
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float d_lo = fmaxf(l_lo, 1e-30f), d_hi = fmaxf(l_hi, 1e-30f);
  bf16* sO = sQ + 16 * warp * C::kLd;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(sO + g * C::kLd + 8 * n + 2 * t) =
        __floats2bfloat162_rn(acc[n][0] / d_lo, acc[n][1] / d_lo);
    *reinterpret_cast<__nv_bfloat162*>(sO + (g + 8) * C::kLd + 8 * n + 2 * t) =
        __floats2bfloat162_rn(acc[n][2] / d_hi, acc[n][3] / d_hi);
  }
  __syncwarp();
  bf16* ob = o + b * a.o.b + h * a.o.h;
  for (int e = lane; e < 16 * C::kChunks; e += 32) {
    const int r = e / C::kChunks, c = e % C::kChunks;
    if (wq0 + r < a.Sq)
      *reinterpret_cast<uint4*>(ob + (wq0 + r) * a.o.s + c * 8) =
          *reinterpret_cast<const uint4*>(sO + r * C::kLd + c * 8);
  }
  if (lse != nullptr && t == 0) {
    if (wq0 + g < a.Sq)
      lse[((long long)b * a.Sq + wq0 + g) * a.H + h] = m_lo * kLn2 + logf(d_lo);
    if (wq0 + g + 8 < a.Sq)
      lse[((long long)b * a.Sq + wq0 + g + 8) * a.H + h] = m_hi * kLn2 + logf(d_hi);
  }
}

template <int D>
int launch_mma_d(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int B,
                 const Args& a, cudaStream_t s) {
  using C = Mma<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Sq + C::kBQ - 1) / C::kBQ, B * a.H);
  flash_fwd_mma_kernel<D><<<grid, C::kThreads, C::kSmem, s>>>(q, k, v, o, lse, a);
  return (int)cudaGetLastError();
}

template <int D>
int mma_occupancy() {
  using C = Mma<D>;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (e != cudaSuccess) return -(int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_fwd_mma_kernel<D>,
                                                    C::kThreads, C::kSmem);
  return e == cudaSuccess ? blocks : -(int)e;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The shape checks both routes share; fills a, or returns an error code.
int make_args(Args& a, int B, int H, int K, int Sq, int Sk, int D, const long long* st,
              int causal, int window) {
  if (B < 1 || H < 1 || K < 1 || H % K || Sq < 1 || Sk < 1 || D < 1 || D > kMaxD ||
      (long long)B * H > 65535 || window < 0)
    return (int)cudaErrorInvalidValue;
  a.H = H;
  a.G = H / K;
  a.Sq = Sq;
  a.Sk = Sk;
  a.D = D;
  a.causal = causal;
  a.window = window;
  a.scale = (float)(1.0 / sqrt((double)D));
  a.scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  a.q = {st[0], st[1], st[2]};
  a.k = {st[3], st[4], st[5]};
  a.v = {st[6], st[7], st[8]};
  a.o = {st[9], st[10], st[11]};
  return 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int K, int Sq, int Sk, int D, const long long* st, int causal, int window,
           void* stream) {
  Args a;
  const int rc = make_args(a, B, H, K, Sq, Sk, D, st, causal, window);
  if (rc) return rc;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch_nj<T, 4>(qt, kt, vt, ot, lse, B, a, s);
  if (D <= 128) return launch_nj<T, 8>(qt, kt, vt, ot, lse, B, a, s);
  return launch_nj<T, 16>(qt, kt, vt, ot, lse, B, a, s);
}

int launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int K, int Sq, int Sk, int D, const long long* st, int causal, int window,
               void* stream) {
  Args a;
  const int rc = make_args(a, B, H, K, Sq, Sk, D, st, causal, window);
  if (rc) return rc;
  if (D != 64 && D != 128 && D != 192 && D != 256) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8) return (int)cudaErrorMisalignedAddress;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorMisalignedAddress;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  bf16* ot = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_mma_d<64>(qt, kt, vt, ot, lse, B, a, s);
  if (D == 128) return launch_mma_d<128>(qt, kt, vt, ot, lse, B, a, s);
  if (D == 192) return launch_mma_d<192>(qt, kt, vt, ot, lse, B, a, s);
  return launch_mma_d<256>(qt, kt, vt, ot, lse, B, a, s);
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

// The tensor-core route: bf16 q, k, v with D in {64, 128, 192, 256}, pointers
// 16-byte aligned and all 12 strides multiples of 8 elements (else
// cudaErrorMisalignedAddress, and nothing is launched).
int flash_attention_bf16_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                             int B, int H, int K, int Sq, int Sk, int D,
                             const long long* strides, int causal, int window, void* stream) {
  return launch_mma(q, k, v, o, lse, B, H, K, Sq, Sk, D, strides, causal, window, stream);
}

// The tensor-core kernel at head dim D: dynamic shared memory and threads a
// block, and the blocks an SM holds (the occupancy query; negative: an error).
long long flash_attention_mma_smem_bytes(int D) {
  switch (D) {
    case 64: return (long long)Mma<64>::kSmem;
    case 128: return (long long)Mma<128>::kSmem;
    case 192: return (long long)Mma<192>::kSmem;
    case 256: return (long long)Mma<256>::kSmem;
    default: return -1;
  }
}

int flash_attention_mma_threads(int D) {
  switch (D) {
    case 64: return Mma<64>::kThreads;
    case 128: return Mma<128>::kThreads;
    case 192: return Mma<192>::kThreads;
    case 256: return Mma<256>::kThreads;
    default: return -1;
  }
}

int flash_attention_mma_blocks_per_sm(int D) {
  switch (D) {
    case 64: return mma_occupancy<64>();
    case 128: return mma_occupancy<128>();
    case 192: return mma_occupancy<192>();
    case 256: return mma_occupancy<256>();
    default: return -1;
  }
}

// Dynamic shared memory a block takes at head dim D for elements of elem_bytes.
long long flash_attention_smem_bytes(int D, int elem_bytes) {
  return (long long)(elem_bytes == 2 ? layout<__nv_bfloat16>(D).bytes : layout<float>(D).bytes);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
