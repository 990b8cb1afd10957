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
// (h.astype(f32), w.astype(f32)); bf16 products are exact in fp32, so the
// tensor-core route computes the same function. Columns v >= V take the
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
//   1. a partial kernel (ce_fwd_mma_kernel or ce_partial_kernel, below):
//      block (token tile i, vocab split s) loops over the split's vocab
//      tiles, carrying m, l and gold per row in registers, and writes the
//      split's partial (m, l, gold) for its 128 tokens;
//   2. ce_merge_kernel: one thread per token merges the splits,
//      m = max m_s, l = sum l_s exp(m_s - m), gold = max gold_s, and writes
//      lse = m + log(max(l, 1e-30)) and loss = lse - gold.
//
// The wrapper counts the two launches as one fused_cross_entropy launch. It
// picks the number of splits from the SMs and the blocks an SM holds (the
// occupancy query of the route's partial kernel), so that the grid's waves
// end evenly.
//
// What bounds it: at the Gemma-2B training shape (T = 4096, d = 2048,
// V = 256,000, bf16) the product is 2 T d V = 4.29 TFLOP, 4.34 ms at the
// 989 TFLOP/s of the bf16 tensor cores; the bytes (head 1.05 GB once, hidden
// 16.8 MB) take 0.31 ms. So operations set the bound.
//
// Two partial kernels, one route each; kernels/ce_loss.py::_route picks the
// route from the dtype, d, the strides and the pointers:
//
// ce_fwd_mma_kernel<kKMajor>: bf16 hidden and head, d a multiple of 8, every
// staged row on a 16-byte boundary (both pointers 16-byte aligned, hidden's
// row stride and the head's non-unit stride multiples of 8 elements). It is
// the route of every training step of the archs the port trains. The logits
// run on mma.sync.m16n8k16 (bf16 products, exact in fp32, summed in fp32).
//   Tiles: a block of 8 warps takes 128 tokens x 256 vocab columns; warp
//     (wm, wn) of a 2 x 4 grid owns a 64 x 64 sub-tile, 4 m16 x 8 n8
//     fragments, 128 fp32 accumulators a thread. d is walked in k-slices of
//     64.
//   Staging: the hidden rows and the head's rows of each k-slice go through
//     a 3-stage cp.async ring (16 bytes a thread a copy), 165,888 bytes of
//     dynamic shared memory, one block an SM. Rows are padded by 16 bytes,
//     so the eight 16-byte rows an ldmatrix phase reads fall in eight
//     different bank groups. Hidden is the row-major A operand (ldmatrix).
//     Two head layouts: the tied head (kKMajor) has each vocab column
//     contiguous over d, which is the "col" B operand: it is staged [v][k]
//     and read by ldmatrix; a (d, V) head with contiguous rows is staged
//     [k][v] and read by ldmatrix.trans. In that layout the last 8-column
//     chunk of a ragged V is staged element by element (cp.async copies
//     whole 16-byte chunks only).
//   The block's vocab tiles and their k-slices are one flat loop, so the
//     ring runs on from one vocab tile into the next without draining.
//   Epilogue in registers, once a tile's last k-slice is in: each thread
//     holds rows g and g + 8 of its four m16 fragments; a row's tile max is
//     taken over the quad that shares it (__shfl_xor_sync 1, 2), the thread
//     keeps its own partial sum-exp (the quad adds them at the end) and
//     picks the gold logit where the label lands in its columns. exp is
//     ex2.approx of (s - m) * log2(e), a relative error of about 2^-22 on
//     each term, far inside the 1e-5 * max(1, |lse|) the kernel is held to.
//     Each warp carries (m, l, gold) of its rows through all of the split's
//     vocab tiles; the four warps that share rows merge once, through
//     shared memory, when the split is done.
//
// ce_partial_kernel<T>: everything else (fp32; bf16 at d % 8 != 0 or on
// unaligned views), 256 threads, 128 tokens x 128 vocab columns a tile, the
// depth d walked in chunks of 32. A chunk of hidden (128 x 32) and of head
// (32 x 128) is staged in shared memory as fp32, each with the depth index
// outermost and rows padded by 4 floats; thread (ty, tx) of a 16 x 16 grid
// holds the 8 x 8 logits of rows {4ty..4ty+3, 64+4ty..} and columns
// {4tx..4tx+3, 64+4tx..}, read as float4s (16 fp32 FMAs for each 16-byte
// shared-memory load). The row statistics need no shared memory: the 16
// threads of a row are one half-warp, and shuffles reduce the tile's max and
// sum-exp over them. It runs on the fp32 FMA pipes (67 TFLOP/s peak, so
// 64 ms at best at the training shape); the fp32 card-vs-CPU checks take it,
// since no bf16 or TF32 tensor-core path meets their 1e-5.
//
// Ragged T and V are masked in all kernels here; nothing is padded or copied.
//
// ce_probs_mma_kernel<kKMajor>: the gradient's softmax, on the main loop of
// ce_fwd_mma_kernel (the same tiles, ring and fragments) with a second
// epilogue. One block a (token tile, vocab tile), no split and no merge: it
// recomputes the logit tile and writes
//     P[t, v] = bf16(g[t] (exp(S[t, v] - lse[t]) - [v == labels[t]]))
// into a (T, ldp) bf16 buffer, from the forward's lse and the upstream
// gradient g. ops.FusedCrossEntropy's backward multiplies it out with two
// cuBLAS products. The reference's gradient (XLA's autodiff of the bf16
// logits cast to fp32, repro/models/transformer.py::chunked_cross_entropy)
// rounds the same cotangent to bf16 before its two products. It is not a
// port of a Pallas kernel: the Pallas _ce_kernel has no backward. Here exp
// is ex2.approx of (s - lse) * log2(e), which stays exact where p is near 1
// and p - 1 cancels. Its bound at the training shape (4 chunks of 1,024
// tokens): the same 4.29 TFLOP as the forward, and 2.1 GB of P written.
//
// ce_probs_kernel<T>: the same P on the scalar route (fp32, and bf16 that the
// tensor-core route does not take), on ce_partial_kernel's main loop with a
// second epilogue, P in the inputs' dtype; one block a (token tile, vocab
// tile) of 128 x 128, exp by expf. The fp32 card-vs-CPU training checks take
// it.
//
// Not done here (ROADMAP): wgmma with TMA and warp specialisation.
//
// The C entry points return cudaGetLastError() after the launches (or the
// error of raising the shared-memory limit); the caller raises on a non-zero
// code. The tensor-core entries re-check the route's conditions and return
// cudaErrorInvalidValue, launching nothing, when they do not hold. All launch
// on the stream they are given, allocate nothing (the caller passes the
// (3, splits, T) fp32 scratch and the probabilities' buffer) and do not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The main loop both scalar kernels share: the fp32 logits of tokens
// [t0, t0 + 128) against vocab tiles [vt_begin, vt_end) of 128 columns, each
// tile's accumulators handed to epi(v0, acc) once its last depth chunk is in.
// acc[i][j] is the logit of row sub(ty, i) and column v0 + sub(tx, j).
template <typename T, class Epi>
__device__ __forceinline__ void scalar_tiles(const T* __restrict__ hidden,
                                             const T* __restrict__ head, const Args& a, int t0,
                                             int vt_begin, int vt_end, Epi&& epi) {
  __shared__ __align__(16) float sH[kDK][kLd];
  __shared__ __align__(16) float sW[kDK][kLd];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
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
    epi(v0, acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_partial_kernel(const T* __restrict__ hidden, const T* __restrict__ head,
                  const int* __restrict__ labels, float* __restrict__ part, Args a) {
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

  // online max, sum-exp and gold over each tile's columns
  scalar_tiles<T>(hidden, head, a, t0, vt_begin, vt_end, [&](int v0, float(&acc)[8][8]) {
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
  });

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

// The gradient's softmax on the scalar route: one block a (token tile, vocab
// tile), the logit tile recomputed and
//     P[t, v] = T(g[t] (exp(S[t, v] - lse[t]) - [v == labels[t]]))
// written into the (T, ldp) buffer, in the inputs' dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_probs_kernel(const T* __restrict__ hidden, const T* __restrict__ head,
                const int* __restrict__ labels, const float* __restrict__ lse,
                const float* __restrict__ gscale, T* __restrict__ probs, long long ldp, Args a) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int t0 = blockIdx.x * kBT;
  const int vt = blockIdx.y;

  int lbl[8];
  float shift[8], gs[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int tok = t0 + sub(ty, i);
    const bool ok = tok < a.T;
    lbl[i] = ok ? labels[tok] : -1;
    shift[i] = ok ? lse[tok] : 0.f;
    gs[i] = ok ? gscale[tok] : 0.f;
  }

  scalar_tiles<T>(hidden, head, a, t0, vt, vt + 1, [&](int v0, float(&acc)[8][8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int tok = t0 + sub(ty, i);
      if (tok >= a.T) continue;
      T* row = probs + (long long)tok * ldp;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int v = v0 + sub(tx, j);
        if (v < a.V)
          store(row + v, gs[i] * (expf(acc[i][j] - shift[i]) - (v == lbl[i] ? 1.f : 0.f)));
      }
    }
  });
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

// The split plan's own checks: every split has vocab tiles, together they
// cover the vocab's n_vt tiles.
bool bad_plan(int n_tok, int d, int V, int n_split, int tiles_per_split, int tile_v) {
  const int n_vt = (V + tile_v - 1) / tile_v;
  return n_tok < 1 || d < 1 || V < 1 || n_split < 1 || n_split > 65535 || tiles_per_split < 1 ||
         (long long)n_split * tiles_per_split < n_vt ||
         (long long)(n_split - 1) * tiles_per_split >= n_vt;
}

Args make_args(int n_tok, int d, int V, int n_split, int tiles_per_split, long long sh,
               long long sd, long long sv) {
  Args a;
  a.T = n_tok;
  a.d = d;
  a.V = V;
  a.n_split = n_split;
  a.tiles_per_split = tiles_per_split;
  a.sh = sh;
  a.sd = sd;
  a.sv = sv;
  return a;
}

int launch_merge(const float* part, float* loss, float* lse, int n_tok, int n_split,
                 cudaStream_t s) {
  ce_merge_kernel<<<(n_tok + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, s>>>(
      part, loss, lse, n_tok, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* hidden, const void* head, const int* labels, float* part, float* loss,
           float* lse, int n_tok, int d, int V, int n_split, int tiles_per_split,
           long long sh, long long sd, long long sv, void* stream) {
  if (bad_plan(n_tok, d, V, n_split, tiles_per_split, kBV)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(n_tok, d, V, n_split, tiles_per_split, sh, sd, sv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_tok + kBT - 1) / kBT, n_split);
  ce_partial_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(hidden),
                                                 static_cast<const T*>(head), labels, part, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_merge(part, loss, lse, n_tok, n_split, s);
}

template <typename T>
int launch_probs(const void* hidden, const void* head, const int* labels, const float* lse,
                 const float* g, void* probs, long long ldp, int n_tok, int d, int V,
                 long long sh, long long sd, long long sv, void* stream) {
  if (n_tok < 1 || d < 1 || V < 1 || ldp < V || (V + kBV - 1) / kBV > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(n_tok, d, V, 1, 1, sh, sd, sv);
  const dim3 grid((n_tok + kBT - 1) / kBT, (V + kBV - 1) / kBV);
  ce_probs_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(hidden), static_cast<const T*>(head), labels, lse, g,
      static_cast<T*>(probs), ldp, a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core route: bf16, d % 8 == 0, 16-byte aligned rows.

using bf16 = __nv_bfloat16;

namespace tc {
constexpr int kBT = 128;             // tokens a block tile
constexpr int kBV = 256;             // vocab columns a block tile
constexpr int kBK = 64;              // depth a k-slice
constexpr int kStages = 3;           // cp.async ring
constexpr int kWarpsV = 4;           // warps across the vocab tile (2 across the tokens)
constexpr int kWarps = 2 * kWarpsV;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 4;               // m16 fragments a warp: 64 token rows
constexpr int kNT = 8;               // n8 fragments a warp: 64 vocab columns
constexpr int kRows = 2 * kMT;       // rows a thread holds: g and g + 8 of each m16
constexpr int kLdK = kBK + 8;        // a [row][k] stage row: 72 elements, 144 bytes
constexpr int kLdV = kBV + 8;        // a [k][v] stage row: 264 elements, 528 bytes
constexpr int kHStage = kBT * kLdK;
constexpr int kWStage = kBV * kLdK > kBK * kLdV ? kBV * kLdK : kBK * kLdV;
constexpr int kStage = kHStage + kWStage;
constexpr size_t kSmem = (size_t)kStages * kStage * sizeof(bf16);
constexpr float kLog2e = 1.4426950408889634f;
static_assert(2 * kMT * 16 == kBT && kWarpsV * kNT * 8 == kBV, "warp grid covers the tile");
static_assert(3 * kWarpsV * kBT * sizeof(float) <= kSmem, "the row merge fits the ring");

// The main loop both tensor-core kernels share: the fp32 logits of tokens
// [t0, t0 + 128) against vocab tiles [vt_begin, vt_end) of 256 columns,
// each tile's accumulators handed to epi(vt, acc) once its last k-slice is
// in, then zeroed. acc[mi][nj] is the C fragment of rows 64 wm + 16 mi (+ g,
// + 8) and columns 256 vt + 64 wn + 8 nj (+ 2t, + 1) (mma_bf16.cuh).
// Returns with the ring drained and the block synchronised, so that the
// caller may reuse the shared memory.
template <bool kKMajor, class Epi>
__device__ __forceinline__ void mma_tiles(const bf16* __restrict__ hidden,
                                          const bf16* __restrict__ head, const Args& a,
                                          int t0, int vt_begin, int vt_end, bf16* smem,
                                          Epi&& epi) {
  using namespace mma_bf16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsV, wn = warp % kWarpsV;
  const int n_k = (a.d + kBK - 1) / kBK;
  const int n_iter = (vt_end - vt_begin) * n_k;

  // k-slice it of the flat loop into ring stage st; rows past T or V and
  // depth past d as zeros
  auto load = [&](int st, int it) {
    bf16* sH = smem + st * kStage;
    bf16* sW = sH + kHStage;
    const int k0 = (it % n_k) * kBK;
    const int v0 = (vt_begin + it / n_k) * kBV;
    for (int e = tid; e < kBT * (kBK / 8); e += kThreads) {
      const int r = e / (kBK / 8), c = e % (kBK / 8);
      const int tok = t0 + r, k = k0 + 8 * c;
      const bool ok = tok < a.T && k < a.d;
      cp_async_16(sH + r * kLdK + 8 * c, ok ? hidden + (long long)tok * a.sh + k : hidden, ok);
    }
    if constexpr (kKMajor) {
      for (int e = tid; e < kBV * (kBK / 8); e += kThreads) {
        const int r = e / (kBK / 8), c = e % (kBK / 8);
        const int v = v0 + r, k = k0 + 8 * c;
        const bool ok = v < a.V && k < a.d;
        cp_async_16(sW + r * kLdK + 8 * c, ok ? head + (long long)v * a.sv + k : head, ok);
      }
    } else {
      for (int e = tid; e < kBK * (kBV / 8); e += kThreads) {
        const int r = e / (kBV / 8), c = e % (kBV / 8);
        const int k = k0 + r, v = v0 + 8 * c;
        bf16* dst = sW + r * kLdV + 8 * c;
        if (k < a.d && v < a.V && v + 8 > a.V) {
          const bf16* src = head + (long long)k * a.sd + v;
          for (int j = 0; j < 8; ++j) dst[j] = v + j < a.V ? src[j] : __float2bfloat16(0.f);
        } else {
          const bool ok = k < a.d && v < a.V;
          cp_async_16(dst, ok ? head + (long long)k * a.sd + v : head, ok);
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_iter) load(s, s);
    cp_async_commit();
  }

  // lane offsets of the ldmatrix row addresses (mma_bf16.cuh): hidden's A
  // fragment (rows, then the right 8 columns); two n8 fragments of B from
  // [v][k] rows (ldmatrix) or from [k][v] rows (ldmatrix.trans)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = kKMajor ? (lane & 7) + (lane >> 4) * 8 : (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = kKMajor ? ((lane >> 3) & 1) * 8 : (lane >> 4) * 8;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNT; ++nj)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][nj][c] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<kStages - 2>();   // k-slice it has landed
    __syncthreads();                // and every warp is done with slice it - 1's stage
    const int next = it + kStages - 1;
    if (next < n_iter) load(next % kStages, next);
    cp_async_commit();

    const bf16* stage = smem + (it % kStages) * kStage;
    const bf16* sA = stage + (64 * wm + a_row) * kLdK + a_col;
    const bf16* sB = stage + kHStage;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[kMT][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) ldmatrix_x4(af[mi], sA + 16 * mi * kLdK + 16 * ks);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bfr[4];
        if constexpr (kKMajor)
          ldmatrix_x4(bfr, sB + (64 * wn + 16 * np + b_row) * kLdK + 16 * ks + b_col);
        else
          ldmatrix_x4_trans(bfr, sB + (16 * ks + b_row) * kLdV + 64 * wn + 16 * np + b_col);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          mma_16816(acc[mi][2 * np], af[mi], bfr[0], bfr[1]);
          mma_16816(acc[mi][2 * np + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }

    if ((it + 1) % n_k == 0) {
      epi(vt_begin + it / n_k, acc);
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int nj = 0; nj < kNT; ++nj)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][nj][c] = 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Token of row r (= 2 mi + h) of this thread: 64 wm + 16 mi + 8 h + g of the tile.
__device__ __forceinline__ int tc_row(int r, int wm, int g) {
  return 64 * wm + 16 * (r >> 1) + 8 * (r & 1) + g;
}

template <bool kKMajor>
__global__ void __launch_bounds__(kThreads, 1)
ce_fwd_mma_kernel(const bf16* __restrict__ hidden, const bf16* __restrict__ head,
                  const int* __restrict__ labels, float* __restrict__ part, Args a) {
  using mma_bf16::ex2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / kWarpsV, wn = warp % kWarpsV;
  const int t0 = blockIdx.x * kBT;
  const int split = blockIdx.y;
  const int n_vt = (a.V + kBV - 1) / kBV;
  const int vt_begin = split * a.tiles_per_split;
  const int vt_end = min(vt_begin + a.tiles_per_split, n_vt);

  int lbl[kRows];
  float m[kRows], l[kRows], gold[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int tok = t0 + tc_row(r, wm, g);
    lbl[r] = tok < a.T ? labels[tok] : -1;
    m[r] = kNegInf;
    l[r] = 0.f;
    gold[r] = kNegInf;
  }

  mma_tiles<kKMajor>(
      hidden, head, a, t0, vt_begin, vt_end, reinterpret_cast<bf16*>(smem_raw),
      [&](int vt, float(&acc)[kMT][kNT][4]) {
        const int c0 = vt * kBV + 64 * wn + 2 * t;   // the thread's first column
        const bool edge = (vt + 1) * kBV > a.V;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int mi = r >> 1, h = r & 1;
          const int rel = lbl[r] - c0;
          float mx = kNegInf;
#pragma unroll
          for (int nj = 0; nj < kNT; ++nj)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float s = acc[mi][nj][2 * h + c];
              if (edge && c0 + 8 * nj + c >= a.V) s = kNegInf;
              acc[mi][nj][2 * h + c] = s;
              mx = fmaxf(mx, s);
              if (rel == 8 * nj + c) gold[r] = s;
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float mn = fmaxf(m[r], mx);
          float sum = 0.f;
#pragma unroll
          for (int nj = 0; nj < kNT; ++nj)
#pragma unroll
            for (int c = 0; c < 2; ++c) sum += ex2((acc[mi][nj][2 * h + c] - mn) * kLog2e);
          l[r] = l[r] * ex2((m[r] - mn) * kLog2e) + sum;
          m[r] = mn;
        }
      });

  // the quad's partial sums and gold, then the four warps of a row, through
  // the drained ring: sM, sL, sG are [kWarpsV][kBT]
  float* sM = reinterpret_cast<float*>(smem_raw);
  float* sL = sM + kWarpsV * kBT;
  float* sG = sL + kWarpsV * kBT;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float lr = l[r], gr = gold[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    gr = fmaxf(gr, __shfl_xor_sync(0xffffffffu, gr, 1));
    gr = fmaxf(gr, __shfl_xor_sync(0xffffffffu, gr, 2));
    if (t == 0) {
      const int row = wn * kBT + tc_row(r, wm, g);
      sM[row] = m[r];
      sL[row] = lr;
      sG[row] = gr;
    }
  }
  __syncthreads();
  if (tid < kBT && t0 + tid < a.T) {
    float mm = kNegInf, gg = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarpsV; ++w) {
      mm = fmaxf(mm, sM[w * kBT + tid]);
      gg = fmaxf(gg, sG[w * kBT + tid]);
    }
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsV; ++w) ll += sL[w * kBT + tid] * expf(sM[w * kBT + tid] - mm);
    const long long plane = (long long)a.n_split * a.T;
    const long long o = (long long)split * a.T + t0 + tid;
    part[o] = mm;
    part[plane + o] = ll;
    part[2 * plane + o] = gg;
  }
}

template <bool kKMajor>
__global__ void __launch_bounds__(kThreads, 1)
ce_probs_mma_kernel(const bf16* __restrict__ hidden, const bf16* __restrict__ head,
                    const int* __restrict__ labels, const float* __restrict__ lse,
                    const float* __restrict__ gscale, bf16* __restrict__ probs, long long ldp,
                    Args a) {
  using mma_bf16::ex2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / kWarpsV, wn = warp % kWarpsV;
  const int t0 = blockIdx.x * kBT;
  const int vt = blockIdx.y;

  int lbl[kRows];
  float shift[kRows], gs[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int tok = t0 + tc_row(r, wm, g);
    const bool ok = tok < a.T;
    lbl[r] = ok ? labels[tok] : -1;
    shift[r] = ok ? lse[tok] : 0.f;
    gs[r] = ok ? gscale[tok] : 0.f;
  }

  mma_tiles<kKMajor>(
      hidden, head, a, t0, vt, vt + 1, reinterpret_cast<bf16*>(smem_raw),
      [&](int tile, float(&acc)[kMT][kNT][4]) {
        const int c0 = tile * kBV + 64 * wn + 2 * t;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int mi = r >> 1, h = r & 1;
          const int tok = t0 + tc_row(r, wm, g);
          if (tok >= a.T) continue;
          bf16* row = probs + (long long)tok * ldp;
#pragma unroll
          for (int nj = 0; nj < kNT; ++nj) {
            const int col = c0 + 8 * nj;
            if (col >= a.V) continue;
            const float p0 = ex2((acc[mi][nj][2 * h] - shift[r]) * kLog2e) -
                             (col == lbl[r] ? 1.f : 0.f);
            const float p1 = ex2((acc[mi][nj][2 * h + 1] - shift[r]) * kLog2e) -
                             (col + 1 == lbl[r] ? 1.f : 0.f);
            // col is even and ldp a multiple of 8: col + 1 < ldp, 4-byte aligned
            *reinterpret_cast<__nv_bfloat162*>(row + col) =
                __floats2bfloat162_rn(gs[r] * p0, gs[r] * p1);
          }
        }
      });
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The tensor-core route's conditions (kernels/ce_loss.py::_route): 1 for the
// tied layout (head strides (1, sv)), 0 for a (d, V) head with contiguous
// rows (strides (sd, 1)), -1 when the route does not take the inputs.
int mma_layout(const void* hidden, const void* head, int d, long long sh, long long sd,
               long long sv) {
  if (d % 8 || sh % 8 || !aligned16(hidden) || !aligned16(head)) return -1;
  if (sd == 1 && sv % 8 == 0) return 1;
  if (sv == 1 && sd % 8 == 0) return 0;
  return -1;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kSmem);
}

template <bool kKMajor>
int launch_fwd_mma(const bf16* hidden, const bf16* head, const int* labels, float* part,
                   const Args& a, cudaStream_t s) {
  const cudaError_t e = allow_smem(ce_fwd_mma_kernel<kKMajor>);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.T + kBT - 1) / kBT, a.n_split);
  ce_fwd_mma_kernel<kKMajor><<<grid, kThreads, kSmem, s>>>(hidden, head, labels, part, a);
  return (int)cudaGetLastError();
}

template <bool kKMajor>
int launch_probs_mma(const bf16* hidden, const bf16* head, const int* labels, const float* lse,
                     const float* gscale, bf16* probs, long long ldp, const Args& a,
                     cudaStream_t s) {
  const cudaError_t e = allow_smem(ce_probs_mma_kernel<kKMajor>);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.T + kBT - 1) / kBT, (a.V + kBV - 1) / kBV);
  ce_probs_mma_kernel<kKMajor><<<grid, kThreads, kSmem, s>>>(
      hidden, head, labels, lse, gscale, probs, ldp, a);
  return (int)cudaGetLastError();
}

}  // namespace tc
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

// The tensor-core route: as fused_cross_entropy_bf16, with vocab tiles of
// 256 columns in the split plan; cudaErrorInvalidValue, and nothing
// launched, unless the route's conditions hold.
int fused_cross_entropy_bf16_mma(const void* hidden, const void* head, const int* labels,
                                 float* scratch, float* loss, float* lse, int T, int d, int V,
                                 int n_split, int tiles_per_split, long long sh, long long sd,
                                 long long sv, void* stream) {
  const int layout = tc::mma_layout(hidden, head, d, sh, sd, sv);
  if (layout < 0 || bad_plan(T, d, V, n_split, tiles_per_split, tc::kBV))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(T, d, V, n_split, tiles_per_split, sh, sd, sv);
  const bf16* h = static_cast<const bf16*>(hidden);
  const bf16* w = static_cast<const bf16*>(head);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = layout ? tc::launch_fwd_mma<true>(h, w, labels, scratch, a, s)
                        : tc::launch_fwd_mma<false>(h, w, labels, scratch, a, s);
  if (rc) return rc;
  return launch_merge(scratch, loss, lse, T, n_split, s);
}

// P = bf16(g (exp(hidden @ head - lse) - onehot(labels))) into probs, a
// (T, ldp) bf16 buffer, ldp a multiple of 8 and at least V; lse and g (T,)
// fp32. The tensor-core route's conditions as above.
int ce_probs_bf16_mma(const void* hidden, const void* head, const int* labels, const float* lse,
                      const float* g, void* probs, long long ldp, int T, int d, int V,
                      long long sh, long long sd, long long sv, void* stream) {
  const int layout = tc::mma_layout(hidden, head, d, sh, sd, sv);
  if (layout < 0 || T < 1 || V < 1 || ldp % 8 || ldp < V || !tc::aligned16(probs) ||
      (V + tc::kBV - 1) / tc::kBV > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(T, d, V, 1, 1, sh, sd, sv);
  const bf16* h = static_cast<const bf16*>(hidden);
  const bf16* w = static_cast<const bf16*>(head);
  bf16* p = static_cast<bf16*>(probs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return layout ? tc::launch_probs_mma<true>(h, w, labels, lse, g, p, ldp, a, s)
                : tc::launch_probs_mma<false>(h, w, labels, lse, g, p, ldp, a, s);
}

// The scalar route of the gradient's softmax: P = g (exp(hidden @ head - lse)
// - onehot(labels)) into probs, a (T, ldp) buffer of the inputs' dtype,
// ldp >= V; lse and g (T,) fp32.
int ce_probs_f32(const void* hidden, const void* head, const int* labels, const float* lse,
                 const float* g, void* probs, long long ldp, int T, int d, int V, long long sh,
                 long long sd, long long sv, void* stream) {
  return launch_probs<float>(hidden, head, labels, lse, g, probs, ldp, T, d, V, sh, sd, sv,
                             stream);
}

int ce_probs_bf16(const void* hidden, const void* head, const int* labels, const float* lse,
                  const float* g, void* probs, long long ldp, int T, int d, int V, long long sh,
                  long long sd, long long sv, void* stream) {
  return launch_probs<__nv_bfloat16>(hidden, head, labels, lse, g, probs, ldp, T, d, V, sh, sd,
                                     sv, stream);
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

// The tensor-core kernels: blocks of ce_fwd_mma_kernel one SM holds at once
// (the occupancy query, after raising the shared-memory limit; negative: an
// error), and the threads and dynamic shared memory of a block.
int fused_cross_entropy_mma_blocks_per_sm(void) {
  cudaError_t e = tc::allow_smem(tc::ce_fwd_mma_kernel<true>);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, tc::ce_fwd_mma_kernel<true>,
                                                    tc::kThreads, tc::kSmem);
  return e == cudaSuccess ? n : -(int)e;
}

int fused_cross_entropy_mma_threads(void) { return tc::kThreads; }

long long fused_cross_entropy_mma_smem_bytes(void) { return (long long)tc::kSmem; }

const char* fused_cross_entropy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
