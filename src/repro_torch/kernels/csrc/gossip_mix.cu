// gossip_mix for Hopper (sm_90a): one neighbour-mixing step of the gossip lane
//
//     out[i, c] = sum_s w[i, s] * x[idx[i, s], c]     x: (n, N) fp32 or bf16
//                                                     idx: (n, D) int32, w: (n, D) fp32
//
// i.e. out = W @ X for the mixing matrix W that the padded slots encode,
// accumulated in fp32 and written in the storage dtype. Duplicate ids add; a
// padded slot (idx = i, w = 0) adds nothing; an id outside [0, n) contributes
// 0 and is never read (the reference's one-hot semantics).
//
// Replaces repro/kernels/gossip_mix.py::gossip_mix (the Pallas _mix_kernel).
// That kernel expands a row block's ids into a one-hot (bn, n) slice of W
// and contracts it on the TPU's matrix unit, a workaround for dynamic row
// gathers that Mosaic lowers badly. What it keeps out of device memory is
// kept out here too: the full node axis of one column block sits in fast
// memory, so X is read once however many neighbours share a row.
//
// Two kernels; the caller (kernels/gossip_mix.py::_route) picks one from the
// slots a row has against the nodes:
//
// gossip_mix_kernel, the gather route (sparse plans: the ring, D = 3, and the
// small world, D = 7). Bound by HBM bytes: X is read once and out written
// once, 8 bytes per fp32 element, against 2 * (non-zero slots / n) flops an
// element, far below the fp32 ridge. One block per column tile
// [c0, c0 + TILE). The block copies X[:, c0:c0+TILE] for all n nodes into
// shared memory (n * TILE elements; TILE from n so that the tile fits), then
// each thread owns CV = 4 consecutive columns of the tile and a stride of
// rows: for row i it reads tile[idx[i, s]][col .. col+3] with one 16-byte (8
// for bf16) shared-memory load per slot, accumulates w[i, s] times each of
// them in four fp32 registers, and writes out[i, c0+col .. c0+col+3]. Four
// columns a thread share each slot's (idx, w) pair, which are warp-uniform
// loads through the read-only cache. Neighbouring threads hold neighbouring
// columns of one row, so the global loads and stores coalesce. Global
// accesses are LV elements wide: pairs when N is even and both pointers are
// aligned to a pair (both main N are 2 mod 4, so only every other row of an
// fp32 (n, N) matrix starts 16-byte aligned, but every row starts 8-byte
// aligned), single elements otherwise. The last tile masks its ragged edge.
//
// gossip_mix_dense_kernel, the dense route (the full graph, D = n, and any
// plan with as many slots as the crossover asks). Bound by its 2 * n * n * N
// fp32 flops: at n = 100 and the CNN's N = 1,663,370 that is 0.50 ms at 67
// TFLOP/s against 0.40 ms for the bytes. The gather kernel spends one
// 16-byte shared-memory load on 4 FMAs there, and takes 3.9 ms. Here:
//   - W is built in shared memory, k-major (sW[k][m]), from idx and w: the
//     thread of row m walks row m's slots in order and adds w[m, s] at
//     column idx[m, s], so duplicates add in slot order and ids outside the
//     panel add nothing, exactly the reference's one-hot sum. For n <= 128
//     W is built once a block; above, it is tiled in 128 x 128 panels (M
//     chunks of out's rows by K panels of X's rows), rebuilt per panel.
//   - Each thread owns an 8-row x 4-column tile of out: 32 fp32
//     accumulators. Per k it reads its 8 W values as two float4 and its 4 X
//     values as one vector: 32 FMAs per 3 shared-memory loads.
//   - A block is RG row groups x CG column groups, RG = ceil(min(n, 128) /
//     8) (13 at n = 100: 104 rows, 4% of the FMAs on padding), CG the
//     largest power of two with RG * CG <= 256; the column tile is BN = 4 *
//     CG columns (64 at n = 100).
//   - Persistent blocks (as many as the occupancy query fits, two an SM at
//     n = 100) walk the column tiles; each tile's K panel of X goes through
//     a two-stage cp.async ring, so the next tile's copy is in flight while
//     this one's FMAs run. The copies are LV elements wide (8 bytes for fp32
//     rows of even N on 8-byte boundaries, 4 bytes for single fp32 elements
//     or bf16 pairs); a bf16 row off a 4-byte boundary is staged by plain
//     loads. No division in the walk: a thread's copies and the (tile, M
//     chunk, K panel) steps advance by counters.
//   - fp32 FMAs on the CUDA cores, no TF32: the reference's tolerance is
//     fp32's.
//   What holds it back, on an H100 SXM at 700 W (PERF.md; kernels/probe.py
//   and chip_smoke.py phase 4): 1.17 ms at n = 100 and the CNN's N, 42% of
//   the flop bound, 0.99x torch.matmul's time and 3.3x faster than the
//   gather route; 1.07 ms with the X loads cut out. The card's FFMA pipes
//   reach 64.8 TFLOP/s on independent chains, but this 8 x 4 pattern on
//   shared-memory operands reaches 39.5 TFLOP/s at the 13 warps an SM that
//   two blocks give and 48.5 at 32 warps. More warps need less W and X in
//   shared memory or fewer registers; 8 x 8 tiles, thinner X stages, one
//   resident-W block of 23 warps, register caps for 3-4 blocks an SM, and W
//   built once into an L2-resident buffer and streamed with X were tried on
//   the card and were all slower (spills, one block an SM, more steps a
//   tile, or W's reloads).
//
// The C entry points return cudaGetLastError() after the launch (or the
// error of raising the block's shared-memory limit above 48 KB, or of the
// occupancy query); the caller raises on a non-zero code. They launch on the
// stream they are given, allocate nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCV = 4;   // columns a thread sums
// TILE never drops below one warp of columns: 1024 nodes x 32 x 4 bytes is
// 128 KB of shared memory, inside the 227 KB a block can opt in to.
constexpr int kMaxNodes = 1024;
// The largest tile whose shared memory stays under this, so that several
// blocks share an SM and one block's loads overlap another's sums.
constexpr size_t kTargetSmem = 64 * 1024;
constexpr size_t kDefaultSmem = 48 * 1024;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f32(float a, float* o) { *o = a; }
__device__ __forceinline__ void store_f32(float a, __nv_bfloat16* o) { *o = __float2bfloat16_rn(a); }

template <typename T, int TILE, int LV>
__global__ void __launch_bounds__(kThreads)
gossip_mix_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                  const float* __restrict__ w, T* __restrict__ out,
                  int n, long long N, int D) {
  constexpr int kColThreads = TILE / kCV;      // threads across one row of the tile
  static_assert(kThreads % kColThreads == 0, "a block covers whole rows of the tile");
  static_assert(kCV % LV == 0, "a thread's columns split into whole accesses");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const long long c0 = (long long)blockIdx.x * TILE;

  // Stage X[:, c0:c0+TILE], LV elements an access. Columns past N stay
  // unwritten: their sums below are never stored.
#pragma unroll 4
  for (int e = threadIdx.x * LV; e < n * TILE; e += kThreads * LV) {
    const long long c = c0 + e % TILE;
    const T* src = x + (long long)(e / TILE) * N + c;
    if (c + LV <= N) {
      *reinterpret_cast<Pack<T, LV>*>(tile + e) = *reinterpret_cast<const Pack<T, LV>*>(src);
    } else {
      for (int j = 0; j < LV && c + j < N; ++j) tile[e + j] = src[j];
    }
  }
  __syncthreads();

  const int col = (threadIdx.x % kColThreads) * kCV;
  const long long c = c0 + col;
  if (c >= N) return;
  for (int i = threadIdx.x / kColThreads; i < n; i += kThreads / kColThreads) {
    const int* ii = idx + (long long)i * D;
    const float* wi = w + (long long)i * D;
    float acc[kCV];
#pragma unroll
    for (int k = 0; k < kCV; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int s = 0; s < D; ++s) {
      const int j = __ldg(ii + s);
      const float ws = __ldg(wi + s);
      if ((unsigned)j < (unsigned)n) {
        const Pack<T, kCV> v = *reinterpret_cast<const Pack<T, kCV>*>(tile + j * TILE + col);
#pragma unroll
        for (int k = 0; k < kCV; ++k) acc[k] = fmaf(ws, to_f32(v.v[k]), acc[k]);
      }
    }
    T* dst = out + (long long)i * N + c;
    if (c + kCV <= N) {
#pragma unroll
      for (int k = 0; k < kCV; k += LV) {
        Pack<T, LV> o;
#pragma unroll
        for (int j = 0; j < LV; ++j) store_f32(acc[k + j], &o.v[j]);
        *reinterpret_cast<Pack<T, LV>*>(dst + k) = o;
      }
    } else {
      for (int k = 0; k < kCV && c + k < N; ++k) store_f32(acc[k], dst + k);
    }
  }
}

// Columns per block: the widest power of two from 256 down to 32 whose
// (n, TILE) tile stays under kTargetSmem.
int pick_tile(int n, int elem_bytes) {
  int tile = 256;
  while (tile > 32 && (size_t)n * tile * elem_bytes > kTargetSmem) tile /= 2;
  return tile;
}

// Elements per global access: a pair when N is even and both x and out are
// aligned to a pair (then every row start is), else one.
int pick_vec(const void* x, const void* out, long long N, int elem_bytes) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  return N % 2 == 0 && addr % (2 * elem_bytes) == 0 ? 2 : 1;
}

template <typename T, int TILE, int LV>
int launch_tile(const T* x, const int* idx, const float* w, T* out, int n, long long N,
                int D, cudaStream_t s) {
  const size_t smem = (size_t)n * TILE * sizeof(T);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        gossip_mix_kernel<T, TILE, LV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (N + TILE - 1) / TILE;
  gossip_mix_kernel<T, TILE, LV><<<(unsigned)blocks, kThreads, smem, s>>>(
      x, idx, w, out, n, N, D);
  return (int)cudaGetLastError();
}

template <typename T, int LV>
int launch_vec(const T* x, const int* idx, const float* w, T* out, int n, long long N, int D,
               cudaStream_t s) {
  switch (pick_tile(n, (int)sizeof(T))) {
    case 256: return launch_tile<T, 256, LV>(x, idx, w, out, n, N, D, s);
    case 128: return launch_tile<T, 128, LV>(x, idx, w, out, n, N, D, s);
    case 64: return launch_tile<T, 64, LV>(x, idx, w, out, n, N, D, s);
    default: return launch_tile<T, 32, LV>(x, idx, w, out, n, N, D, s);
  }
}

template <typename T>
int launch(const void* x, const void* idx, const void* w, void* out, int n, long long N,
           int D, void* stream) {
  if (n < 1 || n > kMaxNodes || N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const int* it = static_cast<const int*>(idx);
  const float* wt = static_cast<const float*>(w);
  T* ot = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pick_vec(x, out, N, (int)sizeof(T)) == 2) return launch_vec<T, 2>(xt, it, wt, ot, n, N, D, s);
  return launch_vec<T, 1>(xt, it, wt, ot, n, N, D, s);
}

// ---------------------------------------------------------------------------
// the dense route
// ---------------------------------------------------------------------------

constexpr int kDenseRows = 8;        // rows of out a thread sums
constexpr int kDenseCols = 4;        // columns of out a thread sums
constexpr int kDenseThreads = 256;   // at most, a block
constexpr int kDensePanel = 128;     // nodes of an M chunk and of a K panel
constexpr int kDenseStages = 2;      // the X ring

struct DenseGeom {
  int cg;   // column groups: threads across a tile's columns
  int bm;   // rows of an M chunk (RG * 8, padding included)
  int bn;   // columns of a tile
  int kp;   // rows of X in a K panel
};

DenseGeom dense_geom(int n) {
  DenseGeom g;
  const int rg = (std::min(n, kDensePanel) + kDenseRows - 1) / kDenseRows;
  g.cg = kDenseThreads;
  while (g.cg * rg > kDenseThreads) g.cg /= 2;
  g.bm = rg * kDenseRows;
  g.bn = g.cg * kDenseCols;
  g.kp = std::min(n, kDensePanel);
  return g;
}

int dense_threads(const DenseGeom& g) { return g.bm / kDenseRows * g.cg; }

size_t dense_smem(const DenseGeom& g, int elem_bytes) {
  return (size_t)g.kp * g.bm * sizeof(float) + (size_t)kDenseStages * g.kp * g.bn * elem_bytes;
}

// Four consecutive staged X values as fp32.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const Pack<__nv_bfloat16, 4> q = *reinterpret_cast<const Pack<__nv_bfloat16, 4>*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(q.v[j]);
}

template <typename T, int LV>
__global__ void __launch_bounds__(kDenseThreads)
gossip_mix_dense_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                        const float* __restrict__ w, T* __restrict__ out, int n, long long N,
                        int D, DenseGeom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sW = reinterpret_cast<float*>(smem_raw);                     // [kp][bm]
  T* sX = reinterpret_cast<T*>(smem_raw + (size_t)g.kp * g.bm * sizeof(float));
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int rgi = tid / g.cg, cgi = tid % g.cg;
  const long long tiles = (N + g.bn - 1) / g.bn;
  const int mchunks = (n + g.bm - 1) / g.bm;
  const int kpanels = (n + g.kp - 1) / g.kp;
  const int per_tile = mchunks * kpanels;
  const int my_tiles =
      blockIdx.x < tiles ? (int)((tiles - 1 - blockIdx.x) / gridDim.x + 1) : 0;
  const int steps = my_tiles * per_tile;
  const int stage_elems = g.kp * g.bn;
  // This thread's first copy of a panel and the stride between its copies
  // (LV elements each, row k, column c of the tile), fixed for the kernel.
  const int row_vecs = g.bn / LV;
  const int k_first = tid / row_vecs, c_first = (tid % row_vecs) * LV;
  const int k_step = nthreads / row_vecs, c_step = (nthreads % row_vecs) * LV;

  // W's panel for out rows [m0, m0 + bm) and X rows [k0, k0 + kn): zeroed,
  // then row m's thread adds its slots in slot order. The caller syncs
  // before (nobody still reads the old panel) and after.
  auto build_w = [&](int m0, int k0, int kn) {
    for (int e = tid; e < g.kp * g.bm; e += nthreads) sW[e] = 0.f;
    __syncthreads();
    const int i = m0 + tid;
    if (tid < g.bm && i < n) {
      const int* ii = idx + (long long)i * D;
      const float* wi = w + (long long)i * D;
      for (int sl = 0; sl < D; ++sl) {
        const int j = __ldg(ii + sl);
        if (j >= k0 && j < k0 + kn) sW[(j - k0) * g.bm + tid] += __ldg(wi + sl);
      }
    }
  };

  // Stage X[k0 : k0 + kn, c0 : c0 + bn) of this block's tile j and K panel
  // kpi into `stage`. Columns past N are not copied: their sums are never
  // stored.
  auto issue = [&](int j, int kpi, int stage) {
    const long long c0 = ((long long)blockIdx.x + (long long)j * gridDim.x) * g.bn;
    const int k0 = kpi * g.kp, kn = min(g.kp, n - k0);
    T* dst = sX + stage * stage_elems;
    int k = k_first, c = c_first;
    const T* src = x + (long long)(k0 + k) * N + c0 + c;
    while (k < kn) {
      if (c0 + c < N) {
        if constexpr (LV * sizeof(T) >= 4) {
          async_copy::copy<LV * sizeof(T)>(dst + k * g.bn + c, src);
        } else {
          dst[k * g.bn + c] = *src;
        }
      }
      k += k_step;
      c += c_step;
      src += (long long)k_step * N + c_step;
      if (c >= g.bn) {
        c -= g.bn;
        ++k;
        src += N - g.bn;
      }
    }
  };
  // Step order: tile j, then its M chunks, then their K panels.
  auto advance = [&](int& j, int& mc, int& kpi) {
    if (++kpi == kpanels) {
      kpi = 0;
      if (++mc == mchunks) {
        mc = 0;
        ++j;
      }
    }
  };

  if (per_tile == 1) build_w(0, 0, n);
  int lj = 0, lmc = 0, lkpi = 0;   // the next step to stage
  if (steps > 0) {
    issue(lj, lkpi, 0);
    advance(lj, lmc, lkpi);
  }
  async_copy::commit();

  float acc[kDenseRows][kDenseCols];
  int j = 0, mc = 0, kpi = 0;      // the step to compute
  for (int s = 0; s < steps; ++s) {
    async_copy::wait<0>();
    __syncthreads();   // step s is staged; step s - 1's reads of its stage and of W are done
    if (s + 1 < steps) {
      issue(lj, lkpi, (s + 1) % kDenseStages);
      advance(lj, lmc, lkpi);
    }
    async_copy::commit();
    const int m0 = mc * g.bm, k0 = kpi * g.kp, kn = min(g.kp, n - k0);
    if (per_tile > 1) {
      build_w(m0, k0, kn);
      __syncthreads();
    }
    if (kpi == 0) {
#pragma unroll
      for (int r = 0; r < kDenseRows; ++r)
#pragma unroll
        for (int q = 0; q < kDenseCols; ++q) acc[r][q] = 0.f;
    }
    const float* wp = sW + rgi * kDenseRows;
    const T* xp = sX + (s % kDenseStages) * stage_elems + cgi * kDenseCols;
#pragma unroll 8
    for (int k = 0; k < kn; ++k) {
      const float4 w0 = *reinterpret_cast<const float4*>(wp + k * g.bm);
      const float4 w1 = *reinterpret_cast<const float4*>(wp + k * g.bm + 4);
      const float wr[kDenseRows] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      float xv[kDenseCols];
      load4(xp + k * g.bn, xv);
#pragma unroll
      for (int r = 0; r < kDenseRows; ++r)
#pragma unroll
        for (int q = 0; q < kDenseCols; ++q) acc[r][q] = fmaf(wr[r], xv[q], acc[r][q]);
    }
    if (kpi == kpanels - 1) {
      const long long c = ((long long)blockIdx.x + (long long)j * gridDim.x) * g.bn +
                          cgi * kDenseCols;
      if (c < N) {
#pragma unroll
        for (int r = 0; r < kDenseRows; ++r) {
          const int i = m0 + rgi * kDenseRows + r;
          if (i >= n) break;
          T* dst = out + (long long)i * N + c;
          if (c + kDenseCols <= N) {
#pragma unroll
            for (int q = 0; q < kDenseCols; q += LV) {
              Pack<T, LV> o;
#pragma unroll
              for (int jj = 0; jj < LV; ++jj) store_f32(acc[r][q + jj], &o.v[jj]);
              *reinterpret_cast<Pack<T, LV>*>(dst + q) = o;
            }
          } else {
            for (int q = 0; q < kDenseCols && c + q < N; ++q) store_f32(acc[r][q], dst + q);
          }
        }
      }
    }
    advance(j, mc, kpi);
  }
  async_copy::wait<0>();
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

// Blocks of the dense kernel an SM holds at n nodes, or minus a CUDA error.
template <typename T, int LV>
int dense_blocks_per_sm(const DenseGeom& g) {
  const size_t smem = dense_smem(g, (int)sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(gossip_mix_dense_kernel<T, LV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gossip_mix_dense_kernel<T, LV>,
                                                    dense_threads(g), smem);
  return e == cudaSuccess ? blocks : -(int)e;
}

template <typename T, int LV>
int launch_dense_vec(const T* x, const int* idx, const float* w, T* out, int n, long long N,
                     int D, cudaStream_t s) {
  const DenseGeom g = dense_geom(n);
  const int per_sm = dense_blocks_per_sm<T, LV>(g);
  if (per_sm < 0) return -per_sm;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (N + g.bn - 1) / g.bn;
  const long long blocks = std::min(tiles, (long long)per_sm * std::max(sm_count(), 1));
  gossip_mix_dense_kernel<T, LV><<<(unsigned)blocks, dense_threads(g),
                                   dense_smem(g, (int)sizeof(T)), s>>>(x, idx, w, out, n, N, D,
                                                                       g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dense(const void* x, const void* idx, const void* w, void* out, int n, long long N,
                 int D, void* stream) {
  if (n < 1 || n > kMaxNodes || N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const int* it = static_cast<const int*>(idx);
  const float* wt = static_cast<const float*>(w);
  T* ot = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pick_vec(x, out, N, (int)sizeof(T)) == 2)
    return launch_dense_vec<T, 2>(xt, it, wt, ot, n, N, D, s);
  return launch_dense_vec<T, 1>(xt, it, wt, ot, n, N, D, s);
}

}  // namespace

extern "C" {

int gossip_mix_f32(const void* x, const void* idx, const void* w, void* out, int n,
                   long long N, int D, void* stream) {
  return launch<float>(x, idx, w, out, n, N, D, stream);
}

int gossip_mix_bf16(const void* x, const void* idx, const void* w, void* out, int n,
                    long long N, int D, void* stream) {
  return launch<__nv_bfloat16>(x, idx, w, out, n, N, D, stream);
}

// Columns per block the launch above picks for n nodes of elem_bytes each.
int gossip_mix_tile(int n, int elem_bytes) { return pick_tile(n, elem_bytes); }

// Elements per global access the launch above picks for these pointers and N.
int gossip_mix_vec(const void* x, const void* out, long long N, int elem_bytes) {
  return pick_vec(x, out, N, elem_bytes);
}

int gossip_mix_dense_f32(const void* x, const void* idx, const void* w, void* out, int n,
                         long long N, int D, void* stream) {
  return launch_dense<float>(x, idx, w, out, n, N, D, stream);
}

int gossip_mix_dense_bf16(const void* x, const void* idx, const void* w, void* out, int n,
                          long long N, int D, void* stream) {
  return launch_dense<__nv_bfloat16>(x, idx, w, out, n, N, D, stream);
}

// The dense kernel's geometry at n nodes of elem_bytes each and global
// accesses vec elements wide: threads, rows of an M chunk (padding
// included), columns of a tile, rows of a K panel, dynamic shared memory
// and the blocks an SM holds (occupancy query), in geom[0..5]. Returns 0 or
// a CUDA error.
int gossip_mix_dense_plan(int n, int elem_bytes, int vec, int* geom) {
  if (n < 1 || n > kMaxNodes) return (int)cudaErrorInvalidValue;
  const DenseGeom g = dense_geom(n);
  int per_sm;
  if (elem_bytes == 4)
    per_sm = vec == 2 ? dense_blocks_per_sm<float, 2>(g) : dense_blocks_per_sm<float, 1>(g);
  else
    per_sm = vec == 2 ? dense_blocks_per_sm<__nv_bfloat16, 2>(g)
                      : dense_blocks_per_sm<__nv_bfloat16, 1>(g);
  if (per_sm < 0) return -per_sm;
  geom[0] = dense_threads(g);
  geom[1] = g.bm;
  geom[2] = g.bn;
  geom[3] = g.kp;
  geom[4] = (int)dense_smem(g, elem_bytes);
  geom[5] = per_sm;
  return 0;
}

const char* gossip_mix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
