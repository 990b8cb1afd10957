// sparse_aggregate for Hopper (sm_90a): the top-k codec's server average
//
//     out = zeros(n);  out[idx[c, j]] += w[c] * vals[c, j]
//
// idx: (K, k) int32, vals: (K, k) fp32 or bf16, w: (K,) fp32, out: (n,) fp32.
// Each term is w[c] * float(vals[c, j]) in fp32; indices outside [0, n) are
// dropped, so a bad index cannot write outside the output (top-k emits none).
//
// Replaces repro/kernels/sparse_agg.py::sparse_aggregate (the Pallas
// _sparse_kernel, :43). That kernel walks client blocks on a sequential grid
// and scatter-adds each block into one (n,) accumulator that stays in VMEM
// across the grid; on Hopper the blocks run in parallel, so the shared
// accumulator takes fp32 atomic adds in L2 instead. Their order, and so the
// last bits of the sum, varies from run to run.
//
// What bounds it: the larger of two floors. HBM bytes: K*k*8 read (a 4-byte
// index and a 4-byte value a pair; 6 for bf16) and n*4 written, over the
// memory rate. And the card's rate of fp32 reductions (REDs) into L2 at the
// pairs' addresses: each pair is one RED, and top-k indices are unique within
// a client but unsorted, so a warp's 32 REDs touch 32 sectors; indices that
// collide across clients meet at one address. kernels/probe.py's probe_red
// measures that rate (on an H100, 831,680 REDs at uniform random indices take
// about three times the byte floor of the CNN's top-5%: the REDs hold both
// routes; PERF.md section 6 has the numbers).
//
// Two routes (kernels/sparse_agg.py::_route picks one from shapes, dtypes
// and alignment):
//
// - fused, sparse_agg_fused_kernel<T>: rows whose pairs can be read 4 at a
//   time (k % 4 == 0; idx, fp32 vals and out 16-byte aligned, bf16 vals
//   8-byte aligned): the specs' top-5% at the CNN and 2NN sizes. Since the
//   REDs are the floor, what it can save is the rest: the second launch and
//   the gap between kernels, and the loads' latency before the REDs.
//   * one launch: a persistent grid of one block an SM, launched
//     cooperatively (cudaLaunchCooperativeKernel; never more blocks than the
//     occupancy query lets be resident at once), zeroes the output, each
//     block its own contiguous stripe with 16-byte stores, syncs the grid
//     (cooperative_groups::this_grid().sync()), then scatters. The output is
//     allocated empty, so no fill kernel is launched. A grid the card cannot
//     hold resident fails the launch, which the wrapper raises; nothing
//     falls back.
//   * loads first: a work item is a group of 4 pairs of one row, one 16-byte
//     load of indices and one 16-byte (8 for bf16) load of values. A thread
//     asks for its first kUnroll items before it zeroes its share of the
//     stripe, so the loads are in flight during the zero phase and the sync
//     and the REDs then issue back to back (at the CNN's top-5% one batch
//     holds every item). The weight multiplies wait for the REDs, so nothing
//     stalls on a load before the sync. The item's row c comes from its
//     position within the rows' groups, carried from item to item by
//     subtraction: there is no division (the scatter route divides two
//     64-bit integers a pair, which the card does in software), and w[c] is
//     read once an item.
//   kernels/probe.py measures the choices on an H100 (CUTS): asking for the
//   loads before the zero phase, and one block an SM with 8 items a thread
//   in place of 2 blocks an SM with 4, each take time off; evict-first
//   loads and evict-last REDs (createpolicy) did not, and were dropped.
// - scatter, sparse_agg_kernel<T>: everything else (k % 4 != 0, misaligned
//   views). The wrapper zeroes the output first (a fill kernel), then one
//   thread a (client, pair) reads its index and value and issues one RED,
//   with w[t / k] for its row.
//
// The C entry points return a CUDA error code (cudaGetLastError() after a
// launch); the caller raises on a non-zero one. They launch on the stream
// they are given, allocate nothing and do not synchronise.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;
constexpr int kFusedThreads = 256;
constexpr int kUnroll = 8;   // items a thread has in flight
constexpr int kBlocksPerSm = 1;

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

// --- the fused route -------------------------------------------------------

__device__ __forceinline__ int4 load_idx4(const int* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

// Four consecutive values of a row as fp32: one 16-byte load for fp32, one
// 8-byte load for bf16 (a bf16 is the high half of its fp32).
__device__ __forceinline__ float4 load_vals4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load_vals4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
}

// out[i] += v, fire and forget (a RED: the result is unused), for i in [0, n)
__device__ __forceinline__ void red_add(float* out, int i, float v, long long n) {
  if (i >= 0 && i < n) atomicAdd(out + i, v);
}

// Steps (c, g) forward until g is a group of row c, or c reaches K: the
// item's row without a division.
__device__ __forceinline__ void settle(int& c, long long& g, int K, long long groups) {
  while (c < K && g >= groups) {
    g -= groups;
    ++c;
  }
}

// A thread's next kUnroll items, asked for: for each, whether it is one
// (c < K), its 4 indices, its 4 values as fp32 and its row's weight, used
// only when the REDs are issued, so that nothing waits on a load before then.
// (c, g) moves on past them.
template <typename T>
struct Batch {
  int4 ix[kUnroll];
  float4 v[kUnroll];
  float wc[kUnroll];
  bool has[kUnroll];

  __device__ __forceinline__ void load(const int* __restrict__ idx, const T* __restrict__ vals,
                                       const float* __restrict__ w, int K, long long k,
                                       long long groups, long long step, int& c,
                                       long long& g) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      has[u] = c < K;
      if (has[u]) {
        const long long at = (long long)c * k + 4 * g;
        wc[u] = w[c];
        ix[u] = load_idx4(idx + at);
        v[u] = load_vals4(vals + at);
      }
      g += step;
      settle(c, g, K, groups);
    }
  }

  __device__ __forceinline__ void reduce(float* out, long long n) const {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (has[u]) {
        red_add(out, ix[u].x, wc[u] * v[u].x, n);
        red_add(out, ix[u].y, wc[u] * v[u].y, n);
        red_add(out, ix[u].z, wc[u] * v[u].z, n);
        red_add(out, ix[u].w, wc[u] * v[u].w, n);
      }
    }
  }
};

// stripe: float4s of out each block zeroes (ceil(n / 4 / gridDim.x)).
template <typename T>
__global__ void __launch_bounds__(kFusedThreads)
sparse_agg_fused_kernel(const int* __restrict__ idx, const T* __restrict__ vals,
                        const float* __restrict__ w, float* __restrict__ out, int K,
                        long long k, long long n, long long stripe) {
  // Item (c, g) is pairs 4g .. 4g + 3 of row c; this thread's items are its
  // index plus multiples of the grid's thread count, in the order
  // c * groups + g. Its first batch is asked for before the zero phase, so
  // the loads are in flight while the output is zeroed and the grid syncs.
  const long long groups = k >> 2;
  const long long step = (long long)gridDim.x * kFusedThreads;
  int c = 0;
  long long g = (long long)blockIdx.x * kFusedThreads + threadIdx.x;
  settle(c, g, K, groups);
  Batch<T> b;
  b.load(idx, vals, w, K, k, groups, step, c, g);

  // zero this block's stripe; block 0 also the n % 4 floats past the last float4
  const long long n4 = n >> 2;
  const long long z0 = (long long)blockIdx.x * stripe;
  const long long z1 = z0 + stripe < n4 ? z0 + stripe : n4;
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long i = z0 + threadIdx.x; i < z1; i += kFusedThreads)
    out4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) out[(n4 << 2) + threadIdx.x] = 0.f;
  cooperative_groups::this_grid().sync();

  // scatter: the batch's REDs, then the next batch's loads and REDs
  b.reduce(out, n);
  while (c < K) {
    b.load(idx, vals, w, K, k, groups, step, c, g);
    b.reduce(out, n);
  }
}

struct FusedGeom {
  int blocks_per_sm, grid;
  long long stripe;
};

// The fused launch for n outputs: blocks an SM (the occupancy query) and a
// grid of one block an SM, or as many as can be resident if that is fewer.
template <typename T>
int fused_geom(long long n, FusedGeom* g) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sparse_agg_fused_kernel<T>, kFusedThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int most = per_sm * sms;
  g->blocks_per_sm = per_sm;
  g->grid = kBlocksPerSm * sms < most ? kBlocksPerSm * sms : most;
  g->stripe = ((n >> 2) + g->grid - 1) / g->grid;
  return 0;
}

// What the fused route takes (kernels/sparse_agg.py::_route mirrors it).
bool fused_takes(const void* idx, const void* vals, int vals_bytes, const void* out,
                 long long k) {
  return k >= 4 && k % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(vals) % (4 * vals_bytes) == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

template <typename T>
int launch_fused(const void* idx, const void* vals, const void* w, void* out, int K,
                 long long k, long long n, void* stream) {
  if (K < 1 || n < 1 || !fused_takes(idx, vals, (int)sizeof(T), out, k))
    return (int)cudaErrorInvalidValue;
  FusedGeom g;
  const int rc = fused_geom<T>(n, &g);
  if (rc != 0) return rc;
  const int* idx_p = static_cast<const int*>(idx);
  const T* vals_p = static_cast<const T*>(vals);
  const float* w_p = static_cast<const float*>(w);
  float* out_p = static_cast<float*>(out);
  void* args[] = {&idx_p, &vals_p, &w_p, &out_p, &K, &k, &n, &g.stripe};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sparse_agg_fused_kernel<T>), dim3(g.grid),
      dim3(kFusedThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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

// the scatter route, into an output the caller has zeroed
int sparse_aggregate_f32(const void* idx, const void* vals, const void* w, void* out, int K,
                         long long k, long long n, void* stream) {
  return launch<float>(idx, vals, w, out, K, k, n, stream);
}

int sparse_aggregate_bf16(const void* idx, const void* vals, const void* w, void* out, int K,
                          long long k, long long n, void* stream) {
  return launch<__nv_bfloat16>(idx, vals, w, out, K, k, n, stream);
}

// the fused route, into an output it zeroes itself
int sparse_aggregate_fused_f32(const void* idx, const void* vals, const void* w, void* out,
                               int K, long long k, long long n, void* stream) {
  return launch_fused<float>(idx, vals, w, out, K, k, n, stream);
}

int sparse_aggregate_fused_bf16(const void* idx, const void* vals, const void* w, void* out,
                                int K, long long k, long long n, void* stream) {
  return launch_fused<__nv_bfloat16>(idx, vals, w, out, K, k, n, stream);
}

// The fused launch's geometry for n outputs into geom: threads a block,
// blocks an SM can hold, grid, items a thread has in flight, float4s of the
// output a block zeroes. vals_bytes: 4 (fp32) or 2 (bf16).
int sparse_aggregate_fused_plan(long long n, int vals_bytes, long long* geom) {
  FusedGeom g;
  const int rc = vals_bytes == 2 ? fused_geom<__nv_bfloat16>(n, &g)
                                 : fused_geom<float>(n, &g);
  if (rc != 0) return rc;
  geom[0] = kFusedThreads;
  geom[1] = g.blocks_per_sm;
  geom[2] = g.grid;
  geom[3] = kUnroll;
  geom[4] = g.stripe;
  return 0;
}

const char* sparse_aggregate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
