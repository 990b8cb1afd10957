// gossip_mix for Hopper (sm_90a): one neighbour-mixing step of the gossip lane
//
//     out[i, c] = sum_s w[i, s] * x[idx[i, s], c]     x: (n, N) fp32 or bf16
//                                                     idx: (n, D) int32, w: (n, D) fp32
//
// i.e. out = W @ X for the sparse mixing matrix W that the padded slots
// encode, accumulated in fp32 and written in the storage dtype. Duplicate ids
// add; a padded slot (idx = i, w = 0) adds nothing; an id outside [0, n)
// contributes 0 and is never read (the reference's one-hot semantics).
//
// Replaces repro/kernels/gossip_mix.py::gossip_mix (the Pallas _mix_kernel).
// That kernel expands a row block's ids into a one-hot (bn, n) slice of W
// and contracts it on the TPU's matrix unit, a workaround for dynamic row
// gathers that Mosaic lowers badly. What it keeps out of device memory is
// kept out here too: the full node axis of one column block sits in fast
// memory, so X is read once however many neighbours share a row.
//
// What bounds it: on the sparse plans of the main path (ring, D = 3; small
// world, D = 7) HBM bytes. X is read once and out written once, 8 bytes per
// fp32 element, against 2 * (non-zero slots / n) flops per element: far below
// the fp32 ridge. Only the full graph (D = n) is bound by its 2 * n * n * N
// flops over the fp32 (non-tensor-core) rate.
//
// The design: one block per column tile [c0, c0 + TILE). The block copies
// X[:, c0:c0+TILE] for all n nodes into shared memory (n * TILE elements;
// the caller picks TILE from n so that the tile fits), then each thread owns
// CV = 4 consecutive columns of the tile and a stride of rows: for row i it
// reads tile[idx[i, s]][col .. col+3] with one 16-byte (8 for bf16)
// shared-memory load per slot, accumulates w[i, s] times each of them in
// four fp32 registers, and writes out[i, c0+col .. c0+col+3]. Four columns a
// thread share each slot's (idx, w) pair, which are warp-uniform loads
// through the read-only cache: the per-slot cost is spread over four FMAs.
// Neighbouring threads hold neighbouring columns of one row, so the global
// loads and stores coalesce. Global accesses are LV elements wide: pairs
// when N is even and both pointers are aligned to a pair (both main N are 2
// mod 4, so only every other row of an fp32 (n, N) matrix starts 16-byte
// aligned, but every row starts 8-byte aligned), single elements otherwise.
// The last tile masks its ragged edge. Offsets are 64-bit.
//
// The C entry points return cudaGetLastError() after the launch (or the
// error of raising the block's shared-memory limit above 48 KB); the caller
// raises on a non-zero code. They launch on the stream they are given,
// allocate nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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

const char* gossip_mix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
