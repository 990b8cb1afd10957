// quantized_aggregate and packed_quantized_aggregate for Hopper (sm_90a):
// the quantize codec's server average, decode fused into the reduction
//
//     out[n] = sum_k w[k] * (q[k, n] * scale[k, c] / levels + lo[k, c]),   c = n / chunk
//
// accumulated in fp32. quantized_aggregate reads uint8 or uint16 codes
// (K, N_pad); packed_quantized_aggregate reads the bit-packed wire words
// (K, C * wpc), 32 / bits codes to a 32-bit word in chunk frames
// (utils/bitpack.py), for bits 1..15.
//
// Replaces repro/kernels/quantized_agg.py::quantized_aggregate (the Pallas
// _qagg_kernel, :41) and ::packed_quantized_aggregate (_packed_qagg_kernel,
// :169). Those dequantize a (K, block) VMEM tile and phrase the sum as a
// (K,) x (K, bn) dot_general for the TPU's matrix unit; on Hopper the work
// is a plain reduction over K with the decode folded into each term.
//
// What bounds it: HBM bytes. At K = 10 it does 4 flops (two fma) per code
// on 1 byte (q8) or half a byte (q4) of codes, plus 4 bytes of output per
// column: under one flop per byte moved, far below the fp32 ridge. The least
// time is the codes, the (lo, scale) pairs and the fp32 output over the
// memory rate. Every input byte is read once and every output byte written
// once; the dense (K, N) fp32 deltas never exist.
//
// Two routes (kernels/quantized_agg.py::_route picks one from shapes,
// dtypes, alignment and K):
//
// - stream, qagg_stream_kernel<BITS>: one template for uint8 codes (BITS 8),
//   uint16 codes (16) and packed words at bits 1, 2 and 4. Each of those
//   is a row of little-endian 32-bit words holding 32 / BITS codes, so code
//   j of word i is output i * 32 / BITS + j. It takes rows whose chunk is a
//   whole number of 16-byte granules of at least 64 bytes, on 16-byte
//   aligned pointers, and K <= kStreamMaxK. What it does about the bound:
//   * persistent blocks (up to four an SM for codes, two for packed words,
//     from the occupancy query), each with an even, contiguous share of the
//     row bytes, walked as column tiles of kTileBytes a row. A tile's K row
//     slices arrive by 1-D TMA bulk copies (cp.async.bulk ...
//     mbarrier::complete_tx, one thread issues them) into a ring of two
//     shared-memory stages, one mbarrier a stage: the next tile is asked
//     for as soon as the current one lands, so it is in flight while the
//     current one is decoded, with no registers held for it. The tile's
//     (lo, scale) pairs ride
//     along by 4-byte cp.async into the same stage, tracked by the same
//     mbarrier (cp.async.mbarrier.arrive.noinc); step = scale / levels is
//     computed once per (k, chunk) of a tile, not per thread.
//   * no I2F: a code becomes a float by its bits, 0x4B000000 | q (2^23 + q)
//     by __byte_perm for byte and half-word codes and by mask-and-or for
//     1-, 2- and 4-bit fields, minus 2^23: exactly float(q) for q < 2^23.
//     The sum is the general route's fmaf(w, fmaf(q, step, lo), acc) in the
//     same k order, so the two routes agree bit for bit.
//   * coalesced streaming stores: each warp stages its outputs in shared
//     memory and writes them as whole 16-byte rows, 512 contiguous bytes a
//     warp instruction (st.global.cs), where the general route's lanes sit
//     32 or 64 bytes apart and write each sector in parts.
//   What holds it (kernels/probe.py's timeline and cuts, on an H100): with
//   a block's whole share in flight from the start, the tiles landed all
//   together and were then decoded one after another; asking for one tile
//   ahead lands them in order and took a seventh off the q8 time. The decode
//   and fma pair stays the critical path (cut out, the kernel is
//   markedly faster), the stores are not. A producer warp, a barrier a row
//   slice, per-thread cp.async in place of TMA, 4 KB tiles and 256-thread
//   blocks were each slower on some of the four main shapes.
// - general, qagg_kernel / packed_qagg_kernel: everything else (odd chunks,
//   misaligned views, bits that do not divide 32, large K). They are
//   grid-stride kernels with one pass per thread:
//   * quantized_aggregate: each thread owns VEC contiguous codes of one
//     column range and reads them with one access per row, 16 bytes where
//     the chunk and the pointers' alignment allow (16 uint8 or 8 uint16
//     codes), down to one code (the scalar path). chunk is a multiple of
//     VEC, so the VEC codes share one chunk and one (lo, scale) pair per
//     row. The thread loops over K in fp32 registers and writes its VEC
//     outputs with 16-byte stores.
//   * packed_quantized_aggregate: each thread owns one word column of one
//     chunk frame: per row one coalesced 4-byte load, 32 / bits
//     shift-and-mask unpacks (templated on bits, so they unroll), the same
//     fma pair per code, and the slack codes past `chunk` in a frame's last
//     word are dropped at the store.
//   The K loops are unrolled so that several rows' loads are in flight per
//   thread. Offsets are 64-bit.
//
// The C entry points return cudaGetLastError() after the launch; the
// caller raises on a non-zero code. They launch on the stream they are
// given, allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <int VEC>
__device__ __forceinline__ void store_f32(float* out, const float (&acc)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4)
      *reinterpret_cast<float4*>(out + j) =
          make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(out) = make_float2(acc[0], acc[1]);
  } else {
    out[0] = acc[0];
  }
}

long long grid_for(long long items) {
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : blocks;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
qagg_kernel(const T* __restrict__ codes, const float* __restrict__ lo,
            const float* __restrict__ scale, const float* __restrict__ w,
            float* __restrict__ out, int K, long long n_pad, long long C, int chunk,
            float levels) {
  extern __shared__ float sw[];
  for (int k = threadIdx.x; k < K; k += blockDim.x) sw[k] = w[k];
  __syncthreads();

  using P = Pack<T, VEC>;
  const long long n_vec = n_pad / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n_vec;
       v += stride) {
    const long long col = v * VEC;
    const long long c = col / chunk;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const P p = *reinterpret_cast<const P*>(codes + (long long)k * n_pad + col);
      const float step = scale[(long long)k * C + c] / levels;
      const float l = lo[(long long)k * C + c];
      const float wk = sw[k];
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[j] = fmaf(wk, fmaf(static_cast<float>(p.v[j]), step, l), acc[j]);
    }
    store_f32<VEC>(out + col, acc);
  }
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
packed_qagg_kernel(const uint32_t* __restrict__ words, const float* __restrict__ lo,
                   const float* __restrict__ scale, const float* __restrict__ w,
                   float* __restrict__ out, int K, long long C, int chunk, int wpc,
                   float levels) {
  constexpr int PPW = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  extern __shared__ float sw[];
  for (int k = threadIdx.x; k < K; k += blockDim.x) sw[k] = w[k];
  __syncthreads();

  const long long n_words = C * wpc;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n_words;
       t += stride) {
    const long long c = t / wpc;
    const int first = (int)(t - c * wpc) * PPW;   // this word's first code in its chunk
    float acc[PPW];
#pragma unroll
    for (int j = 0; j < PPW; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const uint32_t word = words[(long long)k * n_words + t];
      const float step = scale[(long long)k * C + c] / levels;
      const float l = lo[(long long)k * C + c];
      const float wk = sw[k];
#pragma unroll
      for (int j = 0; j < PPW; ++j) {
        const float q = static_cast<float>((word >> (j * BITS)) & MASK);
        acc[j] = fmaf(wk, fmaf(q, step, l), acc[j]);
      }
    }
    float* o = out + c * chunk + first;
#pragma unroll
    for (int j = 0; j < PPW; ++j)
      if (first + j < chunk) o[j] = acc[j];
  }
}

// The widest VEC (codes per access) that divides chunk, keeps the codes
// aligned to VEC * sizeof(T) bytes and the output to its store width.
template <typename T>
int pick_vec(const void* codes, const void* out, int chunk) {
  const uintptr_t c = reinterpret_cast<uintptr_t>(codes);
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  int vec = 16 / (int)sizeof(T);
  while (vec > 1 && (chunk % vec != 0 || c % (vec * sizeof(T)) != 0 ||
                     o % (vec >= 4 ? 16 : vec * 4) != 0))
    vec /= 2;
  return vec;
}

template <typename T, int VEC>
void launch_vec(const void* codes, const void* lo, const void* scale, const void* w,
                void* out, int K, long long n_pad, int chunk, int levels, cudaStream_t s) {
  qagg_kernel<T, VEC><<<(unsigned)grid_for(n_pad / VEC), kThreads, K * sizeof(float), s>>>(
      static_cast<const T*>(codes), static_cast<const float*>(lo),
      static_cast<const float*>(scale), static_cast<const float*>(w),
      static_cast<float*>(out), K, n_pad, n_pad / chunk, chunk, (float)levels);
}

template <typename T>
int launch_qagg(const void* codes, const void* lo, const void* scale, const void* w,
                void* out, int K, long long n_pad, int chunk, int levels, void* stream) {
  if (K < 1 || n_pad < 1 || chunk < 1 || levels < 1 || n_pad % chunk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pick_vec<T>(codes, out, chunk)) {
    case 16:
      if constexpr (sizeof(T) == 1)
        launch_vec<T, 16>(codes, lo, scale, w, out, K, n_pad, chunk, levels, s);
      break;
    case 8: launch_vec<T, 8>(codes, lo, scale, w, out, K, n_pad, chunk, levels, s); break;
    case 4: launch_vec<T, 4>(codes, lo, scale, w, out, K, n_pad, chunk, levels, s); break;
    case 2: launch_vec<T, 2>(codes, lo, scale, w, out, K, n_pad, chunk, levels, s); break;
    default: launch_vec<T, 1>(codes, lo, scale, w, out, K, n_pad, chunk, levels, s); break;
  }
  return (int)cudaGetLastError();
}

template <int BITS>
void launch_packed(const void* words, const void* lo, const void* scale, const void* w,
                   void* out, int K, long long C, int chunk, int levels, cudaStream_t s) {
  constexpr int PPW = 32 / BITS;
  const int wpc = (chunk + PPW - 1) / PPW;
  packed_qagg_kernel<BITS><<<(unsigned)grid_for(C * wpc), kThreads, K * sizeof(float), s>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(lo),
      static_cast<const float*>(scale), static_cast<const float*>(w),
      static_cast<float*>(out), K, C, chunk, wpc, (float)levels);
}


// ---------------------------------------------------------------------------
// the stream route
// ---------------------------------------------------------------------------

constexpr int kStreamThreads = 128;           // 4 warps
constexpr int kTileBytes = 2048;              // one row's slice of a column tile
constexpr int kStages = 2;                    // the tile being decoded and the next
constexpr int kStreamMaxK = 32;               // 2 stages of 32 x 2 KB rows: 128 KB
constexpr int kMinChunkBytes = 64;            // bounds a tile's (lo, scale) table
constexpr int kSmemLimit = 232448;            // a block's dynamic shared memory, at most

// Blocks an SM, at most: byte and half-word codes decode one or two codes a
// byte and gain from four blocks' tiles in flight; packed words decode two
// to eight, and their decode slows when more than two blocks share an SM
// (kernels/probe.py times both).
template <int BITS>
constexpr int max_blocks_per_sm() {
  return BITS >= 8 ? 4 : 2;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(async_copy::smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Arrive on `bar` and add `bytes` to the transactions its phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   async_copy::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_arrive_after_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   async_copy::smem_addr(bar))
               : "memory");
}

// Spin until the phase of `bar` with this parity has completed. A phase that
// never completes traps (the launch fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = async_copy::smem_addr(bar);
  for (unsigned spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 28)) __trap();
  }
}

// 1-D TMA: `bytes` (a multiple of 16) from global to shared memory, both
// 16-byte aligned; completion is counted on `bar` in bytes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(async_copy::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(async_copy::smem_addr(bar))
      : "memory");
}

// Code j of a 32-bit word as an exact float, without I2F: the code's bits
// under the exponent of 2^23, minus 2^23.
template <int BITS>
__device__ __forceinline__ float decode(uint32_t word, int j) {
  uint32_t bits;
  if constexpr (BITS == 8) {
    bits = __byte_perm(word, 0x4B000000u, 0x7440u | j);
  } else if constexpr (BITS == 16) {
    bits = __byte_perm(word, 0x4B000000u, 0x7400u | ((2 * j + 1) << 4) | (2 * j));
  } else {
    bits = ((word >> (j * BITS)) & ((1u << BITS) - 1u)) | 0x4B000000u;
  }
  return __int_as_float(bits) - 8388608.f;
}

template <int BITS>
struct StreamShape {
  static constexpr int kCodesPerWord = 32 / BITS;
  static constexpr int kWords = BITS < 4 ? BITS : 4;            // a thread's words a row
  static constexpr int kCodes = kWords * kCodesPerWord;         // ... and codes: 8 to 32
  static constexpr int kUnitBytes = 4 * kWords;
  static constexpr int kPasses = kTileBytes / kUnitBytes / kStreamThreads;
  static constexpr int kStageStride = kCodes + 4;   // floats a lane in the store staging
  static_assert(kPasses * kUnitBytes * kStreamThreads == kTileBytes, "units tile a row");
};

// Shared memory of one block: the ring's stages of K row slices, one
// mbarrier a stage, the warps' store staging, each stage's (lo, step)
// table and the weights.
struct StreamLayout {
  int nctm;   // chunks one tile row can touch
  size_t bars, staging, table, weights, total;   // byte offsets; the ring at 0
};

template <int BITS>
__host__ __device__ StreamLayout stream_layout(int K, int chunk_bytes) {
  using S = StreamShape<BITS>;
  StreamLayout L;
  L.nctm = (kTileBytes - 1) / chunk_bytes + 2;
  L.bars = (size_t)kStages * K * kTileBytes;
  L.staging = L.bars + (kStages * sizeof(uint64_t) + 15) / 16 * 16;
  L.table = L.staging + (size_t)(kStreamThreads / 32) * 32 * S::kStageStride * sizeof(float);
  L.weights = L.table + (size_t)kStages * K * L.nctm * sizeof(float2);
  L.total = L.weights + (size_t)K * sizeof(float);
  return L;
}

// The warp's 32 units of outputs (kCodes floats a lane, contiguous across
// the warp) through shared memory to 16-byte rows: each store instruction
// writes 512 contiguous bytes. Units past `valid` are not written.
template <int BITS>
__device__ __forceinline__ void store_rows(float* staging,
                                           const float (&acc)[StreamShape<BITS>::kCodes],
                                           float* out, int lane, int valid) {
  using S = StreamShape<BITS>;
#pragma unroll
  for (int j = 0; j < S::kCodes; j += 4)
    *reinterpret_cast<float4*>(staging + lane * S::kStageStride + j) =
        make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < S::kCodes / 4; ++r) {
    const int f = (r * 32 + lane) * 4;   // float of the warp's span
    const int unit = f / S::kCodes;
    if (unit < valid)
      __stcs(reinterpret_cast<float4*>(out + f),
             *reinterpret_cast<const float4*>(staging + unit * S::kStageStride + f % S::kCodes));
  }
  __syncwarp();
}

template <int BITS>
__global__ void __launch_bounds__(kStreamThreads)
qagg_stream_kernel(const uint8_t* __restrict__ payload, const float* __restrict__ lo,
                   const float* __restrict__ scale, const float* __restrict__ w,
                   float* __restrict__ out, int K, long long C, int chunk_bytes,
                   float levels) {
  using S = StreamShape<BITS>;
  const StreamLayout L = stream_layout<BITS>(K, chunk_bytes);
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  float2* table = reinterpret_cast<float2*>(smem + L.table);
  float* sw = reinterpret_cast<float*>(smem + L.weights);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float* staging = reinterpret_cast<float*>(smem + L.staging) + warp * 32 * S::kStageStride;

  // This block's even share of the row, in 16-byte granules, as tiles; the
  // chunk its first byte lies in and that byte's offset there.
  const long long row_bytes = C * chunk_bytes;
  const long long granules = row_bytes / 16;
  const long long begin = granules * blockIdx.x / gridDim.x * 16;
  const long long end = granules * (blockIdx.x + 1) / gridDim.x * 16;
  const int n_tiles = (int)((end - begin + kTileBytes - 1) / kTileBytes);
  const long long c_begin = begin / chunk_bytes;
  const unsigned r_begin = (unsigned)(begin - c_begin * chunk_bytes);

  if (tid == 0) {
    // thread 0's expect_tx arrival, then every thread's after its copies
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], kStreamThreads + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile i of the block: its first byte, bytes, first chunk, offset in it
  // and chunks touched (32-bit arithmetic past the block's first chunk).
  struct Tile {
    long long b0, c0;
    int bytes, r0, nct;
  };
  auto tile = [&](int i) {
    Tile T;
    const unsigned off = r_begin + (unsigned)i * kTileBytes;
    T.b0 = begin + (long long)i * kTileBytes;
    T.bytes = (int)min((long long)kTileBytes, end - T.b0);
    T.c0 = c_begin + off / chunk_bytes;
    T.r0 = (int)(off % chunk_bytes);
    T.nct = (T.r0 + T.bytes - 1) / chunk_bytes + 1;
    return T;
  };

  // Tile i's K row slices by TMA and its (lo, scale) pairs by cp.async into
  // stage s. `copy` false arrives without copying (kernels/probe.py cuts the
  // refills that way).
  auto issue = [&](int i, int s, bool copy) {
    const Tile T = tile(i);
    if (tid == 0) {
      // the block's reads of stage s (generic proxy) before TMA writes it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive_expect_tx(&full[s], copy ? (unsigned)(K * T.bytes) : 0u);
      if (copy)
        for (int k = 0; k < K; ++k)
          bulk_copy(smem + ((size_t)s * K + k) * kTileBytes, payload + k * row_bytes + T.b0,
                    (unsigned)T.bytes, &full[s]);
    }
    if (copy) {
      for (int e = tid; e < K * T.nct; e += kStreamThreads) {
        const int k = e / T.nct, ci = e - k * T.nct;
        float2* d = table + ((size_t)s * K + k) * L.nctm + ci;
        async_copy::copy<4>(&d->x, lo + k * C + T.c0 + ci);
        async_copy::copy<4>(&d->y, scale + k * C + T.c0 + ci);
      }
    }
    mbar_arrive_after_copies(&full[s]);
  };

  issue(0, 0, /*copy=*/true);
  // the weights' load waits behind the first tile's copies; the first
  // __syncthreads below publishes them
  for (int k = tid; k < K; k += kStreamThreads) sw[k] = w[k];
  int s = 0;
  unsigned parity = 0;
  for (int i = 0; i < n_tiles; ++i) {
    mbar_wait(&full[s], parity);
    // Tile i has landed: ask for tile i + 1, into the other stage, which
    // the block finished with before the last __syncthreads. One tile in
    // flight a block keeps the tiles landing in order, each while the one
    // before is decoded, where a block's whole share in flight at once
    // lands all together and is then decoded tile after tile.
    if (i + 1 < n_tiles) issue(i + 1, s ^ 1, /*copy=*/true);
    const Tile T = tile(i);
    float2* tab = table + (size_t)s * K * L.nctm;
    for (int e = tid; e < K * T.nct; e += kStreamThreads) {
      float2* d = tab + (e / T.nct) * L.nctm + e % T.nct;
      d->y = d->y / levels;   // step, once per (k, chunk) of the tile
    }
    __syncthreads();

    const unsigned char* rows = smem + (size_t)s * K * kTileBytes;
#pragma unroll 1
    for (int p = 0; p < S::kPasses; ++p) {
      const int u0 = (p * kStreamThreads + warp * 32) * S::kUnitBytes;   // the warp's first
      const int ub = u0 + lane * S::kUnitBytes;                          // this thread's
      float acc[S::kCodes];
#pragma unroll
      for (int j = 0; j < S::kCodes; ++j) acc[j] = 0.f;
      if (ub < T.bytes) {
        const int ci = (T.r0 + ub) / chunk_bytes;
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          uint32_t wd[S::kWords];
          const unsigned char* src = rows + k * kTileBytes + ub;
          if constexpr (S::kWords == 4) {
            const uint4 v = *reinterpret_cast<const uint4*>(src);
            wd[0] = v.x, wd[1] = v.y, wd[2] = v.z, wd[3] = v.w;
          } else if constexpr (S::kWords == 2) {
            const uint2 v = *reinterpret_cast<const uint2*>(src);
            wd[0] = v.x, wd[1] = v.y;
          } else {
            wd[0] = *reinterpret_cast<const uint32_t*>(src);
          }
          const float2 ls = tab[k * L.nctm + ci];
          const float wk = sw[k];
#pragma unroll
          for (int q = 0; q < S::kWords; ++q)
#pragma unroll
            for (int j = 0; j < S::kCodesPerWord; ++j)
              acc[q * S::kCodesPerWord + j] = fmaf(
                  wk, fmaf(decode<BITS>(wd[q], j), ls.y, ls.x), acc[q * S::kCodesPerWord + j]);
        }
      }
      int valid = (T.bytes - u0) / S::kUnitBytes;
      valid = valid < 0 ? 0 : valid > 32 ? 32 : valid;
      store_rows<BITS>(staging, acc, out + (T.b0 + u0) / 4 * S::kCodesPerWord, lane, valid);
    }
    __syncthreads();   // every thread is done with stage s
    s ^= 1;
    if (s == 0) parity ^= 1u;
  }
}

struct StreamGeom {
  StreamLayout layout;
  int blocks_per_sm, grid;
};

// The launch of qagg_stream_kernel<BITS> for K rows of C chunks of
// chunk_bytes: shared memory, blocks an SM (the occupancy query, at most
// max_blocks_per_sm) and a grid of that many an SM, or fewer when the row has
// fewer tiles. Returns a CUDA error code.
template <int BITS>
int stream_geom(int K, long long C, int chunk_bytes, StreamGeom* g) {
  g->layout = stream_layout<BITS>(K, chunk_bytes);
  const size_t smem = g->layout.total;
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(qagg_stream_kernel<BITS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qagg_stream_kernel<BITS>,
                                                    kStreamThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  g->blocks_per_sm = per_sm < max_blocks_per_sm<BITS>() ? per_sm : max_blocks_per_sm<BITS>();
  const long long tiles = (C * chunk_bytes + kTileBytes - 1) / kTileBytes;
  const long long most = (long long)g->blocks_per_sm * sms;
  g->grid = (int)(tiles < most ? tiles : most);
  return 0;
}

// What the stream route takes (kernels/quantized_agg.py::_route mirrors it).
bool stream_takes(const void* payload, const void* out, int K, int chunk, int bits) {
  const long long chunk_bits = (long long)chunk * bits;
  return (bits == 1 || bits == 2 || bits == 4 || bits == 8 || bits == 16) && K >= 1 &&
         K <= kStreamMaxK && chunk_bits % 128 == 0 && chunk_bits >= 8 * kMinChunkBytes &&
         reinterpret_cast<uintptr_t>(payload) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

template <int BITS>
int launch_stream(const void* payload, const void* lo, const void* scale, const void* w,
                  void* out, int K, long long C, int chunk, int levels, cudaStream_t s) {
  const int chunk_bytes = (int)((long long)chunk * BITS / 8);
  StreamGeom g;
  const int rc = stream_geom<BITS>(K, C, chunk_bytes, &g);
  if (rc != 0) return rc;
  qagg_stream_kernel<BITS><<<g.grid, kStreamThreads, g.layout.total, s>>>(
      static_cast<const uint8_t*>(payload), static_cast<const float*>(lo),
      static_cast<const float*>(scale), static_cast<const float*>(w),
      static_cast<float*>(out), K, C, chunk_bytes, (float)levels);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int quantized_aggregate_u8(const void* codes, const void* lo, const void* scale,
                           const void* w, void* out, int K, long long n_pad, int chunk,
                           int levels, void* stream) {
  return launch_qagg<uint8_t>(codes, lo, scale, w, out, K, n_pad, chunk, levels, stream);
}

int quantized_aggregate_u16(const void* codes, const void* lo, const void* scale,
                            const void* w, void* out, int K, long long n_pad, int chunk,
                            int levels, void* stream) {
  return launch_qagg<uint16_t>(codes, lo, scale, w, out, K, n_pad, chunk, levels, stream);
}

// Codes per access the launch above picks for these pointers and chunk.
int quantized_aggregate_vec(const void* codes, const void* out, int chunk, int elem_bytes) {
  return elem_bytes == 2 ? pick_vec<uint16_t>(codes, out, chunk)
                         : pick_vec<uint8_t>(codes, out, chunk);
}

int packed_quantized_aggregate(const void* words, const void* lo, const void* scale,
                               const void* w, void* out, int K, long long C, int chunk,
                               int bits, int levels, void* stream) {
  if (K < 1 || C < 1 || chunk < 1 || levels < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
#define REPRO_PACKED_CASE(B) \
    case B: launch_packed<B>(words, lo, scale, w, out, K, C, chunk, levels, s); break;
    REPRO_PACKED_CASE(1) REPRO_PACKED_CASE(2) REPRO_PACKED_CASE(3) REPRO_PACKED_CASE(4)
    REPRO_PACKED_CASE(5) REPRO_PACKED_CASE(6) REPRO_PACKED_CASE(7) REPRO_PACKED_CASE(8)
    REPRO_PACKED_CASE(9) REPRO_PACKED_CASE(10) REPRO_PACKED_CASE(11) REPRO_PACKED_CASE(12)
    REPRO_PACKED_CASE(13) REPRO_PACKED_CASE(14) REPRO_PACKED_CASE(15)
#undef REPRO_PACKED_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The stream route: uint8 (bits 8) or uint16 (bits 16) codes, or packed
// words at bits 1, 2 or 4; (K, C * chunk * bits / 8 bytes) rows.
int quantized_aggregate_stream(const void* payload, const void* lo, const void* scale,
                               const void* w, void* out, int K, long long C, int chunk,
                               int bits, int levels, void* stream) {
  if (C < 1 || levels < 1 || !stream_takes(payload, out, K, chunk, bits))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return launch_stream<1>(payload, lo, scale, w, out, K, C, chunk, levels, s);
    case 2: return launch_stream<2>(payload, lo, scale, w, out, K, C, chunk, levels, s);
    case 4: return launch_stream<4>(payload, lo, scale, w, out, K, C, chunk, levels, s);
    case 8: return launch_stream<8>(payload, lo, scale, w, out, K, C, chunk, levels, s);
    default: return launch_stream<16>(payload, lo, scale, w, out, K, C, chunk, levels, s);
  }
}

// The stream route's launch for these sizes: geom = {threads, tile bytes a
// row, stages, dynamic shared memory, blocks an SM, grid}.
int quantized_aggregate_stream_plan(int K, long long C, int chunk, int bits, int* geom) {
  if (C < 1 || !stream_takes(nullptr, nullptr, K, chunk, bits)) return (int)cudaErrorInvalidValue;
  const int chunk_bytes = (int)((long long)chunk * bits / 8);
  StreamGeom g;
  int rc;
  switch (bits) {
    case 1: rc = stream_geom<1>(K, C, chunk_bytes, &g); break;
    case 2: rc = stream_geom<2>(K, C, chunk_bytes, &g); break;
    case 4: rc = stream_geom<4>(K, C, chunk_bytes, &g); break;
    case 8: rc = stream_geom<8>(K, C, chunk_bytes, &g); break;
    default: rc = stream_geom<16>(K, C, chunk_bytes, &g); break;
  }
  if (rc != 0) return rc;
  const int v[6] = {kStreamThreads, kTileBytes, kStages, (int)g.layout.total,
                    g.blocks_per_sm, g.grid};
  for (int j = 0; j < 6; ++j) geom[j] = v[j];
  return 0;
}

const char* quantized_aggregate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
