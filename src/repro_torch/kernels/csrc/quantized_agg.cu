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
// _qagg_kernel) and ::packed_quantized_aggregate (_packed_qagg_kernel). Those
// dequantize a (K, block) VMEM tile and phrase the sum as a (K,) x (K, bn)
// dot_general for the TPU's matrix unit; on Hopper the work is a plain
// reduction over K with the decode folded into each term.
//
// What bounds it: HBM bytes. At K = 10 it does 4 flops (two fma) per code
// on 1 byte (q8) or half a byte (q4) of codes, plus 4 bytes of output per
// column: under one flop per byte moved, far below the fp32 ridge. The least
// time is the codes, the (lo, scale) pairs and the fp32 output over the
// memory rate.
//
// What the design does about it: every input byte is read once and every
// output byte written once; the dense (K, N) fp32 deltas never exist. The
// (K,) weights go to shared memory once per block.
// - quantized_aggregate: each thread owns VEC contiguous codes of one column
//   range and reads them with one access per row, 16 bytes where the chunk
//   and the pointers' alignment allow (16 uint8 or 8 uint16 codes), down to
//   one code (the scalar path). chunk is a multiple of VEC, so the VEC codes
//   share one chunk and one (lo, scale) pair per row; a warp's 32 threads
//   mostly share it too, so those loads are broadcasts. The thread loops over
//   K in fp32 registers and writes its VEC outputs with 16-byte stores.
// - packed_quantized_aggregate: each thread owns one word column of one
//   chunk frame: per row one coalesced 4-byte load, 32 / bits shift-and-mask
//   unpacks (the kernel is templated on bits, so they unroll), the same
//   fma pair per code, and the slack codes past `chunk` in a frame's last
//   word are dropped at the store.
// The K loops are unrolled so that several rows' loads are in flight per
// thread. Offsets are 64-bit. Grid-stride loops cover any size.
//
// The C entry points return cudaGetLastError() after the launch; the
// caller raises on a non-zero code. They launch on the stream they are
// given, allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

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

const char* quantized_aggregate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
