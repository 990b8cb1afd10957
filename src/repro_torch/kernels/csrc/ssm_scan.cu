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
// independent, are spread across the card and each walks T in registers.
//
// What bounds it: at the Jamba prefill shape (B = 4, T = 2048, D = 8192,
// N = 16) dt, x and y are 805 MB in fp32 (B and C 1 MB), 0.24 ms at 3.35 TB/s,
// and the B * T * D * N = 1.07 G exponentials take 0.26 ms on the
// special-function units (16 a clock per SM, 132 SMs, 1.98 GHz; a
// calibration kernel reaches that rate on an H100), so the bound is the
// exponentials. Each is one ex2 of dt * (A log2 e), A log2 e formed once per
// channel, as ex2.approx.ftz.f32 (exp2f adds a range fix-up around the same
// instruction; a result below 2^-126 flushes to 0, which the state's decay
// makes harmless, and the fp32 check of 1e-5 of the scale holds). Around
// each exponential a state needs four fp32 operations (dt * a, dt x * B, the
// update, the product with C), so the issue slots, not the exponentials
// alone, decide how close the scan gets.
//
// The design, ssm_scan_ring_kernel<T, NS, L>:
//   - N split across L lanes. N is padded to NS = 4, 8 or 16 states (the
//     padded ones stay 0); each channel's states are split across L = 1, 2
//     or 4 neighbouring lanes of a warp, NS / L in each lane's registers. A
//     lane sums its part of y_t = h_t . C_t in four interleaved sums and a
//     tree; the L parts are combined by __shfl_xor_sync (distance 1, then
//     2) and lane 0 writes y_t. More lanes, more warps an SM (B * D * L
//     threads: 16 warps an SM at L = 2 on the prefill shape) to hide each
//     step's latency, at the price of the per-step work each lane repeats
//     (dt, x, the shuffle). kernels/ssm_scan.py::launch_plan picks L from
//     chip_smoke.py phase 4: 2, for prefill and for decode.
//   - A time ring in shared memory. A block covers kCh = 64 channels of one
//     batch row; its next runs of kTT = 16 steps of dt, x (64 channels a
//     row), B and C stream in through a kStages = 3 stage cp.async ring
//     while it scans the current run, one __syncthreads a run handing a
//     stage over. Each input is copied in the widest of 16, 8 or 4 bytes
//     that its pointer, strides and extent allow (a bf16 row off a 4-byte
//     boundary takes plain loads). B and C are read as float4s.
//   - A whole run is unrolled with no guard, so the compiler schedules a
//     step's loads and exponentials under the previous step's chain; the
//     last, short run goes step by step.
//   - y is staged in shared memory and stored a run at a time, a row of 64
//     channels as 16-byte vectors where D allows. In decode (T = 1), h0, A
//     and h_out move as whole 16-byte vectors a lane.
//   - The last block of a row masks the ragged edge of D (the Pallas kernel
//     asserts D % block_d == 0). Offsets are 64-bit.
//
// On an H100 SXM at 700 W (PERF.md; chip_smoke.py phase 4 and
// kernels/probe.py): 0.47 ms at the prefill shape at L = 2, 54% of the
// bound, against 0.86 ms for the one-thread-a-channel kernel it replaces;
// 9 us a decode step (was 27). With the loads and the y stores cut out the
// scan takes 0.35 ms; with the exponentials cut out, 0.48 ms, no less than
// with them: the issue slots of the 60-odd instructions a lane spends on a
// step hold it, not the special-function units.
//
// The C entry points return cudaGetLastError() after the launch; the caller
// raises on a non-zero code. They launch on the stream they are given,
// allocate nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "async_copy.cuh"

namespace {

constexpr int kTT = 16;      // time steps a run
constexpr int kMaxN = 16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

constexpr int kCh = 64;      // channels a block covers
constexpr int kStages = 3;   // the time ring: runs r + 1 and r + 2 load while run r scans

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

// Bytes each thread's cp.async copies for one input, or 0: staged by plain
// element loads (bf16 rows off a 4-byte boundary).
struct Granules {
  int dt, x, B, C;
};

struct Args {
  int T, D, N;
  long long dt_b, dt_t, x_b, x_t, B_b, B_t, C_b, C_t;   // strides in elements
  Granules g;
  int vec_state;   // N = NS (4, 8 or 16) and A, h0, h_out on 16-byte boundaries
  int vec_y;       // D a multiple of 16 bytes' elements: y rows stored as 16-byte vectors
};

// Stage rows [t0, t0 + nt) of one input, `width` elements each from column
// `col0` (masked at `extent`), into dst[tt][0 .. width) with row pitch
// `pitch`, `gbytes` bytes a copy. The host picked gbytes so that every copy
// is aligned and never straddles `extent`.
template <int GBYTES, typename T>
__device__ __forceinline__ void stage_rows_g(T* dst, int pitch, const T* src, long long st_t,
                                             int t0, int nt, int col0, int width, int extent) {
  constexpr int g = GBYTES ? GBYTES / (int)sizeof(T) : 1;
  const int lg = __ffs(width / g) - 1;   // width and g are powers of two
  for (int e = threadIdx.x; e < nt << lg; e += blockDim.x) {
    const int tt = e >> lg, c = (e & ((1 << lg) - 1)) * g;
    if (col0 + c >= extent) continue;
    const T* from = src + (long long)(t0 + tt) * st_t + col0 + c;
    T* to = dst + tt * pitch + c;
    if constexpr (GBYTES == 0) {
      *to = *from;
    } else {
      async_copy::copy<GBYTES>(to, from);
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int pitch, const T* src, long long st_t,
                                           int t0, int nt, int col0, int width, int extent,
                                           int gbytes) {
  switch (gbytes) {
    case 16: stage_rows_g<16>(dst, pitch, src, st_t, t0, nt, col0, width, extent); break;
    case 8: stage_rows_g<8>(dst, pitch, src, st_t, t0, nt, col0, width, extent); break;
    case 4: stage_rows_g<4>(dst, pitch, src, st_t, t0, nt, col0, width, extent); break;
    default: stage_rows_g<0>(dst, pitch, src, st_t, t0, nt, col0, width, extent);
  }
}

// NSL = NS / L states of channel d in registers of each of its L lanes (the
// L neighbouring threads of a warp); y_t = sum of the lanes' partial dot
// products, combined by __shfl_xor_sync and written by lane 0.
template <typename T, int NS, int L>
__global__ void __launch_bounds__(kCh * L)
ssm_scan_ring_kernel(const T* __restrict__ dt, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const T* __restrict__ x,
                     const float* __restrict__ A, const float* __restrict__ h0,
                     T* __restrict__ y, float* __restrict__ h_out, float* __restrict__ ck,
                     Args a) {
  constexpr int NSL = NS / L;
  static_assert(NS % L == 0 && (L == 1 || L == 2 || L == 4), "2^k lanes split NS states");
  __shared__ __align__(16) T s_dt[kStages][kTT][kCh];
  __shared__ __align__(16) T s_x[kStages][kTT][kCh];
  __shared__ __align__(16) T s_B[kStages][kTT][NS];
  __shared__ __align__(16) T s_C[kStages][kTT][NS];
  __shared__ float s_y[2][kTT][kCh];
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int ch = threadIdx.x / L, lane = threadIdx.x % L;
  const int d = d0 + ch;
  const bool live = d < a.D;
  const int n0 = lane * NSL;
  const long long hrow = ((long long)b * a.D + d) * a.N;

  // B and C past N stay 0 in every stage: the padded states stay 0 and add
  // nothing to y.
  for (int e = threadIdx.x; e < kStages * kTT * NS; e += blockDim.x) {
    (&s_B[0][0][0])[e] = T(0.f);
    (&s_C[0][0][0])[e] = T(0.f);
  }
  __syncthreads();

  float a2[NSL], h[NSL];
  bool loaded = false;
  if constexpr (NSL % 4 == 0) {
    if (a.vec_state && live) {   // whole 16-byte vectors a lane
#pragma unroll
      for (int i = 0; i < NSL; i += 4) {
        const float4 av = *reinterpret_cast<const float4*>(A + (long long)d * a.N + n0 + i);
        const float4 hv = *reinterpret_cast<const float4*>(h0 + hrow + n0 + i);
        a2[i] = av.x * kLog2e;
        a2[i + 1] = av.y * kLog2e;
        a2[i + 2] = av.z * kLog2e;
        a2[i + 3] = av.w * kLog2e;
        h[i] = hv.x;
        h[i + 1] = hv.y;
        h[i + 2] = hv.z;
        h[i + 3] = hv.w;
      }
      loaded = true;
    }
  }
  if (!loaded) {
#pragma unroll
    for (int i = 0; i < NSL; ++i) {
      const bool ok = live && n0 + i < a.N;
      a2[i] = ok ? A[(long long)d * a.N + n0 + i] * kLog2e : 0.f;
      h[i] = ok ? h0[hrow + n0 + i] : 0.f;
    }
  }

  const T* dtb = dt + b * a.dt_b;
  const T* xb = x + b * a.x_b;
  const T* Bb = Bm + b * a.B_b;
  const T* Cb = Cm + b * a.C_b;
  const int runs = (a.T + kTT - 1) / kTT;

  // Stage run r (if there is one) and commit a group either way, so that
  // wait<kStages - 2> always means "run r + 1 and later may be in flight".
  auto issue = [&](int r) {
    if (r < runs) {
      const int st = r % kStages, t0 = r * kTT, nt = min(kTT, a.T - t0);
      stage_rows(&s_dt[st][0][0], kCh, dtb, a.dt_t, t0, nt, d0, kCh, a.D, a.g.dt);
      stage_rows(&s_x[st][0][0], kCh, xb, a.x_t, t0, nt, d0, kCh, a.D, a.g.x);
      stage_rows(&s_B[st][0][0], NS, Bb, a.B_t, t0, nt, 0, NS, a.N, a.g.B);
      stage_rows(&s_C[st][0][0], NS, Cb, a.C_t, t0, nt, 0, NS, a.N, a.g.C);
    }
    async_copy::commit();
  };
  // y of run r, staged in s_y[r & 1], stored a row of kCh channels at a time:
  // 16-byte vectors where the rows allow, else element by element.
  auto store_y = [&](int r) {
    const int t0 = r * kTT, nt = min(kTT, a.T - t0);
    T* yb = y + ((long long)b * a.T + t0) * a.D + d0;
    constexpr int V = 16 / sizeof(T);
    if (a.vec_y) {
      for (int e = threadIdx.x; e < nt * (kCh / V); e += blockDim.x) {
        const int tt = e / (kCh / V), c = (e % (kCh / V)) * V;
        if (d0 + c >= a.D) continue;
        Pack<T, V> o;
#pragma unroll
        for (int j = 0; j < V; ++j) store(&o.v[j], s_y[r & 1][tt][c + j]);
        *reinterpret_cast<Pack<T, V>*>(yb + (long long)tt * a.D + c) = o;
      }
      return;
    }
    for (int e = threadIdx.x; e < nt * kCh; e += blockDim.x) {
      const int tt = e / kCh, c = e % kCh;
      if (d0 + c < a.D) store(yb + (long long)tt * a.D + c, s_y[r & 1][tt][c]);
    }
  };

  // The lane's states into a (.., N) row at dst: whole 16-byte vectors
  // where the layout allows, else state by state below N.
  auto put_state = [&](float* dst) {
    if constexpr (NSL % 4 == 0) {
      if (a.vec_state) {
#pragma unroll
        for (int i = 0; i < NSL; i += 4)
          *reinterpret_cast<float4*>(dst + n0 + i) =
              make_float4(h[i], h[i + 1], h[i + 2], h[i + 3]);
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < NSL; ++i)
      if (n0 + i < a.N) dst[n0 + i] = h[i];
  };

  for (int r = 0; r < kStages - 1; ++r) issue(r);
  for (int r = 0; r < runs; ++r) {
    async_copy::wait<kStages - 2>();
    __syncthreads();   // run r is staged; run r - 1's scan and run r - 2's y stores are done
    issue(r + kStages - 1);
    if (r > 0) store_y(r - 1);
    // training's checkpoint: the state entering run r, ck (B, runs, D, N)
    if (ck != nullptr && live) put_state(ck + (((long long)b * runs + r) * a.D + d) * a.N);
    const int st = r % kStages, nt = min(kTT, a.T - r * kTT);
    auto step = [&](int tt) {
      const float dtv = to_f32(s_dt[st][tt][ch]);
      const float dtx = dtv * to_f32(s_x[st][tt][ch]);
      float bv[NSL], cv[NSL];
      if constexpr (sizeof(T) == 4 && NSL % 4 == 0) {
#pragma unroll
        for (int i = 0; i < NSL; i += 4) {
          const float4 bq = *reinterpret_cast<const float4*>(&s_B[st][tt][n0 + i]);
          const float4 cq = *reinterpret_cast<const float4*>(&s_C[st][tt][n0 + i]);
          bv[i] = bq.x; bv[i + 1] = bq.y; bv[i + 2] = bq.z; bv[i + 3] = bq.w;
          cv[i] = cq.x; cv[i + 1] = cq.y; cv[i + 2] = cq.z; cv[i + 3] = cq.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < NSL; ++i) {
          bv[i] = to_f32(s_B[st][tt][n0 + i]);
          cv[i] = to_f32(s_C[st][tt][n0 + i]);
        }
      }
      // the lane's partial dot product: NP interleaved sums, then a tree
      constexpr int NP = NSL < 4 ? NSL : 4;
      float part[NP];
#pragma unroll
      for (int i = 0; i < NSL; ++i) {
        h[i] = fmaf(ex2(dtv * a2[i]), h[i], dtx * bv[i]);
        part[i % NP] = i < NP ? h[i] * cv[i] : fmaf(h[i], cv[i], part[i % NP]);
      }
      float acc = NP == 4 ? (part[0] + part[1]) + (part[2 % NP] + part[3 % NP])
                : NP == 2 ? part[0] + part[1 % NP] : part[0];
#pragma unroll
      for (int o = 1; o < L; o *= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) s_y[r & 1][tt][ch] = acc;
    };
    // A whole run unrolled without a guard, so that the compiler schedules
    // step tt + 1's loads and exponentials under step tt's chain; the last,
    // short run step by step.
    if (nt == kTT) {
#pragma unroll
      for (int tt = 0; tt < kTT; ++tt) step(tt);
    } else {
      for (int tt = 0; tt < nt; ++tt) step(tt);
    }
  }
  __syncthreads();
  store_y(runs - 1);

  if (live) put_state(h_out + hrow);
}

// The widest copy (16, 8 or 4 bytes) that keeps every row of this input on
// its boundary and never straddles `extent` (D or N); 0 where none does
// (a bf16 row off a 4-byte boundary).
int pick_granule(const void* p, long long st_b, long long st_t, int extent, int elem) {
  for (int bytes = 16; bytes >= 4; bytes /= 2) {
    const int g = bytes / elem;
    if (g >= 1 && reinterpret_cast<uintptr_t>(p) % bytes == 0 && st_b % g == 0 &&
        st_t % g == 0 && extent % g == 0)
      return bytes;
  }
  return 0;
}

template <typename T, int NS, int L>
int launch_ring(const T* dt, const T* Bm, const T* Cm, const T* x, const float* A,
                const float* h0, T* y, float* h_out, float* ck, int B, const Args& a,
                cudaStream_t s) {
  const dim3 grid((a.D + kCh - 1) / kCh, B);
  ssm_scan_ring_kernel<T, NS, L><<<grid, kCh * L, 0, s>>>(dt, Bm, Cm, x, A, h0, y, h_out, ck,
                                                          a);
  return (int)cudaGetLastError();
}

template <typename T, int NS>
int launch_ring_ns(const T* dt, const T* Bm, const T* Cm, const T* x, const float* A,
                   const float* h0, T* y, float* h_out, float* ck, int B, const Args& a,
                   int lanes, cudaStream_t s) {
  switch (lanes) {
    case 1: return launch_ring<T, NS, 1>(dt, Bm, Cm, x, A, h0, y, h_out, ck, B, a, s);
    case 2: return launch_ring<T, NS, 2>(dt, Bm, Cm, x, A, h0, y, h_out, ck, B, a, s);
    case 4: return launch_ring<T, NS, 4>(dt, Bm, Cm, x, A, h0, y, h_out, ck, B, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* dt, const void* Bm, const void* Cm, const void* x, const void* A,
           const void* h0, void* y, void* h_out, void* ck, int B, int T_, int D, int N,
           const long long* st, int lanes, void* stream) {
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
  float* ckt = static_cast<float*>(ck);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int NS = N <= 4 ? 4 : N <= 8 ? 8 : 16;
  const int e = (int)sizeof(T);
  a.g.dt = pick_granule(dt, a.dt_b, a.dt_t, D, e);
  a.g.x = pick_granule(x, a.x_b, a.x_t, D, e);
  a.g.B = pick_granule(Bm, a.B_b, a.B_t, N, e);
  a.g.C = pick_granule(Cm, a.C_b, a.C_t, N, e);
  const uintptr_t state_ptrs = reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(h0) |
                               reinterpret_cast<uintptr_t>(h_out) | reinterpret_cast<uintptr_t>(ck);
  a.vec_state = N == NS && state_ptrs % 16 == 0;
  a.vec_y = D % (16 / e) == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (NS == 4) return launch_ring_ns<T, 4>(dtt, Bt, Ct, xt, At, h0t, yt, ht, ckt, B, a, lanes, s);
  if (NS == 8) return launch_ring_ns<T, 8>(dtt, Bt, Ct, xt, At, h0t, yt, ht, ckt, B, a, lanes, s);
  return launch_ring_ns<T, 16>(dtt, Bt, Ct, xt, At, h0t, yt, ht, ckt, B, a, lanes, s);
}


// ---------------------------------------------------------------------------
// ssm_scan_bwd: the scan's backward (training)
// ---------------------------------------------------------------------------
//
// With a_t = exp(dt_t A), u_t = dt_t x_t, h_t = a_t h_{t-1} + u_t b_t^T and
// y_t = h_t c_t, each channel walks its states backwards in time from the
// cotangents gy (B, T, D) and g_hT (B, D, N):
//   G_t    = gy_t c_t + a_{t+1} G_{t+1}           (G_{T-1} = gy c + g_hT)
//   g_C_t  = sum_d gy_t[d] h_t[d, :]    g_B_t = sum_d u_t[d] G_t[d, :]
//   g_u_t  = G_t b_t                    g_x_t = g_u_t dt_t
//   g_dt_t = g_u_t x_t + sum_n G_t h_{t-1} a_t A
//   g_A    = sum_{b, t} G_t h_{t-1} a_t dt_t      g_h0 = a_0 G_0
// No Pallas kernel is replaced: the reference trains Mamba through a plain
// lax.scan (repro/models/ssm.py, jax.checkpoint every 128 steps), which XLA
// differentiates; its Pallas ssm_scan is forward only.
//
// h_{t-1} is never recovered by dividing by a_t (exp(dt A) underflows at
// A = -16 and a large dt). The forward writes the state entering every run
// of kTT = 16 steps (ck (B, S, D, N), S = ceil(T / 16)); the backward takes
// the runs last to first, rebuilds a run's 17 states from its checkpoint in
// registers, then walks them back. a_t is taken again in the walk, so the
// kernel spends two exponentials a (b, t, d, n) where the function needs one.
//
// What bounds it: at the training shape (B = 2, T = 2048, D = 8192, N = 16)
// dt, x and gy read, g_dt and g_x written and the checkpoints read are
// 805 MB, 0.24 ms at 3.35 TB/s; the B T D N = 537 M exponentials the
// function needs take 0.13 ms on the special-function units; so bytes.
//
// The design, ssm_scan_bwd_kernel<NS>:
//   - kBL = 4 lanes a channel, NS / 4 states in each lane's registers, so a
//     run's rebuilt states (17 x NS / 4) stay in registers; a block covers
//     kBCh = 64 channels of one batch row (8 warps).
//   - A 2-stage cp.async ring of runs, taken last to first: dt, x, gy (64
//     channels a row) and B, C, as the forward stages them.
//   - g_u and the dt sum over a channel's states: __shfl_xor_sync over its
//     4 lanes. g_B_t and g_C_t over channels: within a warp a halving
//     exchange (each shuffle stage passes half of the values still held, so
//     a lane ends with one state's sum over the warp's 8 channels), the 8
//     warps' sums in shared memory, summed in order into one partial a block
//     and step (B, T, nblk, N) in device memory; ssm_scan_bwd_reduce_kernel
//     sums the partials over blocks, and g_A (kept in registers over T, one
//     partial a batch row) over B. No atomics: the sums are taken in one
//     order every run.
//   - g_dt and g_x are written by each channel's first lane, step by step.
//   - Padded states (N < NS) and the ragged edge of D carry zeros: they add
//     nothing to the sums over channels. A null output is not written.

constexpr int kBL = 4;                     // lanes a channel (backward)
constexpr int kBCh = 64;                   // channels a block (backward)
constexpr int kBWarps = kBCh * kBL / 32;   // 8
constexpr int kBStages = 2;

struct BwdArgs {
  int T, D, N, S, nblk;
  long long dt_b, dt_t, x_b, x_t, B_b, B_t, C_b, C_t, gy_b, gy_t;   // strides in elements
  Granules g;
  int g_gy;        // gy's copy granule
  int vec_state;   // N = NS and the (.., N) rows on 16-byte boundaries
};

// Sum M values of a lane over the channel bit `o` of the warp: with M > 1
// each lane keeps half of them and passes the other half to its partner,
// so M values become M / 2 sums; `idx` tracks which of the original values
// the kept ones are. With M = 1 the one value is summed in place.
template <int M>
__device__ __forceinline__ void halve(float* w, int& idx, int lane, int o) {
  if constexpr (M > 1) {
    const bool hi = (lane & o) != 0;
#pragma unroll
    for (int j = 0; j < M / 2; ++j) {
      const float send = hi ? w[j] : w[j + M / 2];
      const float keep = hi ? w[j + M / 2] : w[j];
      w[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    if (hi) idx += M / 2;
  } else {
    w[0] += __shfl_xor_sync(0xffffffffu, w[0], o);
  }
}

// v[NSL] of each lane summed over the warp's 8 channels (lane bits 4, 3, 2);
// returns the sum of v[idx] over them, idx set; lanes whose `dup` bits are
// set hold a copy of another lane's sum.
template <int NSL>
__device__ __forceinline__ float sum_channels(const float* v, int lane, int& idx, int& dup) {
  float w[NSL];
#pragma unroll
  for (int j = 0; j < NSL; ++j) w[j] = v[j];
  idx = 0;
  halve<NSL>(w, idx, lane, 16);
  halve<(NSL > 1 ? NSL / 2 : 1)>(w, idx, lane, 8);
  halve<(NSL > 2 ? NSL / 4 : 1)>(w, idx, lane, 4);
  dup = NSL >= 4 ? 4 : NSL == 2 ? 12 : 28;
  return w[0];
}

template <int NS>
__global__ void __launch_bounds__(kBCh * kBL, 2)
ssm_scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ x,
                    const float* __restrict__ A, const float* __restrict__ ck,
                    const float* __restrict__ gy, const float* __restrict__ g_hT,
                    float* __restrict__ g_dt, float* __restrict__ g_x,
                    float* __restrict__ part_B, float* __restrict__ part_C,
                    float* __restrict__ gA_part, float* __restrict__ g_h0, BwdArgs a) {
  constexpr int NSL = NS / kBL;
  static_assert(NS % kBL == 0, "4 lanes split NS states");
  __shared__ __align__(16) float s_dt[kBStages][kTT][kBCh];
  __shared__ __align__(16) float s_x[kBStages][kTT][kBCh];
  __shared__ __align__(16) float s_gy[kBStages][kTT][kBCh];
  __shared__ __align__(16) float s_B[kBStages][kTT][NS];
  __shared__ __align__(16) float s_C[kBStages][kTT][NS];
  __shared__ float s_pB[kTT][kBWarps][NS];
  __shared__ float s_pC[kTT][kBWarps][NS];
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kBCh;
  const int ch = threadIdx.x / kBL, lane4 = threadIdx.x % kBL;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int d = d0 + ch;
  const bool live = d < a.D;
  const int n0 = lane4 * NSL;
  const long long hrow = ((long long)b * a.D + d) * a.N;

  for (int e = threadIdx.x; e < kBStages * kTT * NS; e += blockDim.x) {
    (&s_B[0][0][0])[e] = 0.f;
    (&s_C[0][0][0])[e] = 0.f;
  }
  __syncthreads();

  // A (as A log2 e for ex2, and as A), the carried a_{t+1} G_{t+1} from
  // g_hT, and g_A's sum; zeros on padded states and past D.
  float a2[NSL], Af[NSL], R[NSL], gA[NSL];
#pragma unroll
  for (int i = 0; i < NSL; ++i) {
    const bool ok = live && n0 + i < a.N;
    Af[i] = ok ? A[(long long)d * a.N + n0 + i] : 0.f;
    a2[i] = Af[i] * kLog2e;
    R[i] = ok && g_hT != nullptr ? g_hT[hrow + n0 + i] : 0.f;
    gA[i] = 0.f;
  }

  const float* dtb = dt + b * a.dt_b;
  const float* xb = x + b * a.x_b;
  const float* gyb = gy + b * a.gy_b;
  const float* Bb = Bm + b * a.B_b;
  const float* Cb = Cm + b * a.C_b;

  // the i-th run taken (the S - 1 - i-th in time) into stage i % 2
  auto issue = [&](int i) {
    if (i < a.S) {
      const int st = i % kBStages, t0 = (a.S - 1 - i) * kTT, nt = min(kTT, a.T - t0);
      stage_rows(&s_dt[st][0][0], kBCh, dtb, a.dt_t, t0, nt, d0, kBCh, a.D, a.g.dt);
      stage_rows(&s_x[st][0][0], kBCh, xb, a.x_t, t0, nt, d0, kBCh, a.D, a.g.x);
      stage_rows(&s_gy[st][0][0], kBCh, gyb, a.gy_t, t0, nt, d0, kBCh, a.D, a.g_gy);
      stage_rows(&s_B[st][0][0], NS, Bb, a.B_t, t0, nt, 0, NS, a.N, a.g.B);
      stage_rows(&s_C[st][0][0], NS, Cb, a.C_t, t0, nt, 0, NS, a.N, a.g.C);
    }
    async_copy::commit();
  };

  issue(0);
  for (int i = 0; i < a.S; ++i) {
    issue(i + 1);   // stage (i + 1) % 2 was last read before run i - 1's partial sums
    async_copy::wait<1>();
    __syncthreads();   // run i is staged
    const int st = i % kBStages, seg = a.S - 1 - i, t0 = seg * kTT, nt = min(kTT, a.T - t0);

    // rebuild the run's states: hist[0] the checkpoint, hist[j + 1] = h_{t0 + j}
    float hist[kTT + 1][NSL];
    const float* ckrow = ck + (((long long)b * a.S + seg) * a.D + d) * a.N;
    bool loaded = false;
    if constexpr (NSL % 4 == 0) {
      if (a.vec_state && live) {
#pragma unroll
        for (int j = 0; j < NSL; j += 4) {
          const float4 hv = *reinterpret_cast<const float4*>(ckrow + n0 + j);
          hist[0][j] = hv.x;
          hist[0][j + 1] = hv.y;
          hist[0][j + 2] = hv.z;
          hist[0][j + 3] = hv.w;
        }
        loaded = true;
      }
    }
    if (!loaded) {
#pragma unroll
      for (int j = 0; j < NSL; ++j) hist[0][j] = live && n0 + j < a.N ? ckrow[n0 + j] : 0.f;
    }
#pragma unroll
    for (int tt = 0; tt < kTT; ++tt) {
      if (tt < nt) {
        const float dtv = live ? s_dt[st][tt][ch] : 0.f;
        const float dtx = live ? dtv * s_x[st][tt][ch] : 0.f;
#pragma unroll
        for (int j = 0; j < NSL; ++j)
          hist[tt + 1][j] = fmaf(ex2(dtv * a2[j]), hist[tt][j], dtx * s_B[st][tt][n0 + j]);
      }
    }

    // walk the run back
#pragma unroll
    for (int tt = kTT - 1; tt >= 0; --tt) {
      if (tt < nt) {
        const float dtv = live ? s_dt[st][tt][ch] : 0.f;
        const float xv = live ? s_x[st][tt][ch] : 0.f;
        const float gyv = live ? s_gy[st][tt][ch] : 0.f;
        const float u = dtv * xv;
        float pB[NSL], pC[NSL];
        float gu = 0.f, sd = 0.f;
#pragma unroll
        for (int j = 0; j < NSL; ++j) {
          const float bv = s_B[st][tt][n0 + j];
          const float av = ex2(dtv * a2[j]);
          const float G = fmaf(gyv, s_C[st][tt][n0 + j], R[j]);
          pC[j] = gyv * hist[tt + 1][j];
          pB[j] = u * G;
          gu = fmaf(G, bv, gu);
          const float da = G * hist[tt][j] * av;
          sd = fmaf(da, Af[j], sd);
          gA[j] = fmaf(da, dtv, gA[j]);
          R[j] = av * G;
        }
        gu += __shfl_xor_sync(0xffffffffu, gu, 1);
        sd += __shfl_xor_sync(0xffffffffu, sd, 1);
        gu += __shfl_xor_sync(0xffffffffu, gu, 2);
        sd += __shfl_xor_sync(0xffffffffu, sd, 2);
        if (lane4 == 0 && live) {
          const long long o = ((long long)b * a.T + t0 + tt) * a.D + d;
          if (g_dt != nullptr) g_dt[o] = fmaf(gu, xv, sd);
          if (g_x != nullptr) g_x[o] = gu * dtv;
        }
        int idx, dup;
        const float sB = sum_channels<NSL>(pB, lane, idx, dup);
        const float sC = sum_channels<NSL>(pC, lane, idx, dup);
        if ((lane & dup) == 0) {
          s_pB[tt][warp][n0 + idx] = sB;
          s_pC[tt][warp][n0 + idx] = sC;
        }
      }
    }
    __syncthreads();   // the warps' sums are in; run i's stage is read

    // one partial a block and step, (B, T, nblk, N), the warps summed in order
    if (part_B != nullptr || part_C != nullptr) {
      for (int e = threadIdx.x; e < nt * a.N; e += blockDim.x) {
        const int tt = e / a.N, n = e % a.N;
        float sb = 0.f, sc = 0.f;
#pragma unroll
        for (int w = 0; w < kBWarps; ++w) {
          sb += s_pB[tt][w][n];
          sc += s_pC[tt][w][n];
        }
        const long long o = (((long long)b * a.T + t0 + tt) * a.nblk + blockIdx.x) * a.N + n;
        if (part_B != nullptr) part_B[o] = sb;
        if (part_C != nullptr) part_C[o] = sc;
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int j = 0; j < NSL; ++j) {
    if (n0 + j < a.N) {
      if (g_h0 != nullptr) g_h0[hrow + n0 + j] = R[j];
      if (gA_part != nullptr) gA_part[hrow + n0 + j] = gA[j];
    }
  }
}

// g_B, g_C (B, T, N): the partials summed over the nblk blocks in order;
// g_A (D, N): the B rows' partials summed in order. Null outputs are skipped.
__global__ void ssm_scan_bwd_reduce_kernel(const float* __restrict__ part_B,
                                           const float* __restrict__ part_C,
                                           const float* __restrict__ gA_part, int B, int T,
                                           int D, int N, int nblk, float* __restrict__ g_B,
                                           float* __restrict__ g_C, float* __restrict__ g_A) {
  const long long nb = g_B != nullptr ? (long long)B * T * N : 0;
  const long long nc = g_C != nullptr ? (long long)B * T * N : 0;
  const long long na = g_A != nullptr ? (long long)D * N : 0;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < nb + nc + na;
       e += (long long)gridDim.x * blockDim.x) {
    if (e < nb + nc) {
      const bool isC = e >= nb;
      const long long r = isC ? e - nb : e;
      const long long bt = r / N;
      const int n = (int)(r % N);
      const float* p = (isC ? part_C : part_B) + bt * nblk * N + n;
      float s = 0.f;
      for (int k = 0; k < nblk; ++k) s += p[(long long)k * N];
      (isC ? g_C : g_B)[r] = s;
    } else {
      const long long r = e - nb - nc;
      float s = 0.f;
      for (int bb = 0; bb < B; ++bb) s += gA_part[(long long)bb * D * N + r];
      g_A[r] = s;
    }
  }
}

int launch_bwd(const float* dt, const float* Bm, const float* Cm, const float* x,
               const float* A, const float* ck, const float* gy, const float* g_hT,
               float* g_dt, float* g_x, float* g_B, float* g_C, float* g_A, float* g_h0,
               float* part_B, float* part_C, float* gA_part, int B, int T, int D, int N,
               const long long* st, int n_sms, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || D < 1 || N < 1 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  if ((g_B != nullptr && part_B == nullptr) || (g_C != nullptr && part_C == nullptr) ||
      (g_A != nullptr && gA_part == nullptr))
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.T = T;
  a.D = D;
  a.N = N;
  a.S = (T + kTT - 1) / kTT;
  a.nblk = (D + kBCh - 1) / kBCh;
  a.dt_b = st[0];
  a.dt_t = st[1];
  a.x_b = st[2];
  a.x_t = st[3];
  a.B_b = st[4];
  a.B_t = st[5];
  a.C_b = st[6];
  a.C_t = st[7];
  a.gy_b = st[8];
  a.gy_t = st[9];
  a.g.dt = pick_granule(dt, a.dt_b, a.dt_t, D, 4);
  a.g.x = pick_granule(x, a.x_b, a.x_t, D, 4);
  a.g.B = pick_granule(Bm, a.B_b, a.B_t, N, 4);
  a.g.C = pick_granule(Cm, a.C_b, a.C_t, N, 4);
  a.g_gy = pick_granule(gy, a.gy_b, a.gy_t, D, 4);
  const int NS = N <= 4 ? 4 : N <= 8 ? 8 : 16;
  a.vec_state = N == NS && reinterpret_cast<uintptr_t>(ck) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(a.nblk, B);
  float* pB = g_B != nullptr ? part_B : nullptr;
  float* pC = g_C != nullptr ? part_C : nullptr;
  float* pA = g_A != nullptr ? gA_part : nullptr;
  if (NS == 4)
    ssm_scan_bwd_kernel<4><<<grid, kBCh * kBL, 0, s>>>(dt, Bm, Cm, x, A, ck, gy, g_hT, g_dt, g_x,
                                                      pB, pC, pA, g_h0, a);
  else if (NS == 8)
    ssm_scan_bwd_kernel<8><<<grid, kBCh * kBL, 0, s>>>(dt, Bm, Cm, x, A, ck, gy, g_hT, g_dt, g_x,
                                                      pB, pC, pA, g_h0, a);
  else
    ssm_scan_bwd_kernel<16><<<grid, kBCh * kBL, 0, s>>>(dt, Bm, Cm, x, A, ck, gy, g_hT, g_dt,
                                                       g_x, pB, pC, pA, g_h0, a);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || (g_B == nullptr && g_C == nullptr && g_A == nullptr)) return rc;
  const long long total = (g_B != nullptr ? (long long)B * T * N : 0) +
                          (g_C != nullptr ? (long long)B * T * N : 0) +
                          (g_A != nullptr ? (long long)D * N : 0);
  const int blocks = (int)std::min<long long>((total + 255) / 256, 8LL * n_sms);
  ssm_scan_bwd_reduce_kernel<<<blocks, 256, 0, s>>>(part_B, part_C, gA_part, B, T, D, N,
                                                    a.nblk, g_B, g_C, g_A);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 8 values in elements, (batch, time) of dt, x, Bm, Cm. lanes: 1, 2
// or 4 lanes a channel. ck: null (serving), or (B, ceil(T / 16), D, N) fp32
// that receives the state entering every run of 16 steps (training).
int ssm_scan_f32(const void* dt, const void* Bm, const void* Cm, const void* x, const void* A,
                 const void* h0, void* y, void* h_out, void* ck, int B, int T, int D, int N,
                 const long long* strides, int lanes, void* stream) {
  return launch<float>(dt, Bm, Cm, x, A, h0, y, h_out, ck, B, T, D, N, strides, lanes, stream);
}

int ssm_scan_bf16(const void* dt, const void* Bm, const void* Cm, const void* x, const void* A,
                  const void* h0, void* y, void* h_out, void* ck, int B, int T, int D, int N,
                  const long long* strides, int lanes, void* stream) {
  return launch<__nv_bfloat16>(dt, Bm, Cm, x, A, h0, y, h_out, ck, B, T, D, N, strides, lanes,
                               stream);
}

// The backward (training), all fp32. strides: 10 values in elements, (batch,
// time) of dt, x, Bm, Cm, gy. ck: the forward's checkpoints (B, ceil(T / 16),
// D, N). g_hT may be null (zeros). Any of g_dt, g_x, g_B, g_C, g_A, g_h0 may
// be null: not written. part_B, part_C: scratch of (B, T, ceil(D / 64), N),
// each where g_B, g_C is wanted; gA_part: (B, D, N) where g_A is.
int ssm_scan_bwd_f32(const void* dt, const void* Bm, const void* Cm, const void* x,
                     const void* A, const void* ck, const void* gy, const void* g_hT,
                     void* g_dt, void* g_x, void* g_B, void* g_C, void* g_A, void* g_h0,
                     void* part_B, void* part_C, void* gA_part, int B, int T, int D, int N,
                     const long long* strides, int n_sms, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  return launch_bwd(f(dt), f(Bm), f(Cm), f(x), f(A), f(ck), f(gy), f(g_hT), w(g_dt), w(g_x),
                    w(g_B), w(g_C), w(g_A), w(g_h0), w(part_B), w(part_C), w(gA_part), B, T, D,
                    N, strides, n_sms, stream);
}

const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
