"""What holds the port's redesigned kernels back, measured on the card.

    PYTHONPATH=src python -m repro_torch.kernels.probe      # needs a CUDA card

1. Calibration (``csrc/probe.cu``): the card's fp32 FFMA rate and its
   special-function units' ex2 rate on independent chains, and
   ``gossip_mix_dense_kernel``'s 8 x 4 FMA pattern (operands from shared
   memory) at 13 and 32 warps an SM.
2. The L2 flush: ``probe_stream`` (the streaming floor of the codec
   aggregates' bytes), both routes of ``quantized_aggregate`` (q8) and
   ``packed_quantized_aggregate`` (q4), ``fedavg_aggregate`` and
   ``sparse_aggregate`` at the CNN and 2NN shapes (K = 10, chunk 512), each
   timed under two flushes in turns (zeroing, clean, clean, zeroing): the
   zeroing flush writes a 256 MB buffer and leaves the 50 MB L2 full of
   dirty lines, which a kernel's own traffic must write back; the clean
   flush reads the same buffer, written once, and leaves clean lines. Then
   the same kernels' device durations as CUPTI records them
   (``torch.profiler``) beside their CUDA-event times under the clean
   flush: the events also hold the launch. ``fedavg_aggregate`` also at
   the buffered-async apply (K = 3, the 2NN's N) and the char-LSTM round
   (K = 115), where the launch is a large part of the event time.
3. ``sparse_aggregate``'s gap (:func:`sparse`): ``probe_red``, the RED
   floor (fp32 reductions at the pairs' indices and nothing else), on
   coalesced, uniform random and real top-k indices; both routes' event
   and device times at the CNN and 2NN shapes and on one real CNN top-5%
   round's payload, with its share of distinct indices; both routes with
   parts cut out (CUTS: the REDs, the division, the zero phase and grid
   sync, the L2 policies, the unroll, the grid); and which part holds
   each route.
4. The stream route's timeline: a build of ``qagg_stream_kernel`` that
   stamps ``%globaltimer`` as each of a block's tiles lands, asks for the
   next, has its steps, is decoded, stored and synced (TIMELINE_EDITS).
5. Ablations: ``gossip_mix_dense_kernel`` on the full graph (n = 100, the
   CNN's N), ``ssm_scan_ring_kernel`` at the Jamba prefill shape (2 lanes
   a channel) and both routes of the codec aggregates at the CNN shape,
   each rebuilt from its source with one part cut out -- the loads of the
   next tile or run, the stores, the exponentials, the int-to-float
   conversions -- and timed beside the kernel itself. A cut kernel computes
   nothing useful; only its time is read.

Times are CUDA events, median of 50 launches with the L2 cache flushed
before each (the clean flush, as ``chip_smoke.py`` phase 4 times, but in
part 2); each line names the card and its power limit. A build directory
under ``build/repro_torch/probe`` holds the cut kernels.
"""
from __future__ import annotations

import ctypes
import re
import subprocess

import numpy as np
import torch

from repro_torch.kernels import build

PROBE_DIR = build.BUILD_DIR / "probe"
FLUSH_BYTES = 256 * 2**20        # well above the 50 MB L2
# The codec aggregates' main shapes: K clients, the CNN's and the 2NN's N,
# chunk 512 (specs/mnist_2nn_noniid_q8.json).
WIRE_K, WIRE_CHUNK = 10, 512
WIRE_N = {"cnn": 1_663_370, "2nn": 199_210}
# fedavg_aggregate's other small rounds (chip_smoke.py's AGG_SHAPES): the
# buffered-async apply and the Shakespeare spec's char-LSTM round, (K, N)
FEDAVG_SHAPES = {"async_apply": (3, 199_210), "char_lstm": (115, 211_592)}
# The flush is switched when the zeroing flush costs probe_stream at the q8
# CNN bytes this much more than the clean flush.
FLUSH_SWITCH_RATIO = 1.10

# An L2 cache-hint policy in a variable pol (evict_first or evict_last).
_POLICY = ('  uint64_t pol;\n  asm volatile("createpolicy.fractional.L2::evict_{}.b64 %0, 1.0;" '
           ': "=l"(pol));\n')

# (source, variant) -> (text to cut, what replaces it)
CUTS = {
    ("gossip_mix", "no X loads"): [("      issue(lj, lkpi, (s + 1) % kDenseStages);\n", "")],
    ("ssm_scan", "no dt/x/B/C loads"): [("    issue(r + kStages - 1);\n",
                                         "    async_copy::commit();\n")],
    ("ssm_scan", "no y stores"): [("    if (r > 0) store_y(r - 1);\n", "")],
    ("ssm_scan", "no loads, no y stores"): [
        ("    issue(r + kStages - 1);\n", "    async_copy::commit();\n"),
        ("    if (r > 0) store_y(r - 1);\n", "")],
    ("ssm_scan", "no exponentials"): [
        ('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(r) : "f"(v));\n',
         "  r = fmaf(v, 0.01f, 0.99f);\n")],
    # the general route: its stores (kept alive by a test that never holds)
    # and its int-to-float conversions (I2F) replaced by the stream route's
    # bit trick
    ("quantized_agg", "general: no stores"): [
        ("    store_f32<VEC>(out + col, acc);\n",
         "    if (acc[0] == 12345.f) store_f32<VEC>(out + col, acc);\n"),
        ("      if (first + j < chunk) o[j] = acc[j];\n",
         "      if (acc[j] == 12345.f) o[j] = acc[j];\n")],
    ("quantized_agg", "general: bit-trick decode"): [
        ("fmaf(static_cast<float>(p.v[j]), step, l)",
         "fmaf(__int_as_float(0x4B000000u | p.v[j]) - 8388608.f, step, l)"),
        ("static_cast<float>((word >> (j * BITS)) & MASK)",
         "(__int_as_float(0x4B000000u | ((word >> (j * BITS)) & MASK)) - 8388608.f)")],
    # the stream route: the next tile's request arrives without copying, so
    # only a block's first tile is loaded; and the decode and fma pair cut
    # to one add a word
    ("quantized_agg", "stream: no next-tile copies"): [
        ("issue(i + 1, s ^ 1, /*copy=*/true);", "issue(i + 1, s ^ 1, /*copy=*/false);")],
    ("quantized_agg", "stream: no decode or fma"): [
        ("""              acc[q * S::kCodesPerWord + j] = fmaf(
                  wk, fmaf(decode<BITS>(wd[q], j), ls.y, ls.x), acc[q * S::kCodesPerWord + j]);""",
         """              if (j == 0) acc[q * S::kCodesPerWord] += __int_as_float(wd[q]) * wk;""")],
    # sparse_aggregate's scatter route (its kernel alone, without the fill):
    # its REDs (the loads kept alive by a test that never holds), and its
    # 64-bit division t / k made a 32-bit one
    ("sparse_agg", "scatter: no REDs"): [
        ("    if (i >= 0 && i < n) atomicAdd(out + i, w[t / k] * to_f32(vals[t]));\n",
         "    const float v = w[t / k] * to_f32(vals[t]);\n"
         "    if (v == 12345.f && i >= 0 && i < n) atomicAdd(out + i, v);\n")],
    ("sparse_agg", "scatter: 32-bit row"): [
        ("    if (i >= 0 && i < n) atomicAdd(out + i, w[t / k] * to_f32(vals[t]));\n",
         "    if (i >= 0 && i < n) atomicAdd(out + i, w[(int)t / (int)k] * to_f32(vals[t]));\n")],
    # the fused route: its zero phase and grid sync, its REDs; the loads
    # asked for after the sync in place of before the zero phase; the first
    # design's 4 items a thread at 2 blocks an SM; and evict-first loads with
    # evict-last REDs (L2 cache-hint policies)
    ("sparse_agg", "fused: no zero phase or grid sync"): [
        ("""  for (long long i = z0 + threadIdx.x; i < z1; i += kFusedThreads)
    out4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) out[(n4 << 2) + threadIdx.x] = 0.f;
  cooperative_groups::this_grid().sync();
""", "  (void)z1;\n  (void)out4;\n")],
    ("sparse_agg", "fused: no REDs"): [
        ("  if (i >= 0 && i < n) atomicAdd(out + i, v);\n",
         "  if (v == 12345.f && i >= 0 && i < n) atomicAdd(out + i, v);\n")],
    ("sparse_agg", "fused: loads after the zero phase"): [
        ("  Batch<T> b;\n  b.load(idx, vals, w, K, k, groups, step, c, g);\n", "  Batch<T> b;\n"),
        ("  cooperative_groups::this_grid().sync();\n",
         "  cooperative_groups::this_grid().sync();\n"
         "  b.load(idx, vals, w, K, k, groups, step, c, g);\n")],
    ("sparse_agg", "fused: 4 items a thread, 2 blocks an SM"): [
        ("constexpr int kUnroll = 8;", "constexpr int kUnroll = 4;"),
        ("constexpr int kBlocksPerSm = 1;", "constexpr int kBlocksPerSm = 2;")],
    ("sparse_agg", "fused: L2 hints"): [
        ("  return __ldg(reinterpret_cast<const int4*>(p));\n",
         "  int4 v;\n" + _POLICY.format("first") +
         '  asm volatile("ld.global.L1::no_allocate.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, '
         '[%4], %5;" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));\n'
         "  return v;\n"),
        ("  return __ldg(reinterpret_cast<const float4*>(p));\n",
         "  float4 v;\n" + _POLICY.format("first") +
         '  asm volatile("ld.global.L1::no_allocate.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, '
         '[%4], %5;" : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p), "l"(pol));\n'
         "  return v;\n"),
        ("  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));\n",
         "  uint2 u;\n" + _POLICY.format("first") +
         '  asm volatile("ld.global.L1::no_allocate.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;" '
         ': "=r"(u.x), "=r"(u.y) : "l"(p), "l"(pol));\n'),
        ("  if (i >= 0 && i < n) atomicAdd(out + i, v);\n",
         "  if (i >= 0 && i < n) {\n" + _POLICY.format("last") +
         '  asm volatile("red.global.add.L2::cache_hint.f32 [%0], %1, %2;" :: "l"(out + i), '
         '"f"(v), "l"(pol) : "memory");\n  }\n')],
}


# The stream kernel with %globaltimer stamps: thread 0 of each block records
# its start and, for its first four tiles, when the tile has landed, the
# next one is asked for, its steps are in, it is decoded, stored and the
# block has synced (TIMELINE_STEPS), into a device array read back after
# one launch.
_NOW = '({ unsigned long long t_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); t_; })'
TIMELINE_STEPS = ("landed", "next asked", "steps in", "decoded", "stored", "synced")
TIMELINE_BLOCKS = 1024


def _stamp(step, indent="    "):
    return (f"{indent}if (tid == 0 && i < 4) g_tl[blockIdx.x * 32 + 1 + i * 6 + {step}] = "
            f"{_NOW};\n")


TIMELINE_EDITS = [
    ("namespace {\n", f"namespace {{\n__device__ unsigned long long g_tl[{TIMELINE_BLOCKS} * 32];\n"),
    ("  issue(0, 0, /*copy=*/true);\n",
     f"  if (tid == 0) g_tl[blockIdx.x * 32] = {_NOW};\n  issue(0, 0, /*copy=*/true);\n"),
    ("    mbar_wait(&full[s], parity);\n", "    mbar_wait(&full[s], parity);\n" + _stamp(0)),
    ("    if (i + 1 < n_tiles) issue(i + 1, s ^ 1, /*copy=*/true);\n",
     "    if (i + 1 < n_tiles) issue(i + 1, s ^ 1, /*copy=*/true);\n" + _stamp(1)),
    ("      d->y = d->y / levels;   // step, once per (k, chunk) of the tile\n    }\n"
     "    __syncthreads();\n",
     "      d->y = d->y / levels;   // step, once per (k, chunk) of the tile\n    }\n"
     "    __syncthreads();\n" + _stamp(2)),
    ("      int valid = (T.bytes - u0) / S::kUnitBytes;\n",
     _stamp(3, "      ") + "      int valid = (T.bytes - u0) / S::kUnitBytes;\n"),
    ("    __syncthreads();   // every thread is done with stage s\n",
     _stamp(4) + "    __syncthreads();   // every thread is done with stage s\n" + _stamp(5)),
    ('extern "C" {\n',
     'extern "C" {\n'
     "int probe_timeline_read(void* dst) {\n"
     "  return (int)cudaMemcpyFromSymbol(dst, g_tl, sizeof(g_tl));\n}\n"
     "int probe_timeline_clear() { return (int)cudaMemset(g_tl_ptr(), 0, sizeof(g_tl)); }\n"),
    ("}  // namespace\n\nextern", "void* g_tl_ptr() {\n  void* p = nullptr;\n"
     "  cudaGetSymbolAddress(&p, g_tl);\n  return p;\n}\n\n}  // namespace\n\nextern"),
]


def _edited_library(name, tag, edits):
    """nvcc the source with ``edits`` (text, what replaces it) into
    PROBE_DIR; the loaded library."""
    text = (build.CSRC / f"{name}.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}.cu no longer has the code the {tag!r} edit changes")
        text = text.replace(old, new)
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    stem = re.sub(r"[^a-z0-9]+", "_", tag)   # nvcc splits its arguments at commas
    src = PROBE_DIR / f"{name}_{stem}.cu"
    src.write_text(text)
    lib = src.with_suffix(".so")
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([build._nvcc(), *flags, "-I", str(build.CSRC), "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the {tag!r} edit of {name}.cu:\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def _cut_library(name, variant):
    return _edited_library(name, variant, CUTS[(name, variant)])


def _time_ms(fn, flush, iters=50):
    """Median device time of ``fn`` over ``iters`` launches, ``flush()``
    before each (:func:`zeroing_flush` or :func:`clean_flush`)."""
    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def zeroing_flush(buf):
    """Write ``buf`` (256 MB): the L2 is left full of dirty lines."""
    return buf.zero_


def clean_flush(buf):
    """Read ``buf`` (256 MB, written once) without writing it: the L2 is
    left full of clean lines."""
    return buf.sum


def _flush_buffer():
    return torch.zeros(FLUSH_BYTES // 4, device="cuda")


def _probe_lib():
    lib = build.load("probe")
    lib.probe_stream_run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.probe_red_run.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                  ctypes.c_void_p]
    return lib


def _device_ms(fn, keys, flush, reps=40):
    """Each kernel's device duration as CUPTI records it (torch.profiler):
    over ``reps`` launches of ``fn``, each after ``flush()``, the median of
    the records whose name holds each of ``keys``, {key: ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            fn()
        torch.cuda.synchronize()
    out = {}
    for key in keys:
        device = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                  if e.device_type == DeviceType.CUDA and key in e.name]
        if len(device) < reps // 2:   # CUPTI may drop a few records; the median needs most
            seen = sorted({e.name[:80] for e in prof.events() if e.device_type == DeviceType.CUDA})
            raise RuntimeError(f"the profiler saw {len(device)} of {reps} {key} launches; "
                               f"kernels seen: {seen}")
        out[key] = float(np.median(device))
    return out


def _stream():
    return torch.cuda.current_stream().cuda_stream


def calibrate():
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = build.load("probe")
    for fn in (lib.probe_ffma_run, lib.probe_ex2_run):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
    lib.probe_outer_run.argtypes = [ctypes.c_int] + lib.probe_ffma_run.argtypes
    out = torch.empty(sms * 8 * 256, device="cuda")
    rows = {}

    def rate(launch, ops):
        launch(5)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(5):
            if launch(200) != 0:
                raise RuntimeError("a probe kernel failed to launch")
        e1.record()
        torch.cuda.synchronize()
        return ops / (e0.elapsed_time(e1) / 5 * 1e-3)

    blocks, threads = sms * 8, 256
    rows["ffma TFLOP/s"] = rate(
        lambda it: lib.probe_ffma_run(out.data_ptr(), blocks, threads, it * 100, _stream()),
        2 * 32 * blocks * threads * 200 * 100) / 1e12
    rows["ex2 a clock an SM at 1.98 GHz"] = rate(
        lambda it: lib.probe_ex2_run(out.data_ptr(), blocks, threads, it * 100, _stream()),
        16 * blocks * threads * 200 * 100) / (sms * 1.98e9)
    for cols in (4, 8):
        for per_sm, threads in ((2, 208), (4, 256)):
            warps = per_sm * threads // 32
            rows[f"8x{cols} FMA pattern, {warps} warps an SM, TFLOP/s"] = rate(
                lambda it: lib.probe_outer_run(cols, out.data_ptr(), sms * per_sm, threads, it,
                                               _stream()),
                2 * sms * per_sm * threads * 200 * 64 * 8 * cols) / 1e12
    return rows


def ablate():
    from repro_torch.core import topology
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import ssm_scan as sk

    flush = clean_flush(_flush_buffer())
    rows = {}
    plan = topology.FullTopology().build(100)
    idx, w = torch.from_numpy(plan.idx).cuda(), torch.from_numpy(plan.weight).cuda()
    x = torch.randn((100, 1_663_370), device="cuda")
    out = torch.empty_like(x)

    def mix(lib):
        fn = lib.gossip_mix_dense_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_void_p]
        return lambda: fn(x.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), 100,
                          x.shape[1], idx.shape[1], _stream())

    rows["gossip_mix dense, full graph n=100 N=1663370: the kernel"] = _time_ms(
        mix(gm._lib()), flush)
    rows["gossip_mix dense: no X loads"] = _time_ms(
        mix(_cut_library("gossip_mix", "no X loads")), flush)

    g = torch.Generator(device="cuda").manual_seed(7)
    B, T, D, N = 4, 2048, 8192, 16
    dt = torch.rand((B, T, D), generator=g, device="cuda") * 0.1 + 1e-3
    Bm, Cm = (torch.randn((B, T, N), generator=g, device="cuda") for _ in range(2))
    xs = torch.randn((B, T, D), generator=g, device="cuda")
    A = -torch.rand((D, N), generator=g, device="cuda") * 16 - 0.5
    h0 = torch.zeros((B, D, N), device="cuda")
    y, h = torch.empty_like(xs), torch.empty_like(h0)
    strides = (ctypes.c_longlong * 8)(*(s for t in (dt, xs, Bm, Cm) for s in t.stride()[:2]))

    def scan(lib):
        fn = lib.ssm_scan_f32
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p]
        return lambda: fn(dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), xs.data_ptr(),
                          A.data_ptr(), h0.data_ptr(), y.data_ptr(), h.data_ptr(), B, T, D, N,
                          strides, sk.PREFILL_LANES, _stream())

    rows[f"ssm_scan prefill B=4 T=2048 D=8192 N=16, {sk.PREFILL_LANES} lanes: the kernel"] = \
        _time_ms(scan(sk._lib()), flush)
    for name, variant in CUTS:
        if name == "ssm_scan":
            rows[f"ssm_scan: {variant}"] = _time_ms(scan(_cut_library(name, variant)), flush)

    from repro_torch.kernels import quantized_agg as qa

    ins = _wire_inputs(WIRE_N["cnn"])
    libs = {"the kernel": qa._lib(), **{variant: _cut_library(name, variant)
                                        for name, variant in CUTS if name == "quantized_agg"}}
    for variant, lib in libs.items():
        for codec in ("q8", "q4"):
            for route in ("general", "stream"):
                if variant != "the kernel" and not variant.startswith(route):
                    continue
                rows[f"{codec} {route} CNN: {variant}"] = _time_ms(
                    _wire_launch(lib, ins, codec, route), flush)
    return rows


def _wire_inputs(N):
    """q8 codes, q4 words, (lo, scale), weights, the fedavg (K, N) fp32 stack
    and top-5% pairs at K = WIRE_K, chunk WIRE_CHUNK, drawn on the card."""
    g = torch.Generator(device="cuda").manual_seed(7)
    K, C = WIRE_K, -(-N // WIRE_CHUNK)
    w = torch.rand(K, generator=g, device="cuda") + 0.1
    k = N * 5 // 100
    return {
        "N": N, "C": C,
        "q8": torch.randint(0, 256, (K, C * WIRE_CHUNK), generator=g, device="cuda",
                            dtype=torch.int32).to(torch.uint8),
        "q4": torch.randint(-2**31, 2**31, (K, C * WIRE_CHUNK // 8), generator=g, device="cuda",
                            dtype=torch.int32),
        "lo": torch.randn((K, C), generator=g, device="cuda"),
        "scale": torch.rand((K, C), generator=g, device="cuda"),
        "w": w / w.sum(),
        "x": torch.randn((K, N), generator=g, device="cuda"),
        "idx": torch.stack([torch.randperm(N, generator=g, device="cuda")[:k]
                            for _ in range(K)]).to(torch.int32),
        "vals": torch.randn((K, k), generator=g, device="cuda"),
        "out": torch.empty(C * WIRE_CHUNK, device="cuda"),
    }


def _wire_launch(lib, ins, codec, route):
    """One launch of a codec aggregate's route from ``lib`` (the kernel's
    library or a cut of it) into ``ins["out"]``."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    payload = ins[codec]
    bits, levels = (8, 255) if codec == "q8" else (4, 15)
    args = [payload.data_ptr(), ins["lo"].data_ptr(), ins["scale"].data_ptr(),
            ins["w"].data_ptr(), ins["out"].data_ptr(), WIRE_K]
    if route == "stream":
        fn, rest = lib.quantized_aggregate_stream, [ins["C"], WIRE_CHUNK, bits, levels]
        fn.argtypes = [ptr] * 5 + [i32, i64, i32, i32, i32, ptr]
    elif codec == "q8":
        fn, rest = lib.quantized_aggregate_u8, [ins["C"] * WIRE_CHUNK, WIRE_CHUNK, levels]
        fn.argtypes = [ptr] * 5 + [i32, i64, i32, i32, ptr]
    else:
        fn, rest = lib.packed_quantized_aggregate, [ins["C"], WIRE_CHUNK, bits, levels]
        fn.argtypes = [ptr] * 5 + [i32, i64, i32, i32, i32, ptr]

    def launch():
        if fn(*args, *rest, _stream()) != 0:
            raise RuntimeError(f"the {codec} {route} launch failed")
    return launch


def flushes():
    """Each codec route, probe_stream, fedavg_aggregate and sparse_aggregate
    at the CNN and 2NN shapes under both flushes in turns (zeroing, clean,
    clean, zeroing; each flush's time the mean of its two medians). Returns
    the rows {name: (zeroing ms, clean ms)} and whether the zeroing flush
    costs probe_stream at the q8 CNN bytes FLUSH_SWITCH_RATIO or more."""
    from repro_torch.kernels import quantized_agg as qa
    from repro_torch.kernels.fedavg_agg import fedavg_aggregate
    from repro_torch.kernels.sparse_agg import sparse_aggregate

    buf = _flush_buffer()
    both = {"zeroing": zeroing_flush(buf), "clean": clean_flush(buf)}
    lib = _probe_lib()
    rows = {}
    for shape, N in WIRE_N.items():
        ins = _wire_inputs(N)

        def floor(codec, ins=ins):
            p = ins[codec]
            row_bytes = p.shape[1] * p.element_size()

            def launch():
                if lib.probe_stream_run(p.data_ptr(), WIRE_K, row_bytes, ins["out"].data_ptr(),
                                        ins["out"].numel(), _stream()) != 0:
                    raise RuntimeError("probe_stream failed to launch")
            return launch

        fns = {
            f"probe_stream q8 bytes {shape}": floor("q8"),
            f"probe_stream q4 bytes {shape}": floor("q4"),
            **{f"{codec} {route} {shape}": _wire_launch(qa._lib(), ins, codec, route)
               for codec in ("q8", "q4") for route in ("general", "stream")},
            f"fedavg_aggregate {shape}": lambda ins=ins: fedavg_aggregate(ins["x"], ins["w"]),
            f"sparse_aggregate top-5% {shape}": lambda ins=ins: sparse_aggregate(
                ins["idx"], ins["vals"], ins["w"], ins["N"]),
        }
        for name, fn in fns.items():
            turns = [(f, _time_ms(fn, both[f])) for f in ("zeroing", "clean", "clean", "zeroing")]
            rows[name] = tuple(float(np.mean([t for f2, t in turns if f2 == f]))
                               for f in ("zeroing", "clean"))
    zero, clean = rows["probe_stream q8 bytes cnn"]
    return rows, zero >= FLUSH_SWITCH_RATIO * clean


def durations():
    """The codec routes, probe_stream, fedavg_aggregate and both routes of
    sparse_aggregate at the CNN and 2NN shapes, and fedavg_aggregate at
    FEDAVG_SHAPES, under the clean flush: the
    CUDA-event time (median of 50) beside each of the kernels' device
    durations as CUPTI records them (median of 40; the sparse scatter
    route's fill and scatter kernel are two records), {name: (event ms,
    {kernel: device ms})}."""
    from repro_torch.kernels import quantized_agg as qa
    from repro_torch.kernels import sparse_agg
    from repro_torch.kernels.fedavg_agg import fedavg_aggregate

    flush = clean_flush(_flush_buffer())
    lib = _probe_lib()
    rows = {}
    for shape, N in WIRE_N.items():
        ins = _wire_inputs(N)
        fns = {f"{codec} {route} {shape}": (_wire_launch(qa._lib(), ins, codec, route),
                                            ["qagg_stream" if route == "stream" else "qagg_kernel"])
               for codec in ("q8", "q4") for route in ("general", "stream")}
        for codec in ("q8", "q4"):
            p = ins[codec]
            fns[f"probe_stream {codec} bytes {shape}"] = (
                lambda p=p, ins=ins: lib.probe_stream_run(
                    p.data_ptr(), WIRE_K, p.shape[1] * p.element_size(), ins["out"].data_ptr(),
                    ins["out"].numel(), _stream()), ["probe_stream"])
        fns[f"fedavg_aggregate {shape}"] = (
            lambda ins=ins: fedavg_aggregate(ins["x"], ins["w"]), ["fedavg_agg"])
        for route, keys in SPARSE_KERNELS.items():
            fns[f"sparse_aggregate {route} top-5% {shape}"] = (
                lambda ins=ins, route=route: sparse_agg._launch(
                    ins["idx"], ins["vals"], ins["w"], ins["out"][:ins["N"]], route), keys)
        for name, (fn, keys) in fns.items():
            rows[name] = (_time_ms(fn, flush), _device_ms(fn, keys, flush))
    g = torch.Generator(device="cuda").manual_seed(8)
    for tag, (K, N) in FEDAVG_SHAPES.items():
        x = torch.randn((K, N), generator=g, device="cuda")
        w = torch.rand(K, generator=g, device="cuda") + 0.1
        w = w / w.sum()

        def fn(x=x, w=w):
            return fedavg_aggregate(x, w)

        rows[f"fedavg_aggregate {tag} (K={K}, N={N})"] = (_time_ms(fn, flush),
                                                          _device_ms(fn, ["fedavg_agg"], flush))
    return rows


# sparse_aggregate's kernels by route, as CUPTI names them: the scatter
# route is torch's fill of the output, then sparse_agg_kernel
SPARSE_KERNELS = {"scatter": ["FillFunctor", "sparse_agg_kernel"],
                  "fused": ["sparse_agg_fused_kernel"]}


def topk_round_payload():
    """What one CNN top-5% round's clients upload, at full size: the (K, k)
    int32 indices and fp32 values, their normalized weights and n. The
    round is ``RoundEngine(codec=topk_codec(0.05)).round()`` on the card with
    specs/mnist_cnn_noniid.json's fedavg and partition sections on synthetic
    MNIST (60,000 examples, seed 0), from the model's seed-0 params."""
    import json
    from pathlib import Path

    from repro_torch.core import compression as comp
    from repro_torch.core.engine import RoundEngine
    from repro_torch.core.fedavg import FedAvgConfig
    from repro_torch.data.partition import partition_pathological_noniid
    from repro_torch.data.synthetic import make_image_classification
    from repro_torch.kernels.ops import normalized_weights
    from repro_torch.models import paper

    spec = json.loads((Path(__file__).resolve().parents[3] / "specs" /
                       "mnist_cnn_noniid.json").read_text())
    fed, part = spec["fedavg"], spec["partition"]
    train, _, _ = make_image_classification(60_000, 10_000, seed=0)
    split = partition_pathological_noniid(train.y, part["n_clients"], part["shards_per_client"],
                                          seed=part["seed"])
    cfg = FedAvgConfig(C=fed["C"], E=fed["E"], B=fed["B"], lr=fed["lr"],
                       lr_decay=fed["lr_decay"], seed=fed["seed"])
    model = paper.mnist_cnn(device="cuda")
    codec = comp.topk_codec(0.05)
    box = {}

    def aggregate(payloads, weights, n):
        box.update(payloads=payloads, weights=weights, n=n)
        return codec.aggregate(payloads, weights, n)

    eng = RoundEngine(model.loss, model.init(fed["seed"]),
                      [(train.x[i], train.y[i]) for i in split.client_indices], cfg,
                      codec=codec._replace(aggregate=aggregate), device="cuda")
    eng.round()
    torch.cuda.synchronize()
    pay = box["payloads"]
    return (pay["idx"].contiguous(), pay["values"].contiguous(),
            normalized_weights(box["weights"], "cuda"), box["n"])


def sparse(timed):
    """sparse_aggregate's gap, attributed. ``timed``: :func:`durations`'
    rows, which hold both routes at the CNN and 2NN shapes (K = 10, top-5%,
    uniform distinct indices a client). Measured here: probe_red's RED
    floor on the same indices, on coalesced ones (t mod n) and on one real
    CNN top-k round's payload; both routes on that payload; the share of
    distinct indices among the K * k pairs; the cuts (CUTS) at the CNN
    shape. Then, for each route at the CNN shape, the time each part takes:
    the launch (event time less device time), the fill (scatter) or the zero
    phase and grid sync (fused), the division (scatter), the RED rate
    (probe_red on uniform indices) and collisions (probe_red on the real
    payload less on uniform indices); the largest holds the route. Returns
    (rows, verdicts): {name: (event ms, {kernel: device ms}) or a share},
    {route: ({part: ms}, part)}."""
    from repro_torch.kernels import sparse_agg

    flush = clean_flush(_flush_buffer())
    lib = _probe_lib()
    rows = {}

    def red_floor(tag, idx, n):
        sink = torch.zeros(n, device="cuda")
        fn = lambda: lib.probe_red_run(idx.data_ptr(), idx.numel(), sink.data_ptr(),  # noqa: E731
                                       _stream())
        rows[f"probe_red {tag}"] = (_time_ms(fn, flush), _device_ms(fn, ["probe_red"], flush))

    def routes(tag, idx, vals, w, n, lib=None, only=None):
        out = torch.empty(n, device="cuda")
        for route, keys in SPARSE_KERNELS.items():
            if only is not None and route != only:
                continue
            if lib is None:
                fn = lambda route=route: sparse_agg._launch(idx, vals, w, out, route)  # noqa: E731
            else:   # a cut: its kernel alone (no fill), launched from its library
                c_fn = getattr(lib, "sparse_aggregate_fused_f32" if route == "fused"
                               else "sparse_aggregate_f32")
                c_fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                                         ctypes.c_longlong, ctypes.c_void_p]
                keys = keys[-1:]
                fn = lambda c_fn=c_fn: c_fn(idx.data_ptr(), vals.data_ptr(), w.data_ptr(),  # noqa: E731
                                            out.data_ptr(), *idx.shape, n, _stream())
            rows[f"sparse_aggregate {route} {tag}"] = (_time_ms(fn, flush),
                                                       _device_ms(fn, keys, flush))

    for shape, N in WIRE_N.items():
        ins = _wire_inputs(N)
        idx = ins["idx"]
        K, k = idx.shape
        coalesced = (torch.arange(K * k, device="cuda") % N).to(torch.int32).view(K, k)
        red_floor(f"coalesced {shape}", coalesced, N)
        red_floor(f"uniform {shape}", idx, N)
        rows[f"distinct share uniform {shape}"] = idx.unique().numel() / idx.numel()

    idx, vals, w, n = topk_round_payload()
    red_floor("real cnn", idx, n)
    routes("real cnn", idx, vals, w, n)
    rows["distinct share real cnn"] = idx.unique().numel() / idx.numel()

    ins = _wire_inputs(WIRE_N["cnn"])
    routes("uniform cnn: the kernel", ins["idx"], ins["vals"], ins["w"], ins["N"],
           lib=sparse_agg._lib())
    for name, variant in CUTS:
        if name == "sparse_agg":
            routes(f"uniform cnn: {variant}", ins["idx"], ins["vals"], ins["w"], ins["N"],
                   lib=_cut_library(name, variant), only=variant.split(":")[0])

    def dev(name, key):
        return rows[name][1][key]

    red = dev("probe_red uniform cnn", "probe_red")
    collide = dev("probe_red real cnn", "probe_red") - red
    ev_s, parts_s = timed["sparse_aggregate scatter top-5% cnn"]
    ev_f, parts_f = timed["sparse_aggregate fused top-5% cnn"]
    verdicts = {
        "scatter": {
            "launch": ev_s - sum(parts_s.values()),
            "fill": parts_s["FillFunctor"],
            "division": (dev("sparse_aggregate scatter uniform cnn: the kernel", "sparse_agg_kernel")
                         - dev("sparse_aggregate scatter uniform cnn: scatter: 32-bit row",
                               "sparse_agg_kernel")),
            "RED rate": red, "collisions": collide},
        "fused": {
            "launch": ev_f - parts_f["sparse_agg_fused_kernel"],
            "zero phase and grid sync": (
                dev("sparse_aggregate fused uniform cnn: the kernel", "sparse_agg_fused_kernel")
                - dev("sparse_aggregate fused uniform cnn: fused: no zero phase or grid sync",
                      "sparse_agg_fused_kernel")),
            "RED rate": red, "collisions": collide},
    }
    return rows, {r: (parts, max(parts, key=parts.get)) for r, parts in verdicts.items()}


def timeline():
    """Medians over blocks of when each of a block's first four tiles passes
    each of TIMELINE_STEPS, in microseconds from the first block's start,
    for both codecs' stream route at the CNN and 2NN shapes, one launch each
    after the clean flush."""
    lib = _edited_library("quantized_agg", "stream timeline", TIMELINE_EDITS)
    flush = clean_flush(_flush_buffer())
    rows = {}
    for shape, N in WIRE_N.items():
        ins = _wire_inputs(N)
        for codec in ("q8", "q4"):
            fn = _wire_launch(lib, ins, codec, "stream")
            fn()
            torch.cuda.synchronize()
            if lib.probe_timeline_clear() != 0:
                raise RuntimeError("could not clear the timeline")
            flush()
            fn()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (TIMELINE_BLOCKS * 32))()
            if lib.probe_timeline_read(buf) != 0:
                raise RuntimeError("could not read the timeline")
            a = np.frombuffer(buf, dtype=np.uint64).reshape(TIMELINE_BLOCKS, 32)
            a = a[a[:, 0] > 0].astype(np.int64)
            t0 = a[:, 0].min()
            for i in range(4):
                steps = a[:, 1 + 6 * i: 7 + 6 * i]
                landed = steps[:, 0] > 0
                if landed.any():
                    rows[f"{codec} {shape} ({len(a)} blocks) tile {i}"] = np.median(
                        (steps[landed] - t0) / 1e3, axis=0)
    return rows


def _parts(parts):
    """A route's device ms: their sum, then each kernel's where there are
    several."""
    total = f"{sum(parts.values()):.5f}"
    if len(parts) == 1:
        return total
    return total + " (" + ", ".join(f"{k} {t:.5f}" for k, t in parts.items()) + ")"


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe: this needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    rows, switch = flushes()
    print("== the L2 flush, ms (zeroing, clean; zeroing / clean)")
    for k, (zero, clean) in rows.items():
        print(f"  {k}: {zero:.5f} {clean:.5f} {zero / clean:.3f}")
    print(f"  verdict: the zeroing flush costs probe_stream at the q8 CNN bytes "
          f"{rows['probe_stream q8 bytes cnn'][0] / rows['probe_stream q8 bytes cnn'][1]:.3f}x "
          f"the clean flush's time: {'switch' if switch else 'keep'} "
          f"(switch from {FLUSH_SWITCH_RATIO:.2f}x)")
    print("== the clean flush: CUDA-event ms, device ms (CUPTI; the sum of a route's "
          "kernels, then each); events - device")
    timed = durations()
    for k, (event, parts) in timed.items():
        print(f"  {k}: {event:.5f} {_parts(parts)}; {event - sum(parts.values()):.5f}")
    rows, verdicts = sparse(timed)
    print("== sparse_aggregate (the clean flush): CUDA-event ms, device ms (CUPTI); "
          "distinct shares")
    for k, v in rows.items():
        print(f"  {k}: " + (f"{v:.5f}" if isinstance(v, float) else f"{v[0]:.5f} {_parts(v[1])}"))
    for route, (parts, largest) in verdicts.items():
        print(f"  verdict, {route} route at the CNN shape (device ms; launch is events less "
              f"device): " + ", ".join(f"{p} {t:.5f}" for p, t in parts.items())
              + f": held by {largest}")
    print("== the stream route's tiles, us from the first block's start (medians over "
          "blocks): " + ", ".join(TIMELINE_STEPS))
    for k, v in timeline().items():
        print(f"  {k}: " + " ".join(f"{x:.2f}" for x in v))
    for what, rows in (("calibration", calibrate()), ("ablations, ms", ablate())):
        print(f"== {what}")
        for k, v in rows.items():
            print(f"  {k}: {v:.5f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
