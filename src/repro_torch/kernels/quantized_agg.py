"""The quantize codec's server average with the decode fused in.

``quantized_aggregate`` replaces ``repro/kernels/quantized_agg.py::
quantized_aggregate`` (the Pallas ``_qagg_kernel``) and
``packed_quantized_aggregate`` its bit-packed twin (``_packed_qagg_kernel``).
Both compute

    out[n] = sum_k w[k] * (q[k, n] * scale[k, c] / levels + lo[k, c]),  c = n // chunk

in fp32 without materializing the dense (K, N) client deltas. On a CUDA
tensor the work goes to one of two routes of hand-written kernels in
``csrc/quantized_agg.cu`` (bound by HBM bytes; see the source note), chosen
by :func:`_route` from shapes, dtypes, alignment and K:

- ``"stream"``, ``qagg_stream_kernel``: persistent blocks stream column
  tiles through a ring of TMA bulk copies, decode without int-to-float
  conversions and store whole 16-byte rows. It takes uint8/uint16 codes and
  words at bits 1, 2 and 4 whose chunk is a whole number of 16-byte granules
  of at least ``MIN_CHUNK_BYTES``, on 16-byte aligned pointers, with at most
  ``STREAM_MAX_K`` rows: the specs' chunk 512 at q8, q16, q4, q2 and q1.
- ``"general"``, ``qagg_kernel`` / ``packed_qagg_kernel``: everything else
  (odd chunks, misaligned views, bits 3 and 5-15, larger K).

Both compute the same fma chain in the same k order. On a CPU tensor the
work goes to the plain versions beside them:
:func:`dequantize_ref` (after :func:`unpack_ref` for packed words) then
``fedavg_aggregate_ref``. The tensor's device decides; a CUDA tensor
launches the kernel or raises, with no fallback.

Layout, as the reference's (produced by ``core.compression.quantize_codec``):

  codes:   (K, N_pad) uint8 or uint16, N_pad a multiple of ``chunk``.
  words:   (K, C * wpc) int32 holding the uint32 wire words
           (``utils.bitpack`` chunk frames, wpc = ceil(chunk / (32 // bits))).
  lo:      (K, C) fp32 per-chunk offsets; scale: (K, C) fp32 per-chunk ranges
           (0 for a constant chunk, which decodes exactly to lo).
  weights: (K,) fp32, normalized to sum to 1. Raw counts are normalized in
           ``ops.quantized_fedavg_aggregate`` and its packed twin; the sum is
           checked here only for CPU weights (reading CUDA weights back would
           cost a device sync every round). ``normalized=False`` is the
           partial-sum mode of a cohort-sharded round (``ops.sharded_*``):
           raw weights, any sum, the sum not checked; the kernels compute the
           same weighted sum either way.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.fedavg_agg import MAX_K, fedavg_aggregate_ref
from repro_torch.kernels.grad_guard import NOT_DIFFERENTIATED, refuse_grad
from repro_torch.utils.bitpack import unpack_codes, words_per_chunk

CODE_DTYPES = (torch.uint8, torch.uint16)
ROUTES = ("stream", "general")
# csrc/quantized_agg.cu's kStreamMaxK: two ring stages of K rows of a 2 KB
# tile (128 KB at K = 32), the store staging and the (lo, step) tables fit
# one block's shared memory.
STREAM_MAX_K = 32
# csrc/quantized_agg.cu's kMinChunkBytes: a 2 KB tile row then touches at
# most 33 chunks, which bounds a stage's (lo, step) table.
MIN_CHUNK_BYTES = 64
STREAM_WORD_BITS = (1, 2, 4)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("quantized_agg")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.quantized_aggregate_u8, lib.quantized_aggregate_u16):
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i64, i32, i32, ptr]
        fn.restype = i32
    lib.packed_quantized_aggregate.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i64, i32, i32, i32, ptr]
    lib.packed_quantized_aggregate.restype = i32
    lib.quantized_aggregate_stream.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i64, i32, i32, i32, ptr]
    lib.quantized_aggregate_stream.restype = i32
    lib.quantized_aggregate_stream_plan.argtypes = [i32, i64, i32, i32,
                                                    ctypes.POINTER(i32)]
    lib.quantized_aggregate_stream_plan.restype = i32
    lib.quantized_aggregate_vec.argtypes = [ptr, ptr, i32, i32]
    lib.quantized_aggregate_vec.restype = i32
    lib.quantized_aggregate_error_string.argtypes = [i32]
    lib.quantized_aggregate_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def dequantize_ref(codes: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor, *,
                   chunk: int, levels: int) -> torch.Tensor:
    """Integer codes (K, N_pad) -> dense fp32 (K, N_pad): the code -> value
    map, ``q * (scale / levels) + lo`` of the code's chunk."""
    K, n_pad = codes.shape
    q = codes.to(torch.float32).reshape(K, n_pad // chunk, chunk)
    return (q * (scale / levels)[:, :, None] + lo[:, :, None]).reshape(K, n_pad)


def unpack_ref(words: torch.Tensor, *, bits: int, chunk: int) -> torch.Tensor:
    """(K, C * wpc) int32 words -> (K, C * chunk) int32 codes
    (``utils.bitpack.unpack_codes`` over the client axis)."""
    K = words.shape[0]
    C = words.shape[1] // words_per_chunk(chunk, bits)
    return unpack_codes(words.reshape(-1), bits, chunk, K * C).reshape(K, C * chunk)


def quantized_aggregate_ref(codes, lo, scale, weights, *, chunk, levels,
                            accum_dtype=torch.float32) -> torch.Tensor:
    """Plain version: :func:`dequantize_ref`, then ``fedavg_aggregate_ref``
    accumulated in ``accum_dtype``; (N_pad,) in ``accum_dtype``."""
    dense = dequantize_ref(codes, lo, scale, chunk=chunk, levels=levels)
    return fedavg_aggregate_ref(dense, weights, accum_dtype).to(accum_dtype)


def packed_quantized_aggregate_ref(words, lo, scale, weights, *, bits, chunk, levels,
                                   accum_dtype=torch.float32) -> torch.Tensor:
    """Plain version: :func:`unpack_ref`, then :func:`quantized_aggregate_ref`."""
    codes = unpack_ref(words, bits=bits, chunk=chunk)
    return quantized_aggregate_ref(codes, lo, scale, weights, chunk=chunk,
                                   levels=levels, accum_dtype=accum_dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_common(name, payload, n_cols, lo, scale, weights, chunk, levels):
    if payload.ndim != 2:
        raise ValueError(f"{name} needs 2-D (K, ...) payloads, got {tuple(payload.shape)}")
    if chunk < 1 or levels < 1:
        raise ValueError(f"{name} needs chunk >= 1 and levels >= 1, got {chunk}, {levels}")
    K = payload.shape[0]
    if K < 1:
        raise ValueError(f"{name} needs at least one client row (K >= 1)")
    want = (K, n_cols)
    if tuple(lo.shape) != want or tuple(scale.shape) != want:
        raise ValueError(f"lo/scale must be (K, C)={want}; got lo {tuple(lo.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if tuple(weights.shape) != (K,):
        raise ValueError(f"weights must be ({K},), got {tuple(weights.shape)}")
    for t, what in ((lo, "lo"), (scale, "scale"), (weights, "weights")):
        if t.dtype != torch.float32:
            raise TypeError(f"{what} must be float32, got {t.dtype}")
        if t.device != payload.device:
            raise ValueError(f"payload on {payload.device} but {what} on {t.device}")


def _check_cpu_weights(name, weights):
    s = float(weights.sum())
    if abs(s - 1.0) > 1e-3:
        raise ValueError(
            f"{name} requires pre-normalized weights (sum==1); got sum={s:.6f}. "
            "Pass raw counts to the ops.*_fedavg_aggregate adapters instead — "
            "normalization lives there."
        )


def _check_cuda(name, tensors, accum_dtype, K):
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {tensors[0].device}")
    refuse_grad(name, tensors, NOT_DIFFERENTIATED)
    if accum_dtype != torch.float32:
        raise ValueError(f"the CUDA {name} accumulates in float32 only; "
                         f"accum_dtype={accum_dtype} runs on the CPU plain version")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous payload, lo, scale and weights")
    if K > MAX_K:
        raise ValueError(f"{name} takes at most {MAX_K} client rows, got {K}")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        msg = _lib().quantized_aggregate_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def quantized_aggregate(codes: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor,
                        weights: torch.Tensor, *, chunk: int, levels: int,
                        accum_dtype=torch.float32, normalized: bool = True) -> torch.Tensor:
    """Fused dequantize + weighted sum over the client axis:
    codes (K, N_pad) uint8/uint16 -> (N_pad,) fp32.

    ``quantized_aggregate.launches`` counts kernel launches, of either route;
    ``quantized_aggregate.stream_launches`` those of the stream route and
    ``quantized_aggregate.partial_launches`` those in partial-sum mode
    (``normalized=False``) (CPU calls and empty outputs launch nothing and
    count nothing, and neither does a call under a CUDA stream capture,
    which only records the launch)."""
    name = "quantized_aggregate"
    if codes.ndim != 2 or chunk < 1 or codes.shape[1] % chunk:
        raise ValueError(f"codes must be (K, C*chunk); got {tuple(codes.shape)} "
                         f"with chunk={chunk}")
    if codes.dtype not in CODE_DTYPES:
        raise TypeError(f"codes must be uint8 or uint16, got {codes.dtype}")
    _check_common(name, codes, codes.shape[1] // chunk, lo, scale, weights, chunk, levels)
    if codes.device.type == "cpu":
        if normalized:
            _check_cpu_weights(name, weights)
        return quantized_aggregate_ref(codes, lo, scale, weights, chunk=chunk,
                                       levels=levels, accum_dtype=accum_dtype)
    K = codes.shape[0]
    _check_cuda(name, (codes, lo, scale, weights), accum_dtype, K)
    bits = 8 * codes.element_size()
    out = _out(codes, lo, chunk)
    return _launch(codes, lo, scale, weights, out, bits=bits, chunk=chunk, levels=levels,
                   route=_route(codes, out, chunk=chunk, bits=bits, K=K),
                   normalized=normalized)


quantized_aggregate.launches = 0
quantized_aggregate.stream_launches = 0
quantized_aggregate.partial_launches = 0


def packed_quantized_aggregate(words: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor,
                               weights: torch.Tensor, *, bits: int, chunk: int,
                               levels: int, accum_dtype=torch.float32,
                               normalized: bool = True) -> torch.Tensor:
    """Fused unpack + dequantize + weighted sum: words (K, C * wpc) int32
    (uint32 bit patterns) -> (C * chunk,) fp32, for bits 1..15.

    ``packed_quantized_aggregate.launches`` counts kernel launches, of
    either route; ``packed_quantized_aggregate.stream_launches`` those of
    the stream route and ``packed_quantized_aggregate.partial_launches``
    those in partial-sum mode (``normalized=False``) (a call under a CUDA
    stream capture, which only records the launch, counts nothing)."""
    name = "packed_quantized_aggregate"
    if not 1 <= bits <= 15:
        raise ValueError(f"packed aggregation is for bits in 1..15, got {bits}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    wpc = words_per_chunk(chunk, bits)
    if words.ndim != 2 or words.shape[1] % wpc:
        raise ValueError(f"words must be (K, C*{wpc}) for chunk={chunk}, bits={bits}; "
                         f"got {tuple(words.shape)}")
    if words.dtype != torch.int32:
        raise TypeError(f"words must be int32 (uint32 bit patterns), got {words.dtype}")
    C = words.shape[1] // wpc
    _check_common(name, words, C, lo, scale, weights, chunk, levels)
    if words.device.type == "cpu":
        if normalized:
            _check_cpu_weights(name, weights)
        return packed_quantized_aggregate_ref(words, lo, scale, weights, bits=bits,
                                              chunk=chunk, levels=levels,
                                              accum_dtype=accum_dtype)
    K = words.shape[0]
    _check_cuda(name, (words, lo, scale, weights), accum_dtype, K)
    out = _out(words, lo, chunk)
    return _launch(words, lo, scale, weights, out, bits=bits, chunk=chunk, levels=levels,
                   route=_route(words, out, chunk=chunk, bits=bits, K=K),
                   normalized=normalized)


packed_quantized_aggregate.launches = 0
packed_quantized_aggregate.stream_launches = 0
packed_quantized_aggregate.partial_launches = 0


def access_width(codes: torch.Tensor, out: torch.Tensor, chunk: int) -> int:
    """Codes per load the unpacked kernel uses for these tensors (1 is the
    scalar path)."""
    return _lib().quantized_aggregate_vec(
        codes.data_ptr(), out.data_ptr(), chunk, codes.element_size())


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------

def _out(payload: torch.Tensor, lo: torch.Tensor, chunk: int) -> torch.Tensor:
    """The (C * chunk,) fp32 output of either wrapper."""
    return torch.empty(lo.shape[1] * chunk, dtype=torch.float32, device=payload.device)


def _route(payload: torch.Tensor, out: torch.Tensor, *, chunk: int, bits: int, K: int) -> str:
    """``"stream"`` when ``qagg_stream_kernel`` takes the call, else
    ``"general"``. ``payload`` is uint8/uint16 codes (``bits`` 8 or 16) or
    int32 words (``bits`` 1..15). The stream kernel moves 16-byte granules,
    so a chunk must be a whole number of them (for words: ``32 % bits == 0``
    and no slack codes in a frame) and at least ``MIN_CHUNK_BYTES``, both
    pointers 16-byte aligned, and K at most ``STREAM_MAX_K``. It reads
    shapes, dtypes, ``data_ptr() % 16`` and K only, on any device, before
    any build."""
    ok_bits = bits in (STREAM_WORD_BITS if payload.dtype == torch.int32 else (8, 16))
    chunk_bits = chunk * bits
    if (ok_bits and chunk_bits % 128 == 0 and chunk_bits >= 8 * MIN_CHUNK_BYTES
            and payload.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
            and 1 <= K <= STREAM_MAX_K):
        return "stream"
    return "general"


def _launch(payload, lo, scale, weights, out, *, bits, chunk, levels, route, normalized=True):
    """One launch of ``route``'s kernel into ``out`` (:func:`_out`) on CUDA
    tensors that the wrappers have checked: codes (uint8/uint16, ``bits`` 8
    or 16) for :func:`quantized_aggregate`, int32 words for
    :func:`packed_quantized_aggregate`, whose counters it advances
    (``partial_launches`` too when ``normalized`` is False).
    Module-private: ``chip_smoke.py`` and the card's tests force each route
    through it. It refuses an unknown route, or ``"stream"`` where
    :func:`_route` says no, before any build."""
    if route not in ROUTES:
        raise ValueError(f"quantized aggregation has no route {route!r}")
    words = payload.dtype == torch.int32
    wrapper = packed_quantized_aggregate if words else quantized_aggregate
    K, C = lo.shape
    if route == "stream" and _route(payload, out, chunk=chunk, bits=bits, K=K) != "stream":
        raise ValueError(
            f"the stream route does not take {wrapper.__name__} with K={K}, chunk={chunk}, "
            f"bits={bits}, payload {payload.dtype} at {payload.data_ptr() % 16} bytes past "
            "a 16-byte boundary")
    if C == 0:
        return out
    lib = _lib()
    args = (payload.data_ptr(), lo.data_ptr(), scale.data_ptr(), weights.data_ptr(),
            out.data_ptr(), K)
    stream = torch.cuda.current_stream(payload.device).cuda_stream
    if route == "stream":
        rc = lib.quantized_aggregate_stream(*args, C, chunk, bits, levels, stream)
    elif words:
        rc = lib.packed_quantized_aggregate(*args, C, chunk, bits, levels, stream)
    else:
        fn = lib.quantized_aggregate_u8 if bits == 8 else lib.quantized_aggregate_u16
        rc = fn(*args, C * chunk, chunk, levels, stream)
    _raise_on(rc, f"{wrapper.__name__} {route}")
    if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
        wrapper.launches += 1
        wrapper.partial_launches += not normalized
        if route == "stream":
            wrapper.stream_launches += 1
    return out


def stream_plan(K: int, C: int, *, chunk: int, bits: int) -> dict:
    """The stream route's launch for K rows of C chunks: threads a block,
    tile bytes a row, ring stages, dynamic shared memory, blocks an SM (the
    occupancy query) and the grid."""
    geom = (ctypes.c_int * 6)()
    _raise_on(_lib().quantized_aggregate_stream_plan(K, C, chunk, bits, geom), "stream plan")
    keys = ("threads", "tile_bytes", "stages", "smem_bytes", "blocks_per_sm", "grid")
    return dict(zip(keys, geom))
