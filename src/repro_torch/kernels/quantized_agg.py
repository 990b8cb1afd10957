"""The quantize codec's server average with the decode fused in.

``quantized_aggregate`` replaces ``repro/kernels/quantized_agg.py::
quantized_aggregate`` (the Pallas ``_qagg_kernel``) and
``packed_quantized_aggregate`` its bit-packed twin (``_packed_qagg_kernel``).
Both compute

    out[n] = sum_k w[k] * (q[k, n] * scale[k, c] / levels + lo[k, c]),  c = n // chunk

in fp32 without materializing the dense (K, N) client deltas. On a CUDA
tensor the work goes to the hand-written kernels in
``csrc/quantized_agg.cu`` (bound by HBM bytes; see the source note). On a
CPU tensor it goes to the plain versions beside them:
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
           cost a device sync every round).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.fedavg_agg import MAX_K, fedavg_aggregate_ref
from repro_torch.utils.bitpack import unpack_codes, words_per_chunk

CODE_DTYPES = (torch.uint8, torch.uint16)


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
                        accum_dtype=torch.float32) -> torch.Tensor:
    """Fused dequantize + weighted sum over the client axis:
    codes (K, N_pad) uint8/uint16 -> (N_pad,) fp32.

    ``quantized_aggregate.launches`` counts kernel launches (CPU calls launch
    nothing and count nothing)."""
    name = "quantized_aggregate"
    if codes.ndim != 2 or chunk < 1 or codes.shape[1] % chunk:
        raise ValueError(f"codes must be (K, C*chunk); got {tuple(codes.shape)} "
                         f"with chunk={chunk}")
    if codes.dtype not in CODE_DTYPES:
        raise TypeError(f"codes must be uint8 or uint16, got {codes.dtype}")
    _check_common(name, codes, codes.shape[1] // chunk, lo, scale, weights, chunk, levels)
    if codes.device.type == "cpu":
        _check_cpu_weights(name, weights)
        return quantized_aggregate_ref(codes, lo, scale, weights, chunk=chunk,
                                       levels=levels, accum_dtype=accum_dtype)
    K, n_pad = codes.shape
    _check_cuda(name, (codes, lo, scale, weights), accum_dtype, K)
    out = torch.empty(n_pad, dtype=torch.float32, device=codes.device)
    if n_pad == 0:
        return out
    lib = _lib()
    fn = lib.quantized_aggregate_u8 if codes.dtype == torch.uint8 \
        else lib.quantized_aggregate_u16
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    _raise_on(fn(codes.data_ptr(), lo.data_ptr(), scale.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), K, n_pad, chunk, levels, stream), name)
    quantized_aggregate.launches += 1
    return out


quantized_aggregate.launches = 0


def packed_quantized_aggregate(words: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor,
                               weights: torch.Tensor, *, bits: int, chunk: int,
                               levels: int, accum_dtype=torch.float32) -> torch.Tensor:
    """Fused unpack + dequantize + weighted sum: words (K, C * wpc) int32
    (uint32 bit patterns) -> (C * chunk,) fp32, for bits 1..15.

    ``packed_quantized_aggregate.launches`` counts kernel launches."""
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
        _check_cpu_weights(name, weights)
        return packed_quantized_aggregate_ref(words, lo, scale, weights, bits=bits,
                                              chunk=chunk, levels=levels,
                                              accum_dtype=accum_dtype)
    K = words.shape[0]
    _check_cuda(name, (words, lo, scale, weights), accum_dtype, K)
    out = torch.empty(C * chunk, dtype=torch.float32, device=words.device)
    if C == 0:
        return out
    stream = torch.cuda.current_stream(words.device).cuda_stream
    _raise_on(_lib().packed_quantized_aggregate(
        words.data_ptr(), lo.data_ptr(), scale.data_ptr(), weights.data_ptr(),
        out.data_ptr(), K, C, chunk, bits, levels, stream), name)
    packed_quantized_aggregate.launches += 1
    return out


packed_quantized_aggregate.launches = 0


def access_width(codes: torch.Tensor, out: torch.Tensor, chunk: int) -> int:
    """Codes per load the unpacked kernel uses for these tensors (1 is the
    scalar path)."""
    return _lib().quantized_aggregate_vec(
        codes.data_ptr(), out.data_ptr(), chunk, codes.element_size())
