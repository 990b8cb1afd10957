"""The top-k codec's server average: scatter-add sparse client payloads
into a dense fp32 vector without densifying the clients.

Replaces ``repro/kernels/sparse_agg.py::sparse_aggregate`` (the Pallas
``_sparse_kernel``)::

    out = zeros(n);  out[idx[k, j]] += w[k] * vals[k, j]   for every (k, j)

Duplicate indices add; a client with weight 0 (a ghost) adds zeros. On a
CUDA tensor the work goes to the hand-written kernel in
``csrc/sparse_agg.cu`` (one fp32 atomic add per pair, bound by HBM bytes;
see the source note), whose sum order varies from run to run. On a CPU
tensor it goes to the plain version beside it, :func:`densify_ref` then
``fedavg_aggregate_ref``. The tensor's device decides; a CUDA tensor
launches the kernel or raises, with no fallback. Indices outside [0, n)
are dropped on both paths; top-k emits none.

Weights are normalized to sum to 1; raw counts are normalized in
``ops.sparse_fedavg_aggregate``. The sum is checked here only for CPU
weights.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.fedavg_agg import fedavg_aggregate_ref


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("sparse_agg")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.sparse_aggregate_f32, lib.sparse_aggregate_bf16):
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i64, i64, ptr]
        fn.restype = i32
    lib.sparse_aggregate_error_string.argtypes = [i32]
    lib.sparse_aggregate_error_string.restype = ctypes.c_char_p
    return lib


def densify_ref(idx: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """(K, k) sparse payloads -> dense (K, n) fp32, adding on duplicate
    indices and dropping indices outside [0, n)."""
    K = idx.shape[0]
    flat = idx.to(torch.int64) + n * torch.arange(K, device=idx.device)[:, None]
    keep = (idx >= 0) & (idx < n)
    out = torch.zeros(K * n, dtype=torch.float32, device=idx.device)
    out.index_add_(0, flat[keep], vals.to(torch.float32)[keep])
    return out.reshape(K, n)


def sparse_aggregate_ref(idx, vals, weights, n, *, accum_dtype=torch.float32):
    """Plain version: :func:`densify_ref`, then ``fedavg_aggregate_ref``
    accumulated in ``accum_dtype``; (n,) in ``accum_dtype``."""
    return fedavg_aggregate_ref(densify_ref(idx, vals, n), weights,
                                accum_dtype).to(accum_dtype)


def sparse_aggregate(idx: torch.Tensor, vals: torch.Tensor, weights: torch.Tensor,
                     n: int, *, accum_dtype=torch.float32) -> torch.Tensor:
    """Weighted sum of K sparse client payloads -> dense (n,) fp32.

    ``sparse_aggregate.launches`` counts kernel launches (CPU calls launch
    nothing and count nothing)."""
    if idx.ndim != 2 or tuple(idx.shape) != tuple(vals.shape):
        raise ValueError(f"idx and vals must share a (K, k) shape; got idx "
                         f"{tuple(idx.shape)}, vals {tuple(vals.shape)}")
    K, k = idx.shape
    if K < 1:
        raise ValueError("sparse_aggregate needs at least one client row (K >= 1)")
    if tuple(weights.shape) != (K,):
        raise ValueError(f"weights must be ({K},), got {tuple(weights.shape)}")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"vals must be float32 or bfloat16, got {vals.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    if not (idx.device == vals.device == weights.device):
        raise ValueError(f"idx on {idx.device}, vals on {vals.device}, "
                         f"weights on {weights.device}")
    if idx.device.type == "cpu":
        s = float(weights.sum())
        if abs(s - 1.0) > 1e-3:
            raise ValueError(
                f"sparse_aggregate requires pre-normalized weights (sum==1); got "
                f"sum={s:.6f}. Pass raw counts to ops.sparse_fedavg_aggregate "
                "instead — normalization lives there."
            )
        return sparse_aggregate_ref(idx, vals, weights, n, accum_dtype=accum_dtype)
    if idx.device.type != "cuda":
        raise ValueError(f"sparse_aggregate runs on cpu or cuda, not {idx.device}")
    if accum_dtype != torch.float32:
        raise ValueError("the CUDA sparse_aggregate accumulates in float32 only; "
                         f"accum_dtype={accum_dtype} runs on the CPU plain version")
    if not (idx.is_contiguous() and vals.is_contiguous() and weights.is_contiguous()):
        raise ValueError("sparse_aggregate needs contiguous idx, vals and weights")
    out = torch.zeros(n, dtype=torch.float32, device=idx.device)
    if k == 0:
        return out
    lib = _lib()
    fn = lib.sparse_aggregate_f32 if vals.dtype == torch.float32 \
        else lib.sparse_aggregate_bf16
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    rc = fn(idx.data_ptr(), vals.data_ptr(), weights.data_ptr(), out.data_ptr(),
            K, k, n, stream)
    if rc != 0:
        msg = lib.sparse_aggregate_error_string(rc).decode()
        raise RuntimeError(f"sparse_aggregate kernel launch failed: {msg} ({rc})")
    sparse_aggregate.launches += 1
    return out


sparse_aggregate.launches = 0
