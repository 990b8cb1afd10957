"""FedAvg server aggregation: ``out[n] = sum_k w[k] * x[k, n]``.

Replaces ``repro/kernels/fedavg_agg.py::fedavg_aggregate`` (the Pallas
``_agg_kernel``). On a CUDA tensor the work goes to the hand-written kernel
in ``csrc/fedavg_agg.cu``; it is bound by HBM bytes, and its design reads
each input byte once and writes each output byte once (see the source
note). On a CPU tensor it goes to :func:`fedavg_aggregate_ref`, the plain
version beside it. The tensor's device decides; a CUDA tensor launches the
kernel or raises, with no fallback.

Contract, as the reference's: ``weights`` sum to 1. Raw example counts are
normalized in one place, ``ops.tree_fedavg_aggregate`` (reached through
``core.fedavg.server_aggregate``). The sum is checked here only for CPU
weights, as the reference checks only concrete ones: reading CUDA weights
back would cost a device sync on every round.

Partial-sum mode (``normalized=False``, the reference's sanctioned exception
at ``repro/kernels/fedavg_agg.py:111-119``): a rank of a cohort-sharded round
holds only its slice of the cohort, whose raw weights cannot sum to 1, so
the sum is not checked. The kernel is the same plain weighted sum either
way (no term folds the weights' total in, and nothing is chosen by their
values); ``ops.sharded_fedavg_aggregate`` finishes the mean with one
all-reduce and one division.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.grad_guard import NOT_DIFFERENTIATED, refuse_grad

# Dynamic shared memory holds the (K,) fp32 weights: 48 KB without opting in.
MAX_K = 48 * 1024 // 4


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("fedavg_agg")
    args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    for fn in (lib.fedavg_aggregate_f32, lib.fedavg_aggregate_bf16):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.fedavg_aggregate_vec.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
    lib.fedavg_aggregate_vec.restype = ctypes.c_int
    lib.fedavg_aggregate_error_string.argtypes = [ctypes.c_int]
    lib.fedavg_aggregate_error_string.restype = ctypes.c_char_p
    return lib


def fedavg_aggregate_ref(stacked: torch.Tensor, weights: torch.Tensor,
                         accum_dtype=torch.float32) -> torch.Tensor:
    """Plain version: accumulate ``w[k] * x[k]`` over k in ``accum_dtype``,
    one row at a time, and cast to the storage dtype. A ``bfloat16``
    ``accum_dtype`` rounds the running sum to bf16 at every row — the
    precision cliff the reference's ``accum_dtype`` option demonstrates."""
    acc = torch.zeros(stacked.shape[1], dtype=accum_dtype, device=stacked.device)
    w = weights.to(accum_dtype)
    for k in range(stacked.shape[0]):
        acc = acc + w[k] * stacked[k].to(accum_dtype)
    return acc.to(stacked.dtype)


def _check(stacked: torch.Tensor, weights: torch.Tensor) -> None:
    if stacked.ndim != 2 or weights.ndim != 1 or weights.shape[0] != stacked.shape[0]:
        raise ValueError(
            f"fedavg_aggregate needs stacked (K, N) and weights (K,); got "
            f"{tuple(stacked.shape)} and {tuple(weights.shape)}"
        )
    if stacked.shape[0] < 1:
        raise ValueError("fedavg_aggregate needs at least one client row (K >= 1)")
    if stacked.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stacked must be float32 or bfloat16, got {stacked.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    if stacked.device != weights.device:
        raise ValueError(
            f"stacked on {stacked.device} but weights on {weights.device}"
        )


def fedavg_aggregate(stacked: torch.Tensor, weights: torch.Tensor, *,
                     accum_dtype=torch.float32, normalized: bool = True) -> torch.Tensor:
    """Weighted sum over the client axis: (K, N), (K,) -> (N,) in the
    storage dtype, accumulated in fp32. ``normalized=False`` is the
    partial-sum mode: raw weights, any sum (module docstring).

    ``fedavg_aggregate.launches`` counts kernel launches (CPU calls and
    empty outputs launch nothing and count nothing, and neither does a
    call under a CUDA stream capture, which only records the launch);
    ``fedavg_aggregate.partial_launches`` those in partial-sum mode."""
    _check(stacked, weights)
    if stacked.device.type == "cpu":
        s = float(weights.sum())
        if normalized and abs(s - 1.0) > 1e-3:
            raise ValueError(
                "fedavg_aggregate requires pre-normalized weights (sum==1); "
                f"got sum={s:.6f}. Pass raw counts to server_aggregate / "
                "tree_fedavg_aggregate instead — normalization lives there."
            )
        return fedavg_aggregate_ref(stacked, weights, accum_dtype)
    if stacked.device.type != "cuda":
        raise ValueError(f"fedavg_aggregate runs on cpu or cuda, not {stacked.device}")
    refuse_grad("fedavg_aggregate", (stacked, weights), NOT_DIFFERENTIATED)
    if accum_dtype != torch.float32:
        raise ValueError(
            "the CUDA fedavg_aggregate accumulates in float32 only; "
            f"accum_dtype={accum_dtype} runs on the CPU plain version"
        )
    if not (stacked.is_contiguous() and weights.is_contiguous()):
        raise ValueError("fedavg_aggregate needs contiguous stacked and weights")
    K, N = stacked.shape
    if K > MAX_K:
        raise ValueError(f"fedavg_aggregate takes at most {MAX_K} client rows, got {K}")
    out = torch.empty(N, dtype=stacked.dtype, device=stacked.device)
    if N == 0:
        return out
    lib = _lib()
    fn = lib.fedavg_aggregate_f32 if stacked.dtype == torch.float32 \
        else lib.fedavg_aggregate_bf16
    stream = torch.cuda.current_stream(stacked.device).cuda_stream
    rc = fn(stacked.data_ptr(), weights.data_ptr(), out.data_ptr(), K, N, stream)
    if rc != 0:
        msg = lib.fedavg_aggregate_error_string(rc).decode()
        raise RuntimeError(f"fedavg_aggregate kernel launch failed: {msg} ({rc})")
    if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
        fedavg_aggregate.launches += 1
        fedavg_aggregate.partial_launches += not normalized
    return out


fedavg_aggregate.launches = 0
fedavg_aggregate.partial_launches = 0


def access_width(stacked: torch.Tensor, out: torch.Tensor) -> int:
    """Elements per load the kernel uses for these tensors (1 is the scalar
    path): the widest access that N and both pointers' alignment allow."""
    return _lib().fedavg_aggregate_vec(
        stacked.data_ptr(), out.data_ptr(), stacked.shape[1], stacked.element_size())
