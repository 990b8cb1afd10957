"""The top-k codec's server average: scatter-add sparse client payloads
into a dense fp32 vector without densifying the clients.

Replaces ``repro/kernels/sparse_agg.py::sparse_aggregate`` (the Pallas
``_sparse_kernel``)::

    out = zeros(n);  out[idx[k, j]] += w[k] * vals[k, j]   for every (k, j)

Duplicate indices add; a client with weight 0 (a ghost) adds zeros. On a
CUDA tensor the work goes to one of two routes of hand-written kernels in
``csrc/sparse_agg.cu`` (bound by HBM bytes and the card's rate of fp32
reductions into L2; see the source note), chosen by :func:`_route` from
shapes, dtypes and alignment:

- ``"fused"``, ``sparse_agg_fused_kernel``: one cooperative launch of a
  persistent grid (one block an SM) that asks for its pairs, zeroes the
  output, syncs the grid and scatters, 4 pairs of a row to a 16-byte load.
  It takes k % 4 == 0 on 16-byte aligned ``idx``, fp32 ``vals`` and output
  (bf16 ``vals`` 8-byte aligned): the specs' top-5% at the CNN and 2NN
  sizes.
- ``"scatter"``, ``sparse_agg_kernel``: everything else. The output is
  zeroed first (a fill kernel), then one thread a pair.

The sum order varies from run to run on both. On a CPU tensor the work goes
to the plain version beside them, :func:`densify_ref` then
``fedavg_aggregate_ref``. The tensor's device decides; a CUDA tensor
launches a kernel or raises, with no fallback. Indices outside [0, n) are
dropped on every path; top-k emits none.

Weights are normalized to sum to 1; raw counts are normalized in
``ops.sparse_fedavg_aggregate``. The sum is checked here only for CPU
weights.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.grad_guard import NOT_DIFFERENTIATED, refuse_grad
from repro_torch.kernels.fedavg_agg import fedavg_aggregate_ref

ROUTES = ("fused", "scatter")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("sparse_agg")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.sparse_aggregate_f32, lib.sparse_aggregate_bf16,
               lib.sparse_aggregate_fused_f32, lib.sparse_aggregate_fused_bf16):
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i64, i64, ptr]
        fn.restype = i32
    lib.sparse_aggregate_fused_plan.argtypes = [i64, i32, ctypes.POINTER(i64)]
    lib.sparse_aggregate_fused_plan.restype = i32
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

    ``sparse_aggregate.launches`` counts kernel launches, of either route;
    ``sparse_aggregate.fused_launches`` those of the fused route (CPU calls
    and k = 0 launch nothing and count nothing)."""
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
    refuse_grad("sparse_aggregate", (vals, weights), NOT_DIFFERENTIATED)
    if accum_dtype != torch.float32:
        raise ValueError("the CUDA sparse_aggregate accumulates in float32 only; "
                         f"accum_dtype={accum_dtype} runs on the CPU plain version")
    if not (idx.is_contiguous() and vals.is_contiguous() and weights.is_contiguous()):
        raise ValueError("sparse_aggregate needs contiguous idx, vals and weights")
    if k == 0:
        return torch.zeros(n, dtype=torch.float32, device=idx.device)
    out = torch.empty(n, dtype=torch.float32, device=idx.device)
    return _launch(idx, vals, weights, out, _route(idx, vals, out, K=K, k=k))


sparse_aggregate.launches = 0
sparse_aggregate.fused_launches = 0


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------

def _route(idx: torch.Tensor, vals: torch.Tensor, out: torch.Tensor, *, K: int,
           k: int) -> str:
    """``"fused"`` when ``sparse_agg_fused_kernel`` takes the call, else
    ``"scatter"``. The fused kernel reads each row 4 pairs at a time, so k
    must be a multiple of 4 and every row start aligned: ``idx``, fp32
    ``vals`` and ``out`` on 16 bytes, bf16 ``vals`` on 8. It reads shapes,
    dtypes and ``data_ptr()`` only, on any device, before any build."""
    vals_align = 4 * vals.element_size()
    if (K >= 1 and k >= 4 and k % 4 == 0 and idx.data_ptr() % 16 == 0
            and vals.data_ptr() % vals_align == 0 and out.data_ptr() % 16 == 0):
        return "fused"
    return "scatter"


def _launch(idx, vals, weights, out, route):
    """One launch of ``route``'s kernel into the (n,) fp32 ``out`` (the
    scatter route zeroes it first) on CUDA tensors that
    :func:`sparse_aggregate` has checked, k >= 1; advances its counters.
    Module-private: ``chip_smoke.py`` and the card's tests force each route
    through it. It refuses an unknown route, or ``"fused"`` where
    :func:`_route` says no, before any build."""
    if route not in ROUTES:
        raise ValueError(f"sparse_aggregate has no route {route!r}")
    K, k = idx.shape
    if route == "fused" and _route(idx, vals, out, K=K, k=k) != "fused":
        raise ValueError(
            f"the fused route does not take k={k} with idx at {idx.data_ptr() % 16}, "
            f"{vals.dtype} vals at {vals.data_ptr() % 16} and out at "
            f"{out.data_ptr() % 16} bytes past a 16-byte boundary")
    lib = _lib()
    bf16 = vals.dtype == torch.bfloat16
    if route == "fused":
        fn = lib.sparse_aggregate_fused_bf16 if bf16 else lib.sparse_aggregate_fused_f32
    else:
        out.zero_()
        fn = lib.sparse_aggregate_bf16 if bf16 else lib.sparse_aggregate_f32
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    rc = fn(idx.data_ptr(), vals.data_ptr(), weights.data_ptr(), out.data_ptr(),
            K, k, out.shape[0], stream)
    if rc != 0:
        msg = lib.sparse_aggregate_error_string(rc).decode()
        raise RuntimeError(f"sparse_aggregate {route} kernel launch failed: {msg} ({rc})")
    sparse_aggregate.launches += 1
    if route == "fused":
        sparse_aggregate.fused_launches += 1
    return out


def fused_plan(n: int, vals_dtype=torch.float32) -> dict:
    """The fused route's launch for n outputs: threads a block, blocks an SM
    can hold (the occupancy query), the grid, items a thread asks for at a
    time and float4s of the output a block zeroes."""
    geom = (ctypes.c_longlong * 5)()
    lib = _lib()
    rc = lib.sparse_aggregate_fused_plan(n, 2 if vals_dtype == torch.bfloat16 else 4, geom)
    if rc != 0:
        msg = lib.sparse_aggregate_error_string(rc).decode()
        raise RuntimeError(f"sparse_aggregate fused plan failed: {msg} ({rc})")
    return dict(zip(("threads", "blocks_per_sm", "grid", "unroll", "stripe"), geom))
