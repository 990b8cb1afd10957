"""Gossip neighbour mixing: ``out[i] = sum_s w[i, s] * x[idx[i, s]]``, i.e.
``X <- W @ X`` over the (n_nodes, N) stacked replicas.

Replaces ``repro/kernels/gossip_mix.py::gossip_mix`` (the Pallas
``_mix_kernel``). On a CUDA tensor the work goes to one of two hand-written
kernels in ``csrc/gossip_mix.cu`` (see the source note), chosen by
:func:`_route` from the slots a row has against the nodes:

- ``"gather"``, ``gossip_mix_kernel``: one block per column tile holds that
  tile of every node in shared memory and gathers each output row from it.
  Sparse plans (the ring, the small world) are bound by HBM bytes, which it
  moves once.
- ``"dense"``, ``gossip_mix_dense_kernel``: W built in shared memory from the
  slots, then a register-tiled fp32 ``W @ X`` (8 x 4 outputs a thread) over
  X's column tiles streamed through a ``cp.async`` ring. The full graph is
  bound by its 2 n^2 N flops, which the gather kernel spends a
  shared-memory load on every 4 of.

On a CPU tensor it goes to :func:`gossip_mix_ref`, the plain version beside
it. The tensor's device decides; a CUDA tensor launches a kernel or raises,
with no fallback.

``idx``/``weight`` are a ``MixingPlan``'s padded (n_nodes, max_slots) arrays
(``core/topology.py``). Duplicate ids add, padded slots (``idx = i``,
``weight = 0``) add nothing, and an id outside ``[0, n)`` contributes 0.

Contract, as the reference's: each ``weight`` row sums to 1. It is checked
here only for CPU weights: reading CUDA weights back would cost a device
sync on every round. ``RoundEngine`` checks its plan once, on the host,
when it is built.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.grad_guard import NOT_DIFFERENTIATED, refuse_grad

# csrc/gossip_mix.cu's kMaxNodes: the (n, 32) tile of the gather kernel's
# narrowest block must fit in one block's shared memory.
MAX_NODES = 1024
# The crossover: the dense route from one slot a row for every
# DENSE_NODES_PER_SLOT nodes (D * 5 >= n). The gather kernel's time grows
# with D, a shared-memory load a slot for every 4 outputs, about 0.034 ms a
# slot at n = 100 and the CNN's N above its 0.75 ms byte floor; the dense
# kernel's with n and not with D, 1.17-1.24 ms there. They cross near D =
# 20 = n / 5. From chip_smoke.py phase 4, which times both routes at n = 100
# on the ring, small world and full graph (PERF.md §6, row 5).
DENSE_NODES_PER_SLOT = 5


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("gossip_mix")
    args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.gossip_mix_f32, lib.gossip_mix_bf16, lib.gossip_mix_dense_f32,
               lib.gossip_mix_dense_bf16):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.gossip_mix_dense_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]
    lib.gossip_mix_dense_plan.restype = ctypes.c_int
    lib.gossip_mix_tile.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gossip_mix_tile.restype = ctypes.c_int
    lib.gossip_mix_vec.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_int]
    lib.gossip_mix_vec.restype = ctypes.c_int
    lib.gossip_mix_error_string.argtypes = [ctypes.c_int]
    lib.gossip_mix_error_string.restype = ctypes.c_char_p
    return lib


def gossip_mix_ref(x: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor,
                   accum_dtype=torch.float32) -> torch.Tensor:
    """Plain version, the reference's dense oracle: W from the padded slots
    by a one-hot sum (duplicates add; out-of-range ids match no node), then
    ``W @ X`` in ``accum_dtype``, cast to the storage dtype."""
    n = x.shape[0]
    onehot = (idx.long()[:, :, None] == torch.arange(n, device=x.device)).to(accum_dtype)
    W = torch.einsum("nd,ndm->nm", weight.to(accum_dtype), onehot)
    return (W @ x.to(accum_dtype)).to(x.dtype)


def _check(x: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> None:
    if x.ndim != 2 or idx.ndim != 2 or idx.shape != weight.shape \
            or idx.shape[0] != x.shape[0]:
        raise ValueError(
            "gossip_mix needs x (n_nodes, N) and idx, weight both (n_nodes, "
            f"max_slots); got x {tuple(x.shape)}, idx {tuple(idx.shape)}, "
            f"weight {tuple(weight.shape)}"
        )
    if x.shape[0] < 1 or idx.shape[1] < 1:
        raise ValueError("gossip_mix needs at least one node and one slot per node")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if weight.dtype != torch.float32:
        raise TypeError(f"weight must be float32, got {weight.dtype}")
    if not (x.device == idx.device == weight.device):
        raise ValueError(
            f"x on {x.device}, idx on {idx.device}, weight on {weight.device}"
        )


def _route(x: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> str:
    """``"dense"`` when a row has at least one slot for every
    ``DENSE_NODES_PER_SLOT`` nodes (the full graph), else ``"gather"`` (the
    ring, the small world). Both
    kernels take every input the wrapper takes (n up to ``MAX_NODES``, fp32
    or bf16, contiguous, at any alignment), so the route is a choice of
    speed only. It reads shapes only, on any device, before any build."""
    return "dense" if idx.shape[1] * DENSE_NODES_PER_SLOT >= x.shape[0] else "gather"


def gossip_mix(x: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor, *,
               accum_dtype=torch.float32) -> torch.Tensor:
    """One neighbour-mixing step: (n, N), (n, D), (n, D) -> (n, N) in the
    storage dtype, accumulated in fp32.

    ``gossip_mix.launches`` counts kernel launches, of either route;
    ``gossip_mix.dense_launches`` those of the dense route (CPU calls and
    empty outputs launch nothing and count nothing, and neither does a
    call under a CUDA stream capture, which only records the launch)."""
    _check(x, idx, weight)
    if x.device.type == "cpu":
        err = float((weight.sum(dim=1) - 1.0).abs().max())
        if err > 1e-3:
            raise ValueError(
                "gossip_mix requires row-stochastic weights (each row sums to 1); "
                f"worst row off by {err:.6f}. Build them with Topology.build(): "
                "the Metropolis-Hastings construction lives there."
            )
        return gossip_mix_ref(x, idx, weight, accum_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"gossip_mix runs on cpu or cuda, not {x.device}")
    refuse_grad("gossip_mix", (x, weight), NOT_DIFFERENTIATED)
    if accum_dtype != torch.float32:
        raise ValueError(
            "the CUDA gossip_mix accumulates in float32 only; "
            f"accum_dtype={accum_dtype} runs on the CPU plain version"
        )
    if not (x.is_contiguous() and idx.is_contiguous() and weight.is_contiguous()):
        raise ValueError("gossip_mix needs contiguous x, idx and weight")
    if x.shape[0] > MAX_NODES:
        raise ValueError(f"gossip_mix takes at most {MAX_NODES} nodes, got {x.shape[0]}")
    return _launch(x, idx, weight, _route(x, idx, weight))


def _launch(x, idx, weight, route):
    """One launch of ``route``'s kernel on CUDA tensors that
    :func:`gossip_mix` has checked. Module-private: ``chip_smoke.py`` forces
    each route through it to hold and time both on the same plans."""
    if route not in ("gather", "dense"):
        raise ValueError(f"gossip_mix has no route {route!r}")
    n, N = x.shape
    out = torch.empty_like(x)
    if N == 0:
        return out
    lib = _lib()
    f32 = x.dtype == torch.float32
    if route == "dense":
        fn = lib.gossip_mix_dense_f32 if f32 else lib.gossip_mix_dense_bf16
    else:
        fn = lib.gossip_mix_f32 if f32 else lib.gossip_mix_bf16
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), idx.data_ptr(), weight.data_ptr(), out.data_ptr(),
            n, N, idx.shape[1], stream)
    if rc != 0:
        msg = lib.gossip_mix_error_string(rc).decode()
        raise RuntimeError(f"gossip_mix {route} kernel launch failed: {msg} ({rc})")
    if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
        gossip_mix.launches += 1
        if route == "dense":
            gossip_mix.dense_launches += 1
    return out


gossip_mix.launches = 0
gossip_mix.dense_launches = 0


def launch_config(x: torch.Tensor, idx: torch.Tensor, out: torch.Tensor, route=None) -> dict:
    """The launch of ``route`` (default: :func:`_route`'s) for this (n, N)
    matrix and its output: the route, the elements per global access, and
    the gather kernel's columns per block or the dense kernel's block
    (threads, rows of an M chunk with padding, columns of a tile, rows of a
    K panel, dynamic shared memory, blocks an SM)."""
    lib = _lib()
    route = route or _route(x, idx, None)
    n, elem = x.shape[0], x.element_size()
    vec = lib.gossip_mix_vec(x.data_ptr(), out.data_ptr(), x.shape[1], elem)
    if route == "gather":
        return {"route": route, "vec": vec, "tile": lib.gossip_mix_tile(n, elem)}
    geom = (ctypes.c_int * 6)()
    rc = lib.gossip_mix_dense_plan(n, elem, vec, geom)
    if rc != 0:
        raise RuntimeError(f"gossip_mix dense plan failed: "
                           f"{lib.gossip_mix_error_string(rc).decode()} ({rc})")
    keys = ("threads", "rows", "cols", "k_panel", "smem_bytes", "blocks_per_sm")
    return {"route": route, "vec": vec, **dict(zip(keys, geom))}
