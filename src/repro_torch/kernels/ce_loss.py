"""Fused cross-entropy over a large vocabulary: per-token ``lse - gold`` of
``hidden @ head`` without materializing the (T, V) logits, and the
probabilities its gradient needs.

Replaces ``repro/kernels/ce_loss.py::fused_cross_entropy`` (the Pallas
``_ce_kernel``). On a CUDA tensor the work goes to the hand-written kernels
in ``csrc/ce_loss.cu`` (see its note for the design and the bound). On a
CPU tensor it goes to :func:`fused_cross_entropy_ref`, the plain version
beside it: fp32 logits tile by tile over the vocab with an online max and
sum-exp and the gold pick, as ``_ce_kernel`` does. The tensor's device
decides; a CUDA tensor launches a kernel or raises, with no fallback.

Both return the per-token fp32 ``loss`` and, besides the Pallas kernel's
output, the per-token ``lse``, which the backward of
``ops.FusedCrossEntropy`` reuses. Both read ``head`` through its strides:
under tied embeddings the head is the (V, d) embedding table viewed as
(d, V), and a ``.contiguous()`` copy of it would cost 1.05 GB at Gemma-2B's
size on every step.

Two kernels for the forward, chosen by :func:`_route` from the dtype, d,
the strides and the pointers:

- ``"mma"``, ``ce_fwd_mma_kernel``: bf16 hidden and head, d a multiple of
  8, hidden's row stride a multiple of 8, the head's non-unit stride a
  multiple of 8 (its other stride 1: the tied view or a (d, V) head with
  contiguous rows) and both ``data_ptr`` multiples of 16 bytes. The logits
  on the tensor cores (bf16 products, fp32 sums). Every training step of
  the archs the port trains takes it.
- ``"scalar"``, ``ce_partial_kernel``: everything else, fp32 included (the
  fp32 card-vs-CPU checks need it: no bf16 or TF32 tensor-core path meets
  their 1e-5).

A route that fails to build or launch raises; neither falls back to the
other. ``fused_cross_entropy.launches`` counts the launches of both,
``fused_cross_entropy.tc_launches`` those of the tensor-core one.

:func:`ce_probs` is the gradient's half: ``g (softmax - onehot)`` of a
chunk of tokens, rounded to the head's dtype, from the forward's ``lse``.
On a CUDA tensor it takes the route :func:`_route` picks, each the main
loop of that route's forward kernel with a second epilogue:
``ce_probs_mma_kernel`` or ``ce_probs_kernel``; on a CPU tensor
:func:`ce_probs_ref`. ``ce_probs.launches`` and ``ce_probs.tc_launches``
count as the forward's counters do. It is not the port of a Pallas kernel:
the reference's gradient is XLA's autodiff.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.grad_guard import refuse_grad

NEG_INF = -1e30
BLOCK_V = 2048          # the reference kernel's default block_v (plain version's tile)
TILE = 128              # csrc/ce_loss.cu's kBT and kBV (the scalar kernel's tile)
MMA_TILE_V = 256        # csrc/ce_loss.cu's tc::kBV (the tensor-core kernels' vocab tile)
MAX_SPLITS = 65535      # the grid's y extent
MAX_TOKENS = 2**31 - 1   # the kernel indexes tokens with int
_NO_GRAD = ("Its differentiable entry point is ops.ce_loss_mean (the autograd.Function "
            "ops.FusedCrossEntropy).")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("ce_loss")
    args = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3 + [
        ctypes.c_void_p]
    for fn in (lib.fused_cross_entropy_f32, lib.fused_cross_entropy_bf16,
               lib.fused_cross_entropy_bf16_mma):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    for fn in (lib.ce_probs_f32, lib.ce_probs_bf16, lib.ce_probs_bf16_mma):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
            ctypes.c_longlong] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.fused_cross_entropy_blocks_per_sm.argtypes = [ctypes.c_int]
    lib.fused_cross_entropy_blocks_per_sm.restype = ctypes.c_int
    for fn in (lib.fused_cross_entropy_mma_blocks_per_sm, lib.fused_cross_entropy_mma_threads):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    lib.fused_cross_entropy_mma_smem_bytes.argtypes = []
    lib.fused_cross_entropy_mma_smem_bytes.restype = ctypes.c_longlong
    lib.fused_cross_entropy_error_string.argtypes = [ctypes.c_int]
    lib.fused_cross_entropy_error_string.restype = ctypes.c_char_p
    return lib


def fused_cross_entropy_ref(hidden, head, labels):
    """Plain version: (loss, lse), each (T,) fp32. fp32 logits of one
    ``BLOCK_V``-column tile of ``head`` at a time (a column slice of a
    strided view: only the tile is widened), the online max and sum-exp
    carried across tiles, the gold logit picked where the label lands."""
    T = hidden.shape[0]
    V = head.shape[1]
    h = hidden.float()
    m = torch.full((T,), NEG_INF, device=hidden.device)
    l = torch.zeros((T,), device=hidden.device)
    gold = torch.full((T,), NEG_INF, device=hidden.device)
    lbl = labels.long()
    for v0 in range(0, V, BLOCK_V):
        logits = h @ head[:, v0:v0 + BLOCK_V].float()
        m_new = torch.maximum(m, logits.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
        m = m_new
        hit = (lbl >= v0) & (lbl < v0 + logits.shape[1])
        col = (lbl - v0).clamp(0, logits.shape[1] - 1)
        here = torch.gather(logits, 1, col[:, None])[:, 0]
        gold = torch.where(hit, torch.maximum(gold, here), gold)
    lse = m + torch.log(l.clamp_min(1e-30))
    return lse - gold, lse


def ce_probs_ref(hidden, head, labels, lse, g):
    """Plain version of :func:`ce_probs`: (T, V) in head's dtype,
    ``g[t] * (exp(logits[t, v] - lse[t]) - [v == labels[t]])`` from fp32
    logits of one ``BLOCK_V``-column tile of ``head`` at a time, rounded to
    head's dtype once (not at all for fp32). A label outside [0, V) picks
    no column."""
    T = hidden.shape[0]
    V = head.shape[1]
    h = hidden.float()
    lbl = labels.long()
    rows = torch.arange(T, device=hidden.device)
    out = torch.empty((T, V), dtype=head.dtype, device=hidden.device)
    for v0 in range(0, V, BLOCK_V):
        p = torch.matmul(h, head[:, v0:v0 + BLOCK_V].float()).sub_(lse[:, None]).exp_()
        hit = (lbl >= v0) & (lbl < v0 + p.shape[1])
        p[rows[hit], lbl[hit] - v0] -= 1.0
        p *= g[:, None]
        out[:, v0:v0 + p.shape[1]] = p
    return out


def _check(hidden, head, labels):
    if hidden.ndim != 2 or head.ndim != 2 or labels.ndim != 1:
        raise ValueError(
            "fused_cross_entropy takes hidden (T, d), head (d, V) and labels (T,); got "
            f"{tuple(hidden.shape)}, {tuple(head.shape)}, {tuple(labels.shape)}"
        )
    if head.shape[0] != hidden.shape[1] or labels.shape[0] != hidden.shape[0]:
        raise ValueError(
            f"shapes do not chain: hidden {tuple(hidden.shape)}, head {tuple(head.shape)}, "
            f"labels {tuple(labels.shape)}"
        )
    if head.shape[1] < 1 or hidden.shape[1] < 1:
        raise ValueError("fused_cross_entropy needs d >= 1 and V >= 1")
    if hidden.dtype not in (torch.float32, torch.bfloat16) or head.dtype != hidden.dtype:
        raise TypeError(
            "hidden and head must share one dtype, float32 or bfloat16; got "
            f"{hidden.dtype}, {head.dtype}"
        )
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32, got {labels.dtype}")
    if not (hidden.device == head.device == labels.device):
        raise ValueError(
            f"hidden on {hidden.device}, head on {head.device}, labels on {labels.device}"
        )


def _route(hidden, head) -> str:
    """``"mma"`` when the tensor-core kernels take (hidden, head): bf16, d a
    multiple of 8, and every staged row on a 16-byte boundary, so that each
    thread's 16-byte ``cp.async`` copies whole aligned chunks: both
    ``data_ptr`` multiples of 16 bytes, hidden's row stride a multiple of 8
    elements, and head with one unit stride and the other a multiple of 8.
    ``"scalar"`` for everything else. It reads dtypes, shapes, strides and
    pointers only, on any device."""
    if hidden.dtype != torch.bfloat16 or head.dtype != torch.bfloat16 or hidden.shape[1] % 8:
        return "scalar"
    if hidden.stride(1) != 1 or hidden.stride(0) % 8:
        return "scalar"
    if hidden.data_ptr() % 16 or head.data_ptr() % 16:
        return "scalar"
    sd, sv = head.stride()
    if (sd == 1 and sv % 8 == 0) or (sv == 1 and sd % 8 == 0):
        return "mma"
    return "scalar"


@functools.cache
def _slots(device: torch.device, kind: str) -> int:
    """Blocks of ``kind``'s partial kernel ("f32", "bf16" or "mma")
    resident at once on ``device``: blocks an SM holds (the occupancy the
    compiled kernel allows) times the SMs."""
    lib = _lib()
    per_sm = (lib.fused_cross_entropy_mma_blocks_per_sm() if kind == "mma"
              else lib.fused_cross_entropy_blocks_per_sm(int(kind == "bf16")))
    if per_sm < 1:
        raise RuntimeError(f"fused_cross_entropy: the occupancy query failed ({per_sm})")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def mma_occupancy() -> dict:
    """The tensor-core kernels' block: threads and dynamic shared memory,
    and the blocks of ``ce_fwd_mma_kernel`` an SM holds (CUDA's occupancy
    query)."""
    lib = _lib()
    blocks = int(lib.fused_cross_entropy_mma_blocks_per_sm())
    if blocks < 0:
        raise RuntimeError(f"occupancy query failed: "
                           f"{lib.fused_cross_entropy_error_string(-blocks).decode()}")
    return {"threads": int(lib.fused_cross_entropy_mma_threads()),
            "smem_bytes": int(lib.fused_cross_entropy_mma_smem_bytes()),
            "blocks_per_sm": blocks}


@functools.cache
def split_plan(T: int, V: int, slots: int, tile_v: int = TILE):
    """(splits, vocab tiles a split) for a grid of token tiles x splits on
    ``slots`` resident blocks, with vocab tiles of ``tile_v`` columns. A
    block's time is about its vocab tiles, so the kernel takes about
    (waves) x (tiles a split) tile-steps. Of the plans within 1% of the
    fewest steps, the one with the fewest splits wins: fewer blocks to start
    and less to merge. No split is left empty."""
    n_tt = -(-T // TILE)
    n_vt = -(-V // tile_v)
    plans = set()
    for want in range(1, min(n_vt, MAX_SPLITS) + 1):
        per = -(-n_vt // want)
        splits = -(-n_vt // per)
        plans.add((-(-(n_tt * splits) // slots) * per, splits, per))
    fewest = min(cost for cost, _, _ in plans)
    return min((splits, per) for cost, splits, per in plans
               if cost <= 1.01 * fewest)


def fused_cross_entropy(hidden, head, labels):
    """Per-token (loss, lse), each (T,) fp32, of ``hidden @ head`` against
    int32 ``labels``.

    ``fused_cross_entropy.launches`` counts kernel launches of either
    route: a route's two passes (partials over vocab splits, then their
    merge) count as one; ``fused_cross_entropy.tc_launches`` counts those of
    the tensor-core route. CPU calls and T = 0 launch nothing and count
    nothing."""
    _check(hidden, head, labels)
    if hidden.device.type == "cpu":
        return fused_cross_entropy_ref(hidden, head, labels)
    if hidden.device.type != "cuda":
        raise ValueError(f"fused_cross_entropy runs on cpu or cuda, not {hidden.device}")
    refuse_grad("fused_cross_entropy", (hidden, head), _NO_GRAD)
    if hidden.shape[0] > MAX_TOKENS:
        raise ValueError(f"the CUDA fused_cross_entropy takes up to {MAX_TOKENS} tokens, "
                         f"got {hidden.shape[0]}")
    if hidden.stride(1) != 1 or not labels.is_contiguous():
        raise ValueError("fused_cross_entropy needs hidden with a contiguous last axis and "
                         "contiguous labels")
    return _launch(hidden, head, labels, _route(hidden, head))


def _launch(hidden, head, labels, route):
    """One launch of ``route``'s kernels on CUDA tensors that
    :func:`fused_cross_entropy` has checked; (loss, lse). Module-private:
    ``chip_smoke.py`` times and checks the scalar route through it on
    inputs the tensor-core route takes."""
    if route not in ("mma", "scalar") or (route == "mma" and _route(hidden, head) != "mma"):
        raise ValueError(f"route {route!r} does not take these inputs")
    T, d = hidden.shape
    V = head.shape[1]
    loss = torch.empty(T, dtype=torch.float32, device=hidden.device)
    lse = torch.empty(T, dtype=torch.float32, device=hidden.device)
    if T == 0:
        return loss, lse
    lib = _lib()
    if route == "mma":
        fn, kind, tile_v = lib.fused_cross_entropy_bf16_mma, "mma", MMA_TILE_V
    elif hidden.dtype == torch.float32:
        fn, kind, tile_v = lib.fused_cross_entropy_f32, "f32", TILE
    else:
        fn, kind, tile_v = lib.fused_cross_entropy_bf16, "bf16", TILE
    n_split, per = split_plan(T, V, _slots(hidden.device, kind), tile_v)
    scratch = torch.empty((3, n_split, T), dtype=torch.float32, device=hidden.device)
    stream = torch.cuda.current_stream(hidden.device).cuda_stream
    rc = fn(hidden.data_ptr(), head.data_ptr(), labels.data_ptr(), scratch.data_ptr(),
            loss.data_ptr(), lse.data_ptr(), T, d, V, n_split, per, hidden.stride(0),
            head.stride(0), head.stride(1), stream)
    if rc != 0:
        msg = lib.fused_cross_entropy_error_string(rc).decode()
        raise RuntimeError(f"fused_cross_entropy {route} kernel launch failed: {msg} ({rc})")
    if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
        fused_cross_entropy.launches += 1
        if route == "mma":
            fused_cross_entropy.tc_launches += 1
    return loss, lse


fused_cross_entropy.launches = 0
fused_cross_entropy.tc_launches = 0


def ce_probs(hidden, head, labels, lse, g):
    """(T, V) in head's dtype: ``g[t] * (softmax(hidden @ head)[t, v] -
    [v == labels[t]])``, the softmax rebuilt from the forward's fp32 ``lse``
    (T,) and scaled by the upstream gradient ``g`` (T,); a label outside
    [0, V) picks no column. The cotangent of the logits in the gradient of
    :func:`fused_cross_entropy`'s loss.

    On a CUDA tensor a kernel of the route :func:`_route` picks, as the
    forward does: ``ce_probs_mma_kernel`` for ``"mma"``, ``ce_probs_kernel``
    (in the inputs' dtype) for ``"scalar"``. The result is a view of a
    buffer whose rows are padded to a multiple of 8 columns.
    ``ce_probs.launches`` counts the launches of both routes,
    ``ce_probs.tc_launches`` those of the tensor-core one (CPU calls and
    T = 0 launch nothing and count nothing, and neither does a
    call under a CUDA stream capture, which only records the launch)."""
    _check(hidden, head, labels)
    T = hidden.shape[0]
    for name, t in (("lse", lse), ("g", g)):
        if t.shape != (T,) or t.dtype != torch.float32 or t.device != hidden.device:
            raise ValueError(f"ce_probs takes {name} as a ({T},) float32 tensor on "
                             f"{hidden.device}; got {tuple(t.shape)} {t.dtype} on {t.device}")
    if hidden.device.type == "cpu":
        return ce_probs_ref(hidden, head, labels, lse, g)
    if hidden.device.type != "cuda":
        raise ValueError(f"ce_probs runs on cpu or cuda, not {hidden.device}")
    refuse_grad("ce_probs", (hidden, head), _NO_GRAD)
    if T > MAX_TOKENS:
        raise ValueError(f"the CUDA ce_probs takes up to {MAX_TOKENS} tokens, got {T}")
    if hidden.stride(1) != 1 or not labels.is_contiguous():
        raise ValueError("ce_probs needs hidden with a contiguous last axis and contiguous "
                         "labels")
    return _launch_probs(hidden, head, labels, lse, g, _route(hidden, head))


def _launch_probs(hidden, head, labels, lse, g, route):
    """One launch of ``route``'s probabilities kernel on CUDA tensors that
    :func:`ce_probs` has checked. Module-private: ``chip_smoke.py`` checks
    the scalar route through it on inputs the tensor-core route takes."""
    if route not in ("mma", "scalar") or (route == "mma" and _route(hidden, head) != "mma"):
        raise ValueError(f"route {route!r} does not take these inputs")
    T, V = hidden.shape[0], head.shape[1]
    tile_v = MMA_TILE_V if route == "mma" else TILE
    if -(-V // tile_v) > MAX_SPLITS:
        raise ValueError(f"the CUDA ce_probs {route} route takes up to {MAX_SPLITS * tile_v} "
                         f"vocab columns, got {V}")
    ldp = -(-V // 8) * 8
    out = torch.empty((T, ldp), dtype=head.dtype, device=hidden.device)
    if T == 0:
        return out[:, :V]
    lse, g = lse.contiguous(), g.contiguous()
    lib = _lib()
    if route == "mma":
        fn = lib.ce_probs_bf16_mma
    else:
        fn = lib.ce_probs_f32 if hidden.dtype == torch.float32 else lib.ce_probs_bf16
    stream = torch.cuda.current_stream(hidden.device).cuda_stream
    rc = fn(hidden.data_ptr(), head.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            g.data_ptr(), out.data_ptr(), ldp, T, hidden.shape[1], V, hidden.stride(0),
            head.stride(0), head.stride(1), stream)
    if rc != 0:
        msg = lib.fused_cross_entropy_error_string(rc).decode()
        raise RuntimeError(f"ce_probs {route} kernel launch failed: {msg} ({rc})")
    if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
        ce_probs.launches += 1
        if route == "mma":
            ce_probs.tc_launches += 1
    return out[:, :V]


ce_probs.launches = 0
ce_probs.tc_launches = 0
