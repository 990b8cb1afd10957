"""Fused cross-entropy over a large vocabulary: per-token ``lse - gold`` of
``hidden @ head`` without materializing the (T, V) logits.

Replaces ``repro/kernels/ce_loss.py::fused_cross_entropy`` (the Pallas
``_ce_kernel``). On a CUDA tensor the work goes to the hand-written kernel
in ``csrc/ce_loss.cu`` (see its note for the design and the bound). On a
CPU tensor it goes to :func:`fused_cross_entropy_ref`, the plain version
beside it: fp32 logits tile by tile over the vocab with an online max and
sum-exp and the gold pick, as ``_ce_kernel`` does. The tensor's device
decides; a CUDA tensor launches the kernel or raises, with no fallback.

Both return the per-token fp32 ``loss`` and, besides the Pallas kernel's
output, the per-token ``lse``, which the backward of
``ops.FusedCrossEntropy`` reuses. Both read ``head`` through its strides:
under tied embeddings the head is the (V, d) embedding table viewed as
(d, V), and a ``.contiguous()`` copy of it would cost 1.05 GB at Gemma-2B's
size on every step.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.grad_guard import refuse_grad

NEG_INF = -1e30
BLOCK_V = 2048          # the reference kernel's default block_v (plain version's tile)
TILE = 128              # csrc/ce_loss.cu's kBT and kBV
MAX_SPLITS = 65535      # the grid's y extent
MAX_TOKENS = 2**31 - 1   # the kernel indexes tokens with int
_NO_GRAD = ("Its differentiable entry point is ops.ce_loss_mean (the autograd.Function "
            "ops.FusedCrossEntropy).")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("ce_loss")
    args = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3 + [
        ctypes.c_void_p]
    for fn in (lib.fused_cross_entropy_f32, lib.fused_cross_entropy_bf16):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.fused_cross_entropy_blocks_per_sm.argtypes = [ctypes.c_int]
    lib.fused_cross_entropy_blocks_per_sm.restype = ctypes.c_int
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


@functools.cache
def _slots(device: torch.device, bf16: bool) -> int:
    """Blocks of the partial kernel resident at once on ``device``: blocks an
    SM holds (the occupancy the compiled kernel allows) times the SMs."""
    per_sm = _lib().fused_cross_entropy_blocks_per_sm(int(bf16))
    if per_sm < 1:
        raise RuntimeError("fused_cross_entropy: the occupancy query failed")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def split_plan(T: int, V: int, slots: int):
    """(splits, vocab tiles a split) for a grid of token tiles x splits on
    ``slots`` resident blocks. A block's time is about its vocab tiles, so
    the kernel takes about (waves) x (tiles a split) tile-steps. Of the plans
    within 1% of the fewest steps, the one with the fewest splits wins: fewer
    blocks to start and less to merge. No split is left empty."""
    n_tt = -(-T // TILE)
    n_vt = -(-V // TILE)
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

    ``fused_cross_entropy.launches`` counts kernel launches: the kernel's two
    passes (partials over vocab splits, then their merge) count as one. CPU
    calls and T = 0 launch nothing and count nothing."""
    _check(hidden, head, labels)
    if hidden.device.type == "cpu":
        return fused_cross_entropy_ref(hidden, head, labels)
    if hidden.device.type != "cuda":
        raise ValueError(f"fused_cross_entropy runs on cpu or cuda, not {hidden.device}")
    refuse_grad("fused_cross_entropy", (hidden, head), _NO_GRAD)
    T, d = hidden.shape
    V = head.shape[1]
    if T > MAX_TOKENS:
        raise ValueError(f"the CUDA fused_cross_entropy takes up to {MAX_TOKENS} tokens, got {T}")
    if hidden.stride(1) != 1 or not labels.is_contiguous():
        raise ValueError("fused_cross_entropy needs hidden with a contiguous last axis and "
                         "contiguous labels")
    loss = torch.empty(T, dtype=torch.float32, device=hidden.device)
    lse = torch.empty(T, dtype=torch.float32, device=hidden.device)
    if T == 0:
        return loss, lse
    n_split, per = split_plan(T, V, _slots(hidden.device, hidden.dtype == torch.bfloat16))
    scratch = torch.empty((3, n_split, T), dtype=torch.float32, device=hidden.device)
    lib = _lib()
    fn = lib.fused_cross_entropy_f32 if hidden.dtype == torch.float32 \
        else lib.fused_cross_entropy_bf16
    stream = torch.cuda.current_stream(hidden.device).cuda_stream
    rc = fn(hidden.data_ptr(), head.data_ptr(), labels.data_ptr(), scratch.data_ptr(),
            loss.data_ptr(), lse.data_ptr(), T, d, V, n_split, per, hidden.stride(0),
            head.stride(0), head.stride(1), stream)
    if rc != 0:
        msg = lib.fused_cross_entropy_error_string(rc).decode()
        raise RuntimeError(f"fused_cross_entropy kernel launch failed: {msg} ({rc})")
    fused_cross_entropy.launches += 1
    return loss, lse


fused_cross_entropy.launches = 0
