"""Tree-, codec- and model-facing wrappers around the kernels (counterpart
of ``repro/kernels/ops.py``).

Each aggregate adapter takes RAW example counts n_k and is the one place
that normalizes them for its kernel. Host counts are normalized on the host
and then copied to the payload's device from page-locked memory
(``host_to_device``), so a round adds no device sync.
``tree_gossip_mix`` takes a mixing plan, whose rows are stochastic already.

The ``sharded_*`` adapters are the cohort-sharded server line (the
reference's partial-sum adapters, ``repro/kernels/ops.py:89-238``): each
rank of a ``torch.distributed`` client group runs its aggregation kernel on
its slice of the cohort in the kernels' partial-sum mode (weights that do
not sum to 1), then :func:`finish_partial_sum` makes one
``all_reduce(SUM)``. Without ``total`` the weights are RAW and the
all-reduce also sums the weight total, divided by once, as the reference
does. With the whole cohort's ``total`` (every rank of a round drew the
whole cohort), each rank's raw weights are divided by it first
(:func:`shard_weights`) and the all-reduced sum is the mean: the same
weights, in the same fp32 bits, as the unsharded adapter's, so a world of
one gives the unsharded round bit for bit. Each takes ``group=`` where the
reference takes ``axis_name=``.
``mha_flash`` and ``mamba_ssm_scan`` adapt the LM's layouts to the
attention and scan kernels (serving).

Training goes through three ``torch.autograd.Function``s, because a kernel
launched through ctypes is invisible to autograd (``grad_guard``):
``FlashAttention`` (``mha_flash_train``), ``FusedCrossEntropy``
(``ce_loss_mean``) and ``SSMScan`` (``mamba_ssm_scan_train``). Each forward
is the kernel on a CUDA tensor and its plain version on a CPU tensor. The
reference's gradients are plain JAX outside its forward-only Pallas
kernels: attention's backward is plain torch here too; the CE backward
(``ce_backward``) builds the logits' cotangent with the ``ce_probs``
kernels and leaves its two large products to cuBLAS; the scan's backward is
the hand-written ``ssm_scan_bwd`` kernel (its plain reverse-time loop on
the CPU). Each backward is a ``torch.profiler`` range of its own
(``flash_attention_bwd``, ``fused_cross_entropy_bwd``, ``ssm_scan_bwd``),
so a trace shows what it costs."""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.kernels.ce_loss import _route as ce_route
from repro_torch.kernels.ce_loss import ce_probs, fused_cross_entropy
from repro_torch.kernels.fedavg_agg import fedavg_aggregate
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gossip_mix import gossip_mix
from repro_torch.kernels.quantized_agg import (
    packed_quantized_aggregate,
    quantized_aggregate,
)
from repro_torch.kernels.sparse_agg import sparse_aggregate
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd
from repro_torch.models.attention_core import flash_attention_bwd
from repro_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_ravel_stacked,
    tree_unravel,
    tree_unravel_stacked,
)


def host_to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device`` without making the host wait: a host tensor bound
    for a card is copied from page-locked memory with ``non_blocking=True``
    (the pinned block is not reused before the copy has run), which a
    pageable copy, a copy and a stream sync, would not be."""
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def normalized_weights(weights, device) -> torch.Tensor:
    """(K,) fp32 weights summing to 1 on ``device``, from raw counts on any
    device; host counts are divided on the host, then copied without a
    host sync (``host_to_device``)."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    return host_to_device(w / w.sum(), device)


def tree_fedavg_aggregate(stacked_params, weights):
    """Weighted-average a tree whose leaves are (K, ...) stacked client
    tensors — Algorithm 1's server line through ``fedavg_aggregate``.

    ``weights`` are RAW example counts n_k, on any device; this adapter is
    the one place that normalizes them to sum to 1. Host weights are
    normalized on the host, so the engine's round needs no device sync for
    it, and then copied to the stack's device."""
    flat, spec = tree_ravel_stacked(stacked_params)
    avg = fedavg_aggregate(flat, normalized_weights(weights, flat.device))
    return tree_unravel(spec, avg)


def tree_weighted_mean(stacked, weights):
    """The same server line leaf by leaf, for a tree too large to ravel:
    each (K, ...) leaf goes through ``fedavg_aggregate`` on its own, viewed
    (K, -1), so a 2.5B-parameter replica stack is never copied whole.
    ``weights`` are raw counts n_k, normalized once as above. The kernel sums
    in fp32 and rounds once to the leaf's dtype, where the reference's
    ``repro/utils/tree.py::tree_weighted_mean`` sums bf16 leaves in bf16; in
    fp32 the two agree to rounding."""
    leaves = tree_leaves(stacked)
    w = normalized_weights(weights, leaves[0].device) if leaves else None

    def avg(leaf):
        return fedavg_aggregate(leaf.reshape(leaf.shape[0], -1), w).reshape(leaf.shape[1:])

    return tree_map(avg, stacked)


def quantized_fedavg_aggregate(codes, lo, scale, weights, *, chunk, levels):
    """Fused dequantize + weighted average of (K, N_pad) uint8/uint16 client
    codes through ``quantized_aggregate``; (N_pad,) fp32, callers slice to
    the real N."""
    return quantized_aggregate(codes, lo, scale, normalized_weights(weights, codes.device),
                               chunk=chunk, levels=levels)


def packed_quantized_fedavg_aggregate(words, lo, scale, weights, *, bits, chunk, levels):
    """The bit-packed twin: (K, C * wpc) int32 wire words through
    ``packed_quantized_aggregate``; (C * chunk,) fp32."""
    return packed_quantized_aggregate(
        words, lo, scale, normalized_weights(weights, words.device),
        bits=bits, chunk=chunk, levels=levels)


def sparse_fedavg_aggregate(idx, values, weights, n):
    """Weighted average of K sparse top-k payloads into a dense (n,) fp32
    delta through ``sparse_aggregate``."""
    return sparse_aggregate(idx, values, normalized_weights(weights, idx.device), n)


def shard_weights(weights, device, total=None) -> torch.Tensor:
    """(K,) fp32 weights on ``device`` for a rank's partial sum: the raw
    weights, or, given the whole cohort's ``total`` (a host float or a 0-d
    tensor on the weights' device), the raw weights divided by it, on the
    host when they live there, as :func:`normalized_weights` divides by the
    local sum. Raw example counts are whole numbers, whose fp32 sums are
    exact in any order, so that total is the local sum of an unsharded
    round and the weights are its bits."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    if total is not None:
        w = w / total_tensor(total, w.device)
    return host_to_device(w, device)


def total_tensor(total, device) -> torch.Tensor:
    """A weight total as a 0-d fp32 tensor on ``device``: a tensor as it is,
    a host float filled in place (no copy, so no sync). Dividing by it is
    the same operation as dividing by a local ``sum()``; a Python float
    divisor would take another kernel path on a card."""
    if isinstance(total, torch.Tensor):
        return total
    return torch.full((), float(total), dtype=torch.float32, device=device)


def finish_partial_sum(partial: torch.Tensor, weights: torch.Tensor, group, *,
                       total=None, carry: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The weighted mean from this rank's (N,) fp32 ``partial`` weighted sum
    over its (K,) ``weights`` (:func:`shard_weights` with the same
    ``total``): one ``all_reduce(SUM)`` over ``group``.

    Without ``total`` the weights are raw: the all-reduce also sums their
    local totals, and the mean is one division, as the reference's ``psum``
    pair. With it (the whole cohort's total, known to every rank because
    every rank drew the whole cohort) they were divided by it already, and
    the all-reduced sum is the mean. ``carry`` (a 1-D fp32 tensor on the
    partial's device, e.g. a round's loss terms) rides in the same
    all-reduce and is overwritten with its sum over the group, so a round
    makes one collective."""
    parts = [partial]
    if total is None:
        parts.append(weights.sum().reshape(1))
    if carry is not None:
        parts.append(carry.reshape(-1))
    buf = torch.cat(parts) if len(parts) > 1 else partial
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    n = partial.shape[0]
    if carry is not None:
        carry.copy_(buf[buf.shape[0] - carry.numel():].reshape(carry.shape))
    return buf[:n] if total is not None else buf[:n] / buf[n]


def sharded_fedavg_aggregate(stacked_params, weights, *, group, total=None, carry=None):
    """Cohort-sharded :func:`tree_fedavg_aggregate`: ``fedavg_aggregate`` in
    partial-sum mode over this rank's (K_local, ...) slice (ghost clients
    carry weight 0 and vanish), then :func:`finish_partial_sum` over
    ``group``. The stack is cast to fp32 first and the partial sum stays
    fp32 until after the all-reduce, as the reference casts to
    ``accum_dtype`` (``ops.py:109-112``); each leaf returns to its storage
    dtype only in the unravel."""
    flat, spec = tree_ravel_stacked(stacked_params)
    w = shard_weights(weights, flat.device, total)
    partial = fedavg_aggregate(flat.float().contiguous(), w, normalized=False)
    return tree_unravel(spec, finish_partial_sum(partial, w, group, total=total, carry=carry))


def sharded_quantized_fedavg_aggregate(codes, lo, scale, weights, *, chunk, levels, group,
                                       total=None, carry=None):
    """Cohort-sharded :func:`quantized_fedavg_aggregate`: the fused decode
    and weighted sum over this rank's codes in partial-sum mode, then
    :func:`finish_partial_sum`; (N_pad,) fp32."""
    w = shard_weights(weights, codes.device, total)
    partial = quantized_aggregate(codes, lo, scale, w, chunk=chunk, levels=levels,
                                  normalized=False)
    return finish_partial_sum(partial, w, group, total=total, carry=carry)


def sharded_packed_quantized_fedavg_aggregate(words, lo, scale, weights, *, bits, chunk,
                                              levels, group, total=None, carry=None):
    """Cohort-sharded :func:`packed_quantized_fedavg_aggregate`, as
    :func:`sharded_quantized_fedavg_aggregate`; (C * chunk,) fp32."""
    w = shard_weights(weights, words.device, total)
    partial = packed_quantized_aggregate(words, lo, scale, w, bits=bits, chunk=chunk,
                                         levels=levels, normalized=False)
    return finish_partial_sum(partial, w, group, total=total, carry=carry)


def sharded_sparse_fedavg_aggregate(idx, values, weights, n, *, group, total=None,
                                    carry=None):
    """Cohort-sharded :func:`sparse_fedavg_aggregate`: this rank's (K_local,
    k) pairs scattered in partial-sum mode, then :func:`finish_partial_sum`;
    (n,) fp32."""
    w = shard_weights(weights, idx.device, total)
    partial = sparse_aggregate(idx, values, w, n, normalized=False)
    return finish_partial_sum(partial, w, group, total=total, carry=carry)


def tree_gossip_mix(stacked_params, idx, weight):
    """Gossip-mix a tree whose leaves are (n_nodes, ...) stacked per-node
    replicas: the (n_nodes, N) raveled rows through ``gossip_mix``, then
    unraveled per node, each leaf back in its storage dtype. ``idx`` and
    ``weight`` are a ``MixingPlan``'s padded arrays on the stack's device."""
    flat, spec = tree_ravel_stacked(stacked_params)
    return tree_unravel_stacked(spec, gossip_mix(flat, idx, weight))


def mha_flash(q, k, v, *, causal=True, window=0):
    """(B, S, H, D) x (B, S, K, D) GQA attention through ``flash_attention``.
    The reference folds batch and heads and repeats each KV head H // K
    times; here the kernel reads KV head h // (H // K) in place, so nothing
    is folded or repeated."""
    return flash_attention(q, k, v, causal=causal, window=window)


def mamba_ssm_scan(dt, Bm, Cm, x, A, h0, *, chunk=0):
    """Selective scan through ``ssm_scan``, over T at once (``chunk`` 0 or
    at least T) or in chunks of ``chunk`` steps, the state threading from
    one chunk into the next; the chunks are views, not copies."""
    T = dt.shape[1]
    if not chunk or T <= chunk:
        return ssm_scan(dt, Bm, Cm, x, A, h0)
    ys, h = [], h0
    for t0 in range(0, T, chunk):
        sl = slice(t0, t0 + chunk)
        y, h = ssm_scan(dt[:, sl], Bm[:, sl], Cm[:, sl], x[:, sl], A, h)
        ys.append(y)
    return torch.cat(ys, dim=1), h


class SSMScan(torch.autograd.Function):
    """The selective scan with a gradient: (y, h_T) of ``ssm_scan``.

    Forward: ``ssm_scan(..., checkpoints=True)``, the kernel on a CUDA
    tensor (one launch, which also writes the state entering every run of
    16 steps) and ``ssm_scan_ref`` on a CPU tensor, keeping the inputs and
    the checkpoints. Backward: ``ssm_scan_bwd``, the kernel on a CUDA
    tensor and ``ssm_scan_bwd_ref`` on a CPU tensor, inside the profiler
    range ``ssm_scan_bwd``. A cotangent that is None (h_T, which training
    drops) counts as zeros, and an input gradient that autograd does not
    ask for is not computed."""

    @staticmethod
    def forward(ctx, dt, Bm, Cm, x, A, h0):
        y, h_T, ck = ssm_scan(dt, Bm, Cm, x, A, h0, checkpoints=True)
        ctx.save_for_backward(dt, Bm, Cm, x, A, h0, ck)
        ctx.set_materialize_grads(False)
        return y, h_T

    @staticmethod
    def backward(ctx, gy, g_hT):
        dt, Bm, Cm, x, A, h0, ck = ctx.saved_tensors
        gy = (torch.zeros(x.shape, dtype=torch.float32, device=x.device) if gy is None
              else gy.contiguous())
        with torch.profiler.record_function("ssm_scan_bwd"):
            return ssm_scan_bwd(dt, Bm, Cm, x, A, h0, gy,
                                None if g_hT is None else g_hT.contiguous(),
                                checkpoints=ck, needs=tuple(ctx.needs_input_grad))


def mamba_ssm_scan_train(dt, Bm, Cm, x, A, h0):
    """The selective scan of the training forward over T at once,
    differentiable through ``SSMScan``: (y, h_T)."""
    return SSMScan.apply(dt, Bm, Cm, x, A, h0)


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the forward is ``flash_attention`` with its
    ``lse`` (the kernel on the card, ``blocked_attention`` on the CPU); the
    backward is the reference's ``_flash_bwd`` (``flash_attention_bwd``)
    over ``q_chunk`` x ``k_chunk`` tiles, from (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, k_chunk):
        out, lse = flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, q_chunk=q_chunk, k_chunk=k_chunk)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        with torch.profiler.record_function("flash_attention_bwd"):
            dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def mha_flash_train(q, k, v, *, causal=True, window=0, q_chunk=1024, k_chunk=1024):
    """(B, S, H, D) x (B, S, K, D) GQA attention of the training forward,
    differentiable through ``FlashAttention``; ``q_chunk`` and ``k_chunk``
    tile the backward, as the reference's ``blocked_attention`` takes them."""
    return FlashAttention.apply(q, k, v, causal, window, q_chunk, k_chunk)


def _mm_f32(a, b):
    """``a @ b`` with fp32 sums, as fp32: cuBLAS's bf16 product with an fp32
    output on the card (no reduced-precision split-K reduction, whatever
    ``allow_bf16_reduced_precision_reduction`` says), the fp32-widened
    product elsewhere (bf16 products are exact in fp32)."""
    if a.dtype == torch.bfloat16 and a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _addmm_f32_(acc, a, b):
    """``acc += a @ b`` into the fp32 ``acc``, with fp32 sums, as
    :func:`_mm_f32`."""
    if a.dtype == torch.bfloat16 and a.is_cuda:
        torch.addmm(acc, a, b, out_dtype=torch.float32, out=acc)
    else:
        acc.addmm_(a.float(), b.float())


def ce_backward(hidden, head, labels, lse, g, chunk):
    """(dhidden, dhead) of the per-token CE ``lse - gold`` of ``hidden @
    head`` under the upstream gradient ``g`` (T,), over token chunks of
    ``chunk`` (all at once for 0).

    For each chunk, ``p = g (softmax - onehot)`` in head's dtype from
    ``ce_probs`` (on the card the kernel of the forward's route, the
    tensor-core one or the scalar one; its plain version on the CPU). Then
    ``dhidden = p @ head^T`` and ``dhead += hidden^T p``, both with fp32
    sums: in bf16, cuBLAS's bf16 products with an fp32 output
    (``out_dtype``); ``dhead`` is summed across chunks in fp32 and rounded
    to head's dtype once. In fp32 the products are fp32, as they were before
    the kernel. The reference's gradient (XLA's autodiff of
    ``chunked_cross_entropy``) rounds the same cotangent to bf16 before its
    two products."""
    T = hidden.shape[0]
    chunk = chunk or T
    dhidden = torch.empty_like(hidden)
    dhead = torch.zeros(head.shape, dtype=torch.float32, device=head.device)
    for t0 in range(0, T, chunk):
        sl = slice(t0, t0 + chunk)
        p = ce_probs(hidden[sl], head, labels[sl], lse[sl], g[sl])
        dhidden[sl] = _mm_f32(p, head.T)
        _addmm_f32_(dhead, hidden[sl].T, p)
    return dhidden, dhead.to(head.dtype)


def tensor_core_head(hidden, head):
    """``head``, or a copy of it that the CE's tensor-core route takes: a
    (d, V) head whose row pitch is no multiple of 8 (SeamlessM4T's untied
    (1024, 256,206)) is staged into a (d, V') buffer, V' = V rounded up to 8,
    and its (d, V) view returned: rows on the 16-byte grid, as ``_route``
    requires. The copy is made only where ``_route`` (strides, dtypes and
    pointers alone) sends the view to the tensor cores and ``head`` not."""
    if head.dtype != torch.bfloat16 or ce_route(hidden, head) == "mma":
        return head
    d, V = head.shape
    buf = torch.empty((d, -(-V // 8) * 8), dtype=head.dtype, device=head.device)
    staged = buf[:, :V]
    if ce_route(hidden, staged) != "mma":
        return head
    return staged.copy_(head)


class FusedCrossEntropy(torch.autograd.Function):
    """Per-token CE ``lse - gold`` of ``hidden @ head`` with a gradient.

    Forward: ``fused_cross_entropy`` (the kernel on the card, the plain
    version on the CPU) on :func:`tensor_core_head`'s head, keeping (hidden,
    that head, labels, lse); the backward's ``ce_probs`` chunks read the
    same staged head, and the gradient lands on the (d, V) parameter.
    Backward: :func:`ce_backward` over token chunks of ``chunk``. The
    reference's gradient here is XLA's autodiff of
    ``chunked_cross_entropy``; its Pallas kernel is forward only."""

    @staticmethod
    def forward(ctx, hidden, head, labels, chunk):
        head = tensor_core_head(hidden, head)
        loss, lse = fused_cross_entropy(hidden, head, labels)
        ctx.save_for_backward(hidden, head, labels, lse)
        ctx.chunk = chunk
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, head, labels, lse = ctx.saved_tensors
        with torch.profiler.record_function("fused_cross_entropy_bwd"):
            dhidden, dhead = ce_backward(hidden, head, labels, lse, g, ctx.chunk)
        return dhidden, dhead, None, None


def ce_loss_mean(hidden, head, labels, *, chunk=0):
    """(B, S, d) hidden, (d, V) head, (B, S) labels -> the scalar mean CE,
    through ``FusedCrossEntropy`` (counterpart of the reference's
    ``ops.ce_loss_mean``). ``chunk`` is the config's ``ce_chunk``: the
    backward takes B * chunk tokens at a time (all at once for 0)."""
    B, S, d = hidden.shape
    losses = FusedCrossEntropy.apply(hidden.reshape(B * S, d), head,
                                     labels.reshape(B * S).to(torch.int32), B * chunk)
    return losses.mean()
