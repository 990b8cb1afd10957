"""Tree-, codec- and model-facing wrappers around the kernels (counterpart
of ``repro/kernels/ops.py``).

Each aggregate adapter takes RAW example counts n_k and is the one place
that normalizes them for its kernel. Host counts are normalized on the host
and then copied to the payload's device, so a round adds no device sync.
``tree_gossip_mix`` takes a mixing plan, whose rows are stochastic already.
``mha_flash`` and ``mamba_ssm_scan`` adapt the LM's layouts to the
attention and scan kernels."""
from __future__ import annotations

import torch

from repro_torch.kernels.fedavg_agg import fedavg_aggregate
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gossip_mix import gossip_mix
from repro_torch.kernels.quantized_agg import (
    packed_quantized_aggregate,
    quantized_aggregate,
)
from repro_torch.kernels.sparse_agg import sparse_aggregate
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.utils.tree import tree_ravel_stacked, tree_unravel, tree_unravel_stacked


def normalized_weights(weights, device) -> torch.Tensor:
    """(K,) fp32 weights summing to 1 on ``device``, from raw counts on any
    device; host counts are divided on the host."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    return (w / w.sum()).to(device)


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
