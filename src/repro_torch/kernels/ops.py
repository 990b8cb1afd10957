"""Tree- and codec-facing wrappers around the kernels (counterpart of
``repro/kernels/ops.py``).

Each adapter takes RAW example counts n_k and is the one place that
normalizes them for its kernel. Host counts are normalized on the host and
then copied to the payload's device, so a round adds no device sync."""
from __future__ import annotations

import torch

from repro_torch.kernels.fedavg_agg import fedavg_aggregate
from repro_torch.kernels.quantized_agg import (
    packed_quantized_aggregate,
    quantized_aggregate,
)
from repro_torch.kernels.sparse_agg import sparse_aggregate
from repro_torch.utils.tree import tree_ravel_stacked, tree_unravel


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
