"""Tree-facing wrappers around the kernels (counterpart of
``repro/kernels/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.fedavg_agg import fedavg_aggregate
from repro_torch.utils.tree import tree_ravel_stacked, tree_unravel


def tree_fedavg_aggregate(stacked_params, weights):
    """Weighted-average a tree whose leaves are (K, ...) stacked client
    tensors — Algorithm 1's server line through ``fedavg_aggregate``.

    ``weights`` are RAW example counts n_k, on any device; this adapter is
    the one place that normalizes them to sum to 1. Host weights are
    normalized on the host, so the engine's round needs no device sync for
    it, and then copied to the stack's device."""
    flat, spec = tree_ravel_stacked(stacked_params)
    w = torch.as_tensor(weights, dtype=torch.float32)
    w = (w / w.sum()).to(flat.device)
    avg = fedavg_aggregate(flat, w)
    return tree_unravel(spec, avg)
