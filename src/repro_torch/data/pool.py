"""Device-memory budget for the resident client pool (counterpart of
``repro/data/pool.py::device_pool_budget``)."""
from __future__ import annotations

import os

import torch


def device_pool_budget(device: torch.device) -> int:
    """Bytes the packed ``(K, n_pad, ...)`` pool may take on ``device``.

    ``REPRO_DEVICE_POOL_BUDGET`` (bytes) overrides; otherwise 60% of the
    card's total memory as ``torch.cuda.mem_get_info`` reports it, or
    2 GiB on the CPU, which reports no limit."""
    env = os.environ.get("REPRO_DEVICE_POOL_BUDGET", "")
    if env:
        return int(env)
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
        return int(total * 0.6)
    return 2 * 1024**3
