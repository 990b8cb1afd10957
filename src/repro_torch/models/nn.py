"""Dense, conv and max-pool primitives over dict parameters (counterpart of
``repro/models/nn.py``).

The public layouts are the reference's: dense ``w`` is (d_in, d_out), conv
``w`` is HWIO and activations are NHWC. ``conv2d`` and ``max_pool`` permute
to PyTorch's NCHW/OIHW inside and back out; the permuted views of a
contiguous NHWC tensor are exactly PyTorch's channels-last layout, so the
permutes cost no copy. The ops themselves are PyTorch's (cuBLAS/cuDNN on
the card), as the reference leaves them to XLA.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def glorot(gen: torch.Generator, shape, device):
    """fp32 Uniform(-l, l), l = sqrt(6 / (fan_in + fan_out)), drawn from
    ``gen`` (a CPU generator, so one seed gives the same weights on every
    device)."""
    fan_in = int(np.prod(shape[:-1]))
    fan_out = int(shape[-1])
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    u = torch.rand(tuple(shape), generator=gen)
    return ((u * 2.0 - 1.0) * limit).to(device)


def dense_init(gen, d_in, d_out, device):
    return {
        "w": glorot(gen, (d_in, d_out), device),
        "b": torch.zeros((d_out,), device=device),
    }


def dense(p, x):
    return x @ p["w"] + p["b"]


def conv2d_init(gen, kh, kw, c_in, c_out, device):
    return {
        "w": glorot(gen, (kh, kw, c_in, c_out), device),
        "b": torch.zeros((c_out,), device=device),
    }


def conv2d(p, x):
    """x: (B, H, W, C), kernel HWIO, stride 1, SAME padding -> (B, H, W, O)."""
    w = p["w"].permute(3, 2, 0, 1)                      # HWIO -> OIHW
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding="same")
    return y.permute(0, 2, 3, 1) + p["b"]


def max_pool(x):
    """2x2 stride-2 VALID max pool over NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
    return y.permute(0, 2, 3, 1)
