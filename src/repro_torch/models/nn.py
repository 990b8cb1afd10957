"""Initializers and dense, conv and max-pool primitives over dict
parameters (counterpart of ``repro/models/nn.py``).

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


def _draw_device(gen, device):
    """Where to draw: on the generator's device, or on ``device`` when
    there is no generator (the ``meta`` device, which only states shapes)."""
    return torch.device(device) if gen is None else gen.device


def glorot(gen, shape, device, dtype=torch.float32, lead=()):
    """Uniform(-l, l), l = sqrt(6 / (fan_in + fan_out)) from ``shape``,
    drawn from ``gen`` in ``dtype`` on the generator's device and put on
    ``device``. The paper's models pass a CPU generator, so one seed gives
    the same weights on every device; the LM passes one on its own device,
    so its billions of weights never pass through the host. ``lead`` axes
    (a segment's stacked repeats) come first and leave the fans alone."""
    fan_in = int(np.prod(shape[:-1]))
    fan_out = int(shape[-1])
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    u = torch.rand(tuple(lead) + tuple(shape), generator=gen, dtype=dtype,
                   device=_draw_device(gen, device))
    return u.mul_(2.0).sub_(1.0).mul_(limit).to(device)


def normal_init(gen, shape, stddev, device, dtype=torch.float32, lead=()):
    """``stddev`` times a standard normal draw in ``dtype`` (the reference's
    ``nn.normal_init``), drawn as :func:`glorot` draws."""
    z = torch.randn(tuple(lead) + tuple(shape), generator=gen, dtype=dtype,
                    device=_draw_device(gen, device))
    return z.mul_(stddev).to(device)


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
