"""Initializers and dense, conv, max-pool and LSTM primitives over dict
parameters (counterpart of ``repro/models/nn.py``).

The public layouts are the reference's: dense ``w`` is (d_in, d_out), conv
``w`` is HWIO and activations are NHWC. ``conv2d`` and ``max_pool`` permute
to PyTorch's NCHW/OIHW inside and back out; the permuted views of a
contiguous NHWC tensor are exactly PyTorch's channels-last layout, so the
permutes cost no copy. The ops themselves are PyTorch's (cuBLAS/cuDNN on
the card), as the reference leaves them to XLA.

The LSTM keeps the reference's layout and arithmetic: ``wx`` (d_in, 4H),
``wh`` (H, 4H), ``b`` (4H,), gates in the order i, f, g, o, the forget gate's
``+1.0`` inside its sigmoid, the carry starting at zero. It is plain
functions on tensors, so ``torch.func.vmap(grad_and_value(...))`` over a
cohort of clients goes through it as it goes through a dense layer
(``torch.nn.LSTM`` would not: cuDNN's RNN has its own bias layout and no
forget bias, and does not batch under ``vmap``).
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


# ---------------------------------------------------------------------------
# LSTM (standard, no peepholes): the paper's char and word models.
# ---------------------------------------------------------------------------


def lstm_init(gen, d_in, d_hidden, device):
    return {
        "wx": glorot(gen, (d_in, 4 * d_hidden), device),
        "wh": glorot(gen, (d_hidden, 4 * d_hidden), device),
        "b": torch.zeros((4 * d_hidden,), device=device),
    }


def _cell(p, carry, xw_t):
    """One step from the input's share of the gates, ``xw_t = x_t @ wx + b``."""
    h, c = carry
    gates = xw_t + h @ p["wh"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def lstm_cell(p, carry, x_t):
    """``((h, c), h)`` after one step on ``x_t`` (B, d_in), as the
    reference's ``lstm_cell``."""
    h, c = _cell(p, carry, x_t @ p["wx"] + p["b"])
    return (h, c), h


def lstm_apply(p, x):
    """x: (B, T, d_in) -> (B, T, d_hidden). The input projection of all T
    steps is one product before the recurrence (the reference adds it step
    by step inside its scan: the same sums, within 1e-5 in fp32); the
    recurrence is a loop over T, the reference's ``lax.scan``. The steps'
    inputs are taken by one ``unbind``, whose backward is one ``stack``: an
    index ``xw[:, t]`` a step would cost its backward a zero-filled copy of
    all of ``xw`` a step."""
    d_hidden = p["wh"].shape[0]
    xw = x @ p["wx"] + p["b"]                            # (B, T, 4H)
    h = torch.zeros((x.shape[0], d_hidden), dtype=x.dtype, device=x.device)
    c = torch.zeros_like(h)
    hs = []
    for xw_t in xw.unbind(1):
        h, c = _cell(p, (h, c), xw_t)
        hs.append(h)
    return torch.stack(hs, dim=1)
