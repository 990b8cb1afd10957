"""Mamba-1 selective state-space block for Jamba's SSM layers (counterpart
of ``repro/models/ssm.py``).

In-proj to 2 * d_inner (x, z gate), causal depthwise conv (d_conv = 4),
SiLU, input-dependent (dt, B, C) projections, diagonal A, the selective
scan, D skip, gate, RMSNorm on the scan output (as the Jamba reference),
out-proj. The scan goes to ``ops.mamba_ssm_scan`` over the whole prompt in
prefill and to ``ssm_scan`` with T = 1 from the cached state in decode: the
hand-written kernel on the card, the plain loop on the CPU. In training
(``mode="train"`` with grad mode on) it goes to ``ops.mamba_ssm_scan_train``
(``SSMScan``): the same forward kernel, and the ``ssm_scan_bwd`` kernel as
its backward, where the reference differentiates its plain ``lax.scan``
(checkpointed every 128 steps). The conv stays plain.

State for decode: conv tail (B, d_conv - 1, d_inner) + SSM state
(B, d_inner, N) in fp32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import mamba_ssm_scan, mamba_ssm_scan_train
from repro_torch.models import nn
from repro_torch.models.layers import _full, rmsnorm, rmsnorm_init


def mamba_init(gen, cfg: ModelConfig, dtype, device, lead=()):
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    dt_rank = s.resolved_dt_rank(d)
    in_proj = nn.glorot(gen, (d, 2 * di), device, dtype, lead)
    conv_w = nn.normal_init(gen, (s.d_conv, di), 0.1, device, dtype, lead)
    x_proj = nn.glorot(gen, (di, dt_rank + 2 * s.d_state), device, dtype, lead)
    dt_proj = nn.glorot(gen, (dt_rank, di), device, dtype, lead)
    # dt bias so that softplus(dt_bias) ~ U[1e-3, 1e-1] (the mamba reference)
    u = torch.rand(tuple(lead) + (di,), generator=gen, device=nn._draw_device(gen, device))
    dt = torch.exp(u * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
    dt_bias = (dt + torch.log(-torch.expm1(-dt))).to(device)   # inverse softplus
    A = torch.arange(1, s.d_state + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": _full(0.0, (di,), dtype, device, lead),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": dt_bias,
        "A_log": torch.log(A).expand(tuple(lead) + (di, s.d_state)).contiguous(),
        "D": _full(1.0, (di,), torch.float32, device, lead),
        "out_norm": rmsnorm_init(di, dtype, device, lead),
        "out_proj": nn.glorot(gen, (di, d), device, dtype, lead),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device, lead=()):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return {
        "conv": _full(0.0, (batch, s.d_conv - 1, di), dtype, device, lead),
        "ssm": _full(0.0, (batch, di, s.d_state), torch.float32, device, lead),
    }


def mamba_apply(p, cfg: ModelConfig, u, *, cache=None, mode="train"):
    """u: (B, S, d). Returns (y, new_cache)."""
    s = cfg.ssm
    B, S, d = u.shape
    x, z = (u @ p["in_proj"]).chunk(2, dim=-1)            # (B, S, di)
    di = x.shape[-1]

    # causal depthwise conv along S, its tail carried for decode
    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes one token against a cache")
        ctx = torch.cat([cache["conv"], x], dim=1)        # (B, d_conv, di)
        new_conv = ctx[:, 1:]
    else:
        ctx = torch.cat([x.new_zeros((B, s.d_conv - 1, di)), x], dim=1)
        new_conv = ctx[:, -(s.d_conv - 1):] if mode == "prefill" else None
    xc = 0
    for j in range(s.d_conv):   # out[t] = sum_j conv_w[j] * ctx[t + j]
        xc = xc + ctx[:, j:j + S] * p["conv_w"][j]
    xc = F.silu(xc + p["conv_b"])

    dbc = xc @ p["x_proj"]                                 # (B, S, dt_rank + 2N)
    dt_rank = p["dt_proj"].shape[0]
    dt = torch.logaddexp((dbc[..., :dt_rank] @ p["dt_proj"]).float() + p["dt_bias"],
                         torch.zeros((), device=u.device))  # softplus, as jax.nn's
    Bmat = dbc[..., dt_rank:dt_rank + s.d_state].float()   # (B, S, N)
    Cmat = dbc[..., dt_rank + s.d_state:].float()          # (B, S, N)
    A = -torch.exp(p["A_log"])                             # (di, N)
    xf = xc.float()

    if mode == "decode":
        h0 = cache["ssm"]
    else:
        h0 = torch.zeros((B, di, s.d_state), device=u.device)
    scan = (mamba_ssm_scan_train if mode == "train" and torch.is_grad_enabled()
            else mamba_ssm_scan)
    ys, h_last = scan(dt, Bmat, Cmat, xf, A, h0)
    y = ys + xf * p["D"]
    y = y.to(u.dtype) * F.silu(z)
    y = rmsnorm(p["out_norm"], y, cfg.norm_eps)
    out = y @ p["out_proj"]
    new_cache = None if mode == "train" else {"conv": new_conv, "ssm": h_last}
    return out, new_cache
