"""Attention inner loops in plain PyTorch (counterpart of
``repro/models/attention_core.py``).

``blocked_attention`` is the tiled online-softmax forward (flash-style:
the (Sq, Sk) score matrix never exists whole). It is the plain version
behind ``kernels/flash_attention.py``: prefill on a CPU tensor runs it, and
on the card the hand-written kernel computes the same tiles. Its backward
(the reference's custom VJP) comes with the training slice.
``naive_attention`` is the O(Sq*Sk) oracle and ``decode_attention`` the
one-token step against a KV cache; no Pallas kernel computes either.

Layouts are the reference's: q (B, Sq, H, D), k/v (B, Sk, K, D) with
H = K * G (GQA/MQA: query head h reads KV head h // G). Scores, softmax
statistics and the accumulator are fp32; the output takes q's dtype.
Masked scores take the finite sentinel ``NEG_INF``, as the reference's do.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask_for(qpos, kpos, causal, window, Sk0):
    mask = (kpos < Sk0)[None, :]
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if window:
        mask = mask & ((qpos[:, None] - kpos[None, :]) < window)
    return mask


def blocked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      q_chunk=1024, k_chunk=1024):
    """Online-softmax tiled attention, forward only: (B, Sq, H, D) ->
    (B, Sq, H, D). ``window`` 0 is unlimited, else only the last
    ``window`` keys; ``q_offset`` is the absolute position of q[0]."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {K}")
    G = H // K
    scale = 1.0 / (D ** 0.5)
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    kf = k.float()
    vf = v.float()
    out = torch.empty_like(q)
    for q0 in range(0, Sq, q_chunk):
        q_i = q[:, q0:q0 + q_chunk].float().reshape(B, -1, K, G, D) * scale
        qc = q_i.shape[1]
        qpos = q_offset + q0 + torch.arange(qc, device=q.device)
        m = torch.full((B, K, G, qc), NEG_INF, device=q.device)
        l = torch.zeros((B, K, G, qc), device=q.device)
        acc = torch.zeros((B, qc, K, G, D), device=q.device)
        for k0 in range(0, Sk, k_chunk):
            k_j, v_j = kf[:, k0:k0 + k_chunk], vf[:, k0:k0 + k_chunk]
            kpos = k0 + torch.arange(k_j.shape[1], device=q.device)
            s = torch.einsum("bqkgd,bskd->bkgqs", q_i, k_j)
            s = s.masked_fill(~_mask_for(qpos, kpos, causal, window, Sk), NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bqkgd", p, v_j)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        l = l.clamp_min(1e-30)
        o = acc / l.permute(0, 3, 1, 2)[..., None]
        out[:, q0:q0 + qc] = o.reshape(B, qc, H, D).to(q.dtype)
    return out


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Reference O(Sq*Sk) attention — the oracle for tests and kernels."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().reshape(B, Sq, K, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) / (D ** 0.5)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, valid_len):
    """Single-token attention against a (possibly rolling) KV cache:
    q (B, 1, H, D), caches (B, S, K, D); ``valid_len`` (a 0-d or (B,)
    tensor, or an int) counts the valid cache entries. With a rolling cache
    all S slots are valid once full; masking handles warm-up."""
    B, _, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qf = q.float().reshape(B, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float()) / (D ** 0.5)
    pos = torch.arange(S, device=q.device)
    valid = pos[None, :] < torch.as_tensor(valid_len, device=q.device).reshape(-1, 1)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)
