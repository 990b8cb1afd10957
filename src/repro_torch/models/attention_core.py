"""Attention inner loops in plain PyTorch (counterpart of
``repro/models/attention_core.py``).

``blocked_attention`` is the tiled online-softmax forward (flash-style:
the (Sq, Sk) score matrix never exists whole). It is the plain version
behind ``kernels/flash_attention.py``: prefill and the training forward on a
CPU tensor run it, and on the card the hand-written kernel computes the same
tiles. ``flash_attention_bwd`` is the reference's ``_flash_bwd``, the
backward of its custom VJP: it rebuilds the probability tiles from (q, k,
lse), so only O(Sq + Sk) is kept between the passes. It is plain torch on
both devices (no Pallas kernel computes it); ``kernels/ops.FlashAttention``
pairs it with the forward.
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
                      q_chunk=1024, k_chunk=1024, return_lse=False):
    """Online-softmax tiled attention, forward only: (B, Sq, H, D) ->
    (B, Sq, H, D). ``window`` 0 is unlimited, else only the last
    ``window`` keys; ``q_offset`` is the absolute position of q[0]. With
    ``return_lse`` also the (B, Sq, H) fp32 ``m + log(l)`` of the scaled
    scores, as the reference's ``_blocked_attention_fwd_impl`` returns it."""
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
    lse = torch.empty((B, Sq, H), device=q.device) if return_lse else None
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
        if return_lse:
            lse[:, q0:q0 + qc] = (m + torch.log(l)).permute(0, 3, 1, 2).reshape(B, qc, H)
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, out, lse, g, *, causal=True, window=0, q_chunk=1024,
                        k_chunk=1024):
    """(dq, dk, dv) of ``blocked_attention`` for the upstream gradient ``g``
    of ``out``: the reference's ``_flash_bwd``. Each (q tile, k tile) pair
    rebuilds its scores from q, k and the forward's ``lse`` (B, Sq, H);
    sums are fp32 and the gradients take their input's dtype.

    Tiles that the causal mask or the window hide from every query of the
    q tile add exact zeros in the reference, and are skipped here; ragged
    last tiles are slices, not padding."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / (D ** 0.5)
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    kf = k.float()
    vf = v.float()
    dq = torch.empty((B, Sq, H, D), device=q.device)
    dk = torch.zeros((B, Sk, K, D), device=q.device)
    dv = torch.zeros((B, Sk, K, D), device=q.device)
    for q0 in range(0, Sq, q_chunk):
        sl = slice(q0, q0 + q_chunk)
        q_i = q[:, sl].float().reshape(B, -1, K, G, D)
        qc = q_i.shape[1]
        g_i = g[:, sl].float().reshape(B, qc, K, G, D)
        o_i = out[:, sl].float().reshape(B, qc, K, G, D)
        l_i = lse[:, sl].reshape(B, qc, K, G).permute(0, 2, 3, 1)         # (B, K, G, qc)
        d_i = torch.einsum("bqkgd,bqkgd->bkgq", g_i, o_i)                # rowsum(dO * O)
        qpos = q0 + torch.arange(qc, device=q.device)
        dq_i = torch.zeros((B, qc, K, G, D), device=q.device)
        for k0 in range(0, Sk, k_chunk):
            k_j, v_j = kf[:, k0:k0 + k_chunk], vf[:, k0:k0 + k_chunk]
            kc = k_j.shape[1]
            if causal and k0 > q0 + qc - 1:
                break
            if window and k0 + kc - 1 <= q0 - window:
                continue
            kpos = k0 + torch.arange(kc, device=q.device)
            s = torch.einsum("bqkgd,bskd->bkgqs", q_i * scale, k_j)
            s = s.masked_fill(~_mask_for(qpos, kpos, causal, window, Sk), NEG_INF)
            p = torch.exp(s - l_i[..., None])                          # (B, K, G, qc, kc)
            dv[:, k0:k0 + kc] += torch.einsum("bkgqs,bqkgd->bskd", p, g_i)
            dp = torch.einsum("bqkgd,bskd->bkgqs", g_i, v_j)
            ds = p * (dp - d_i[..., None]) * scale
            dq_i += torch.einsum("bkgqs,bskd->bqkgd", ds, k_j)
            dk[:, k0:k0 + kc] += torch.einsum("bkgqs,bqkgd->bskd", ds, q_i)
        dq[:, sl] = dq_i.reshape(B, qc, H, D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
