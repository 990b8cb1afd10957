"""xLSTM blocks: sLSTM (scalar memory, exponential gating, head-block-diagonal
recurrence) and mLSTM (matrix memory, parallelizable), per arXiv:2405.04517
(counterpart of ``repro/models/xlstm.py``).

Both keep the paper's stabilizer state m_t so that the exponential gates stay
bounded:

    m_t = max(log f_t + m_{t-1}, log i_t)
    i'  = exp(log i_t - m_t),   f' = exp(log f_t + m_{t-1} - m_t)

mLSTM block: pre-LN -> up-projection (factor 2) -> q, k, v from one branch
-> matrix-memory recurrence -> gated by the other branch -> down-projection.
sLSTM block: pre-LN -> sLSTM with head-block-diagonal recurrence -> gated
FFN (factor 4/3), the paper's post-up-projection block.

The reference computes both in plain XLA (no Pallas kernel), so the port is
plain torch with the reference's arithmetic: q, k, v are projected in the
params' dtype and taken to fp32, the gates from ``xb.float()`` against the
fp32 gate weights, and every state is fp32. The stabilizer starts at the
finite sentinel -1e30, never -inf (-inf - -inf is NaN); a chunkwise input
padded past S takes input gates of -1e30 and forget gates of 0, so it adds
nothing and carries the state through. Prefill runs the chunkwise form
(:func:`_mlstm_chunkwise`, chunks of ``min(chunk, S)``) and one token
(decode) the exact step (:func:`_mlstm_step`), which is also the chunkwise
form's oracle. The sLSTM recurrence is a loop over t: the reference runs it
through ``_segmented_scan(segment=128)``, whose segments only set what its
backward recomputes, so the loop computes the same steps.

Decode caches: mLSTM (C: B, H, D, D; n: B, H, D; m: B, H), sLSTM (c, n, h,
m: B, H, D), all fp32: O(1) per token. The chunkwise form and the sLSTM
loop run inside the ``torch.profiler`` ranges ``mlstm_chunkwise`` and
``slstm_scan``, so a trace shows what each costs.

Init functions take ``gen``, ``dtype``, ``device`` and ``lead`` as the other
blocks' (``models/layers.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import nn
from repro_torch.models.layers import _full, rmsnorm, rmsnorm_init

NEG = -1e30   # the stabilizer's start and the padded input gates

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(gen, cfg: ModelConfig, dtype, device, lead=()):
    d, H = cfg.d_model, cfg.n_heads
    di = 2 * d   # up-projection factor 2 (paper)
    return {
        "up": nn.glorot(gen, (d, 2 * di), device, dtype, lead),   # -> (x branch, z gate)
        "mq": nn.glorot(gen, (di, di), device, dtype, lead),
        "mk": nn.glorot(gen, (di, di), device, dtype, lead),
        "mv": nn.glorot(gen, (di, di), device, dtype, lead),
        "wi": nn.glorot(gen, (di, H), device, torch.float32, lead),   # input gate, per head
        "wf": nn.glorot(gen, (di, H), device, torch.float32, lead),   # forget gate, per head
        "bi": _full(0.0, (H,), torch.float32, device, lead),
        "bf": _full(3.0, (H,), torch.float32, device, lead),         # forget bias starts high
        "out_norm": rmsnorm_init(di, dtype, device, lead),
        "down": nn.glorot(gen, (di, d), device, dtype, lead),
    }


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype, device, lead=()):
    H = cfg.n_heads
    hd = 2 * cfg.d_model // H
    return {
        "C": _full(0.0, (batch, H, hd, hd), torch.float32, device, lead),
        "n": _full(0.0, (batch, H, hd), torch.float32, device, lead),
        "m": _full(NEG, (batch, H), torch.float32, device, lead),
    }


def mlstm_apply(p, cfg: ModelConfig, x, *, cache=None, mode="train", chunk=1024):
    """x: (B, S, d). Returns (y, new cache; None in train mode)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    xb, z = (x @ p["up"]).chunk(2, dim=-1)   # (B, S, di)
    di = xb.shape[-1]
    hd = di // H

    q = (xb @ p["mq"]).reshape(B, S, H, hd).float()
    k = (xb @ p["mk"]).reshape(B, S, H, hd).float() / (hd ** 0.5)
    v = (xb @ p["mv"]).reshape(B, S, H, hd).float()
    xf = xb.float()
    ig = xf @ p["wi"] + p["bi"]                     # (B, S, H) log input gate
    fg = F.logsigmoid(xf @ p["wf"] + p["bf"])       # log forget gate

    if mode == "decode":
        if cache is None:
            raise ValueError("decode takes a cache")
        carry0 = (cache["C"], cache["n"], cache["m"])
    else:
        carry0 = (torch.zeros((B, H, hd, hd), device=x.device),
                  torch.zeros((B, H, hd), device=x.device),
                  torch.full((B, H), NEG, device=x.device))

    if S == 1:
        carry, y = _mlstm_step(carry0, (q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0]))
        ys = y[:, None]
    else:
        with torch.profiler.record_function("mlstm_chunkwise"):
            carry, ys = _mlstm_chunkwise(carry0, q, k, v, ig, fg, chunk=min(chunk, S))
    y = ys.reshape(B, S, di).to(x.dtype)
    y = rmsnorm(p["out_norm"], y, cfg.norm_eps) * F.silu(z)
    out = y @ p["down"]
    new_cache = None if mode == "train" else {"C": carry[0], "n": carry[1], "m": carry[2]}
    return out, new_cache


def _mlstm_step(carry, inp):
    """One step of the exact sequential recurrence (the decode path, and the
    chunkwise form's oracle): ((C, n, m), y (B, H, hd))."""
    C, n, m = carry
    q_t, k_t, v_t, i_t, f_t = inp
    m_new = torch.maximum(f_t + m, i_t)               # (B, H)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_t + m - m_new)
    C = f_p[..., None, None] * C + i_p[..., None, None] * (v_t[..., :, None] * k_t[..., None, :])
    n = f_p[..., None] * n + i_p[..., None] * k_t
    num = torch.einsum("bhvk,bhk->bhv", C, q_t)
    den = torch.clamp(torch.einsum("bhk,bhk->bh", n, q_t).abs(), min=1.0)
    return (C, n, m_new), num / den[..., None]


def _mlstm_chunkwise(carry0, q, k, v, ig, fg, *, chunk):
    """The chunkwise-parallel mLSTM, the reference's ``_mlstm_chunkwise``.

    Within a chunk of length L, with the local cumulative log forget
    b_t = sum_{u<=t} fg_u and the running stabilizer
    m_t = b_t + max(m_prev, cummax_{s<=t}(ig_s - b_s)), the outputs are an
    intra-chunk attention-like term sum_{s<=t} exp(b_t - b_s + ig_s - m_t)
    (q_t . k_s) v_s plus an inter-chunk term exp(b_t + m_prev - m_t)
    q_t . C_prev; only the (C, n, m) state crosses chunk boundaries. The
    intra-chunk decays above the diagonal are masked before the exponential
    (exp(-1e30) = 0, as the reference's ``where`` after it gives), so no
    large exponent reaches the backward."""
    B, S, H, hd = q.shape
    L = chunk
    pad = (-S) % L
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        ig = F.pad(ig, (0, 0, 0, pad), value=NEG)   # no contribution
        fg = F.pad(fg, (0, 0, 0, pad))              # log f = 0: the state carries through
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()[None, :, :, None]
    C_p, n_p, m_p = carry0
    ys = []
    for c0 in range(0, q.shape[1], L):
        sl = slice(c0, c0 + L)
        q_i, k_i, v_i, ig_i, fg_i = q[:, sl], k[:, sl], v[:, sl], ig[:, sl], fg[:, sl]
        b = torch.cumsum(fg_i, dim=1)                          # (B, L, H)
        g = torch.cummax(ig_i - b, dim=1).values               # (B, L, H)
        m_t = b + torch.maximum(m_p[:, None], g)               # (B, L, H)
        logD = b[:, :, None] - b[:, None, :] + ig_i[:, None, :] - m_t[:, :, None]   # (B, Lt, Ls, H)
        D = torch.exp(logD.masked_fill(~tri, NEG))
        scores = torch.einsum("bthd,bshd->btsh", q_i, k_i) * D
        intra = torch.einsum("btsh,bshd->bthd", scores, v_i)
        inter_w = torch.exp(b + m_p[:, None] - m_t)            # (B, L, H)
        inter = torch.einsum("bthd,bhvd->bthv", q_i, C_p) * inter_w[..., None]
        qn = inter_w * torch.einsum("bthd,bhd->bth", q_i, n_p) + scores.sum(dim=2)
        den = torch.clamp(qn.abs(), min=1.0)
        ys.append((intra + inter) / den[..., None])
        # the state at the chunk's last step
        m_L = m_t[:, -1]                                       # (B, H)
        w_end = torch.exp(b[:, -1:] - b + ig_i - m_L[:, None])  # (B, L, H)
        decay = torch.exp(b[:, -1] + m_p - m_L)
        C_p = decay[..., None, None] * C_p + torch.einsum("bsh,bshv,bshk->bhvk", w_end, v_i, k_i)
        n_p = decay[..., None] * n_p + torch.einsum("bsh,bshk->bhk", w_end, k_i)
        m_p = m_L
    return (C_p, n_p, m_p), torch.cat(ys, dim=1)[:, :S]


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(gen, cfg: ModelConfig, dtype, device, lead=()):
    """Four gates (i, f, z, o): input weights ``wx`` (d, 4d), block-diagonal
    recurrent weights ``r`` (H, hd, 4 hd) and a bias ``b`` (4d,), both fp32;
    then the gated FFN. The reference draws the FFN's ``wi`` and ``wg`` from
    one key, so they start equal; so do they here."""
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    ff = max((4 * d) // 3, 8)
    wi = nn.glorot(gen, (d, ff), device, dtype, lead)
    return {
        "wx": nn.glorot(gen, (d, 4 * d), device, dtype, lead),
        "r": nn.normal_init(gen, (H, hd, 4 * hd), 0.1, device, torch.float32, lead),
        "b": torch.cat([_full(0.0, (d,), torch.float32, device, lead),
                        _full(3.0, (d,), torch.float32, device, lead),
                        _full(0.0, (2 * d,), torch.float32, device, lead)], dim=-1),
        "ffn": {"wi": wi, "wg": wi.clone(),
                "wo": nn.glorot(gen, (ff, d), device, dtype, lead)},
        "ffn_norm": rmsnorm_init(d, dtype, device, lead),
    }


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype, device, lead=()):
    H = cfg.n_heads
    hd = cfg.d_model // H
    z = lambda: _full(0.0, (batch, H, hd), torch.float32, device, lead)  # noqa: E731
    return {"c": z(), "n": z(), "h": z(),
            "m": _full(NEG, (batch, H, hd), torch.float32, device, lead)}


def slstm_apply(p, cfg: ModelConfig, x, *, cache=None, mode="train"):
    """x: (B, S, d). Returns (y, new cache; None in train mode).

    The gate layout is (i, f, z, o) in both parts, but not the same axes:
    the input part is ``wx``'s columns in four d-blocks, (B, 4, H, hd); the
    recurrent part is four hd-blocks of each head's ``r`` output,
    (B, H, 4, hd)."""
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    gates_x = (x @ p["wx"]).float() + p["b"]               # (B, S, 4d)
    gx = gates_x.reshape(B, S, 4, H, hd)
    r = p["r"]

    if mode == "decode":
        if cache is None:
            raise ValueError("decode takes a cache")
        c, n, h, m = cache["c"], cache["n"], cache["h"], cache["m"]
    else:
        c = n = h = torch.zeros((B, H, hd), device=x.device)
        m = torch.full((B, H, hd), NEG, device=x.device)
    hs = []
    with torch.profiler.record_function("slstm_scan"):
        for gx_t in gx.unbind(1):                          # (B, 4, H, hd) a step
            rc = torch.einsum("bhk,hkg->bhg", h, r).reshape(B, H, 4, hd)
            i_t = gx_t[:, 0] + rc[:, :, 0]
            f_t = gx_t[:, 1] + rc[:, :, 1]
            z_t = torch.tanh(gx_t[:, 2] + rc[:, :, 2])
            o_t = torch.sigmoid(gx_t[:, 3] + rc[:, :, 3])
            logf = F.logsigmoid(f_t)
            m_new = torch.maximum(logf + m, i_t)
            i_p = torch.exp(i_t - m_new)
            f_p = torch.exp(logf + m - m_new)
            c = f_p * c + i_p * z_t
            n = torch.clamp(f_p * n + i_p, min=1.0)
            h = o_t * (c / n)
            m = m_new
            hs.append(h)
        y = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype)
    # the gated FFN (post-up-projection, factor 4/3)
    yn = rmsnorm(p["ffn_norm"], y, cfg.norm_eps)
    ff = (yn @ p["ffn"]["wi"]) * F.silu(yn @ p["ffn"]["wg"])
    out = y + ff @ p["ffn"]["wo"]
    new_cache = None if mode == "train" else {"c": c, "n": n, "h": h, "m": m}
    return out, new_cache
