"""Transformer building blocks for the LM substrate (counterpart of
``repro/models/layers.py``).

Every block is an (init, apply) pair over dict trees:

    apply(params, cfg, x, *, positions, cache, mode) -> (y, new_cache, aux)

``mode`` is one of "train" (no cache), "prefill" (build cache), "decode"
(one-token step against the cache) or "encode" (an encoder's layer: no
cache, no causal mask). Matmuls run in the params' dtype; norms
and softmax statistics in float32. Where the reference calls
``blocked_attention``, prefill attention goes through ``ops.mha_flash`` (the
hand-written flash kernel on the card) and training attention through
``ops.mha_flash_train`` (the same kernel forward, with the reference's
flash backward); an encoder's attention (``mode="encode"``) and
cross-attention are bidirectional (``causal=False``), the latter at
Sq != Sk. Decode attention is ``decode_attention`` (MLA's: its absorbed
form, plain fp32). Caches are updated out of place, as the
reference's are, so a caller may keep the cache it passed in.

Init functions draw from ``gen`` (a ``torch.Generator`` on the model's
device, or ``None`` on the ``meta`` device, which only states shapes) in the
params' dtype; ``lead`` axes (a segment's stacked repeats) come first.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import mha_flash, mha_flash_train
from repro_torch.models import nn
from repro_torch.models.attention_core import decode_attention

# ---------------------------------------------------------------------------
# Norms / embeddings / RoPE
# ---------------------------------------------------------------------------


def _full(value, shape, dtype, device, lead=()):
    return torch.full(tuple(lead) + tuple(shape), value, dtype=dtype, device=device)


def rmsnorm_init(d, dtype, device, lead=()):
    return {"scale": _full(1.0, (d,), dtype, device, lead)}


def rmsnorm(p, x, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def embed_init(gen, vocab, d, dtype, device, lead=()):
    return {"table": nn.normal_init(gen, (vocab, d), 0.02, device, dtype, lead)}


def embed_lookup(p, tokens):
    return p["table"][tokens.long()]


def rope_freqs(head_dim: int, theta: float, device):
    """(head_dim / 2,) fp32 rotary frequencies, formed in float64 on
    ``device`` as the reference forms them in numpy: a host array copied to
    the card would make the host wait for the card at every layer."""
    ar = torch.arange(0, head_dim, 2, dtype=torch.float64, device=device)
    return (1.0 / (theta ** (ar / head_dim))).float()


def apply_rope(x, positions, theta: float, mrope_sections=None):
    """x: (B, S, H, D); positions: (B, S), or (B, S, 3) (text tokens: every
    component equal, and the first is taken).

    With ``mrope_sections`` (M-RoPE, Qwen2-VL) positions must be (B, S, 3):
    the D/2 rotary channels are split into (temporal, height, width)
    sections of those sizes, and each channel turns by its section's
    component. The sections' components are sliced and widened on the
    tensors' device, so no index array crosses from the host."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)
    if mrope_sections is None:
        if positions.ndim == 3:
            positions = positions[..., 0]
        angles = positions[..., None].float() * freqs
    else:
        if positions.ndim != 3 or positions.shape[-1] != 3:
            raise ValueError(f"M-RoPE takes (B, S, 3) positions, got {tuple(positions.shape)}")
        if sum(mrope_sections) != D // 2:
            raise ValueError(f"M-RoPE sections {tuple(mrope_sections)} do not sum to "
                             f"head_dim / 2 = {D // 2}")
        pos = positions.float()
        per_freq = torch.cat([pos[..., i:i + 1].expand(*pos.shape[:-1], n)
                              for i, n in enumerate(mrope_sections)], dim=-1)   # (B, S, D/2)
        angles = per_freq * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA / MQA attention (with optional QKV bias, sliding window, KV cache)
# ---------------------------------------------------------------------------


def attention_init(gen, cfg: ModelConfig, dtype, device, lead=()):
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": nn.glorot(gen, (d, H * hd), device, dtype, lead),
        "wk": nn.glorot(gen, (d, K * hd), device, dtype, lead),
        "wv": nn.glorot(gen, (d, K * hd), device, dtype, lead),
        "wo": nn.glorot(gen, (H * hd, d), device, dtype, lead),
    }
    if cfg.attn_bias:
        p["bq"] = _full(0.0, (H * hd,), dtype, device, lead)
        p["bk"] = _full(0.0, (K * hd,), dtype, device, lead)
        p["bv"] = _full(0.0, (K * hd,), dtype, device, lead)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, device, lead)
        p["k_norm"] = rmsnorm_init(hd, dtype, device, lead)
    return p


def _prefill_write(cache_buf, fresh):
    """S fresh entries into a length-L cache (sequence axis 1, any number of
    axes after it): the fresh tensor itself when S == L, zero-padded up to L
    when S < L (masking is by ``idx``), and the last L entries at slots
    t % L when S > L (a rolling window)."""
    L, S = cache_buf.shape[1], fresh.shape[1]
    if S == L:
        return fresh.to(cache_buf.dtype)
    if S < L:
        pad = [0, 0] * (fresh.ndim - 2) + [0, L - S]   # F.pad lists the last axis first
        return F.pad(fresh, pad).to(cache_buf.dtype)
    out = cache_buf.clone()
    t = torch.arange(S - L, S, device=fresh.device)
    out[:, t % L] = fresh[:, S - L:].to(cache_buf.dtype)
    return out


def init_attn_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device, lead=()):
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": _full(0.0, (batch, cache_len, K, hd), dtype, device, lead),
        "v": _full(0.0, (batch, cache_len, K, hd), dtype, device, lead),
        "idx": _full(0, (), torch.int32, device, lead),   # tokens written so far
    }


def attention_apply(p, cfg: ModelConfig, x, *, positions, cache=None, mode="train",
                    window: int = 0):
    B, S, d = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def proj(w, b, heads):
        y = x @ p[w]
        if b in p:
            y = y + p[b]
        return y.reshape(B, S, heads, hd)

    q, k, v = proj("wq", "bq", H), proj("wk", "bk", K), proj("wv", "bv", K)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes one token against a cache")
        cache_len = cache["k"].shape[1]
        slot = (cache["idx"] % cache_len).long().reshape(1)   # rolling when windowed
        k_c = cache["k"].index_copy(1, slot, k.to(cache["k"].dtype))
        v_c = cache["v"].index_copy(1, slot, v.to(cache["v"].dtype))
        valid = torch.clamp(cache["idx"] + 1, max=cache_len)
        out = decode_attention(q, k_c, v_c, valid)
        new_cache = {"k": k_c, "v": v_c, "idx": cache["idx"] + 1}
    elif mode == "train":
        out = mha_flash_train(q, k, v, causal=True, window=window,
                              q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
        new_cache = None
    elif mode == "encode" and q.requires_grad:
        # a differentiable encoder (training an encoder-decoder): the same
        # kernel through the autograd.Function, bidirectional
        out = mha_flash_train(q, k, v, causal=False, window=window,
                              q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
        new_cache = None
    else:
        out = mha_flash(q, k, v, causal=(mode != "encode"), window=window)
        if mode == "prefill":
            idx = torch.full((), S, dtype=torch.int32, device=x.device)
            if cache is not None:
                new_cache = {"k": _prefill_write(cache["k"], k),
                             "v": _prefill_write(cache["v"], v), "idx": idx}
            else:
                new_cache = {"k": k, "v": v, "idx": idx}
        else:
            new_cache = None
    y = out.reshape(B, S, H * hd) @ p["wo"]
    return y, new_cache, 0.0


# ---------------------------------------------------------------------------
# Encoder-decoder cross-attention (SeamlessM4T)
# ---------------------------------------------------------------------------


def cross_attention_init(gen, cfg: ModelConfig, dtype, device, lead=()):
    return attention_init(gen, dataclasses.replace(cfg, attn_bias=False), dtype, device, lead)


def init_cross_cache(cfg: ModelConfig, batch: int, memory_len: int, dtype, device, lead=()):
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {"k": _full(0.0, (batch, memory_len, K, hd), dtype, device, lead),
            "v": _full(0.0, (batch, memory_len, K, hd), dtype, device, lead)}


def cross_attention_apply(p, cfg: ModelConfig, x, memory, *, cache=None, mode="train"):
    """The decoder's queries against the encoder's ``memory`` (B, M, d),
    position-free: no RoPE, no bias. K and V are projected from the memory
    in train and prefill mode; prefill returns them as the layer's cross
    cache ``{"k", "v"}``, and decode reads them from it and takes no memory.

    Prefill attends through ``ops.mha_flash(causal=False)`` at Sq = S over
    Sk = M (the reference's ``blocked_attention``, which the flash kernel
    replaces); training through ``ops.mha_flash_train(causal=False)``, the
    same kernel with the flash backward. Decode at Sq = 1 is the plain
    ``decode_attention`` with ``valid_len`` = M, as self-attention's decode:
    the reference's ``blocked_attention`` at Sq = 1 computes the same
    softmax over the M keys."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes one token against a cache")
        k, v = cache["k"], cache["v"]
        # every key is valid: M filled on the device, not copied from the host
        valid = torch.full((), k.shape[1], dtype=torch.int32, device=x.device)
        return (decode_attention(q, k, v, valid).reshape(B, S, H * hd) @ p["wo"], cache, 0.0)
    M = memory.shape[1]
    k = (memory @ p["wk"]).reshape(B, M, K, hd)
    v = (memory @ p["wv"]).reshape(B, M, K, hd)
    if mode == "train":
        out = mha_flash_train(q, k, v, causal=False, q_chunk=cfg.attn_q_chunk,
                              k_chunk=cfg.attn_k_chunk)
    else:
        out = mha_flash(q, k, v, causal=False)
    new_cache = {"k": k, "v": v} if mode == "prefill" else None
    return out.reshape(B, S, H * hd) @ p["wo"], new_cache, 0.0


# ---------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek V2/V3)
# ---------------------------------------------------------------------------


def mla_init(gen, cfg: ModelConfig, dtype, device, lead=()):
    """The query (a low-rank pair with an RMSNorm between when
    ``q_lora_rank``, else one ``wq``), the down-projection to the shared
    latent and rope key (``wkv_a``), the latent's norm, the up-projection
    to every head's K_nope and V (``wkv_b``) and ``wo``."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    p = {}
    if m.q_lora_rank:
        p["wq_a"] = nn.glorot(gen, (d, m.q_lora_rank), device, dtype, lead)
        p["q_norm"] = rmsnorm_init(m.q_lora_rank, dtype, device, lead)
        p["wq_b"] = nn.glorot(gen, (m.q_lora_rank, H * qk_dim), device, dtype, lead)
    else:
        p["wq"] = nn.glorot(gen, (d, H * qk_dim), device, dtype, lead)
    p["wkv_a"] = nn.glorot(gen, (d, m.kv_lora_rank + m.qk_rope_dim), device, dtype, lead)
    p["kv_norm"] = rmsnorm_init(m.kv_lora_rank, dtype, device, lead)
    p["wkv_b"] = nn.glorot(gen, (m.kv_lora_rank, H * (m.qk_nope_dim + m.v_head_dim)), device,
                           dtype, lead)
    p["wo"] = nn.glorot(gen, (H * m.v_head_dim, d), device, dtype, lead)
    return p


def init_mla_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device, lead=()):
    """MLA caches the normed latent and the rotated rope key, one of each a
    token for all heads, not per-head K and V."""
    m = cfg.mla
    return {
        "latent": _full(0.0, (batch, cache_len, m.kv_lora_rank), dtype, device, lead),
        "k_rope": _full(0.0, (batch, cache_len, m.qk_rope_dim), dtype, device, lead),
        "idx": _full(0, (), torch.int32, device, lead),
    }


def _mla_q(p, cfg: ModelConfig, x, positions):
    m = cfg.mla
    B, S, _ = x.shape
    if m.q_lora_rank:
        q = rmsnorm(p["q_norm"], x @ p["wq_a"], cfg.norm_eps) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(B, S, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def mla_apply(p, cfg: ModelConfig, x, *, positions, cache=None, mode="train", window: int = 0):
    """MLA. Train and prefill: the naive up-projection, every head's K_nope
    and V from the latent, the rope key shared by the heads, V zero-padded
    to the qk head dim so that one attention call takes it (the flash
    kernel at D = 192 for DeepSeek), and the output sliced back. Decode:
    the absorbed form in fp32, as the reference's plain one: W_UK folded
    into the query, scores against the cached latent plus the rope key,
    W_UV applied after, so no per-head K or V is ever formed."""
    m = cfg.mla
    B, S, _ = x.shape
    H, R = cfg.n_heads, m.kv_lora_rank
    nope, vdim = m.qk_nope_dim, m.v_head_dim
    q_nope, q_rope = _mla_q(p, cfg, x, positions)

    kv = x @ p["wkv_a"]
    latent = rmsnorm(p["kv_norm"], kv[..., :R], cfg.norm_eps)
    k_rope = apply_rope(kv[..., R:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]

    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes one token against a cache")
        wkv_b = p["wkv_b"].reshape(R, H, nope + vdim).float()
        cache_len = cache["latent"].shape[1]
        slot = (cache["idx"] % cache_len).long().reshape(1)
        lat_c = cache["latent"].index_copy(1, slot, latent.to(cache["latent"].dtype))
        kr_c = cache["k_rope"].index_copy(1, slot, k_rope.to(cache["k_rope"].dtype))
        valid = torch.clamp(cache["idx"] + 1, max=cache_len)
        lat_f = lat_c.float()
        q_eff = torch.einsum("bshn,rhn->bshr", q_nope.float(), wkv_b[..., :nope])
        s_lat = torch.einsum("bshr,btr->bhst", q_eff, lat_f)
        s_rope = torch.einsum("bshr,btr->bhst", q_rope.float(), kr_c.float())
        s = (s_lat + s_rope) * (1.0 / np.sqrt(nope + m.qk_rope_dim))
        live = torch.arange(cache_len, device=x.device) < valid
        probs = torch.softmax(s.masked_fill(~live, -1e30), dim=-1)
        o_lat = torch.einsum("bhst,btr->bshr", probs, lat_f)
        out = torch.einsum("bshr,rhv->bshv", o_lat, wkv_b[..., nope:]).to(x.dtype)
        new_cache = {"latent": lat_c, "k_rope": kr_c, "idx": cache["idx"] + 1}
    else:
        kv_up = (latent @ p["wkv_b"]).reshape(B, S, H, nope + vdim)
        k_nope, v = kv_up[..., :nope], kv_up[..., nope:]
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, m.qk_rope_dim)],
                           dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        v_pad = F.pad(v, (0, nope + m.qk_rope_dim - vdim))
        if mode == "train":
            out = mha_flash_train(q_full, k_full, v_pad, causal=True, window=window,
                                  q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
        else:
            out = mha_flash(q_full, k_full, v_pad, causal=True, window=window)
        out = out[..., :vdim]
        if mode == "prefill":
            idx = torch.full((), S, dtype=torch.int32, device=x.device)
            if cache is not None:
                new_cache = {"latent": _prefill_write(cache["latent"], latent),
                             "k_rope": _prefill_write(cache["k_rope"], k_rope), "idx": idx}
            else:
                new_cache = {"latent": latent, "k_rope": k_rope, "idx": idx}
        else:
            new_cache = None
    y = out.reshape(B, S, H * vdim) @ p["wo"]
    return y, new_cache, 0.0


# ---------------------------------------------------------------------------
# MLPs: SwiGLU / GeGLU / ReLU
# ---------------------------------------------------------------------------

_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def mlp_init(gen, d_model, d_ff, dtype, device, gated=True, lead=()):
    p = {
        "wi": nn.glorot(gen, (d_model, d_ff), device, dtype, lead),
        "wo": nn.glorot(gen, (d_ff, d_model), device, dtype, lead),
    }
    if gated:
        p["wg"] = nn.glorot(gen, (d_model, d_ff), device, dtype, lead)
    return p


def mlp_apply(p, x, act="silu"):
    h = x @ p["wi"]
    if "wg" in p:
        h = h * _ACTS[act](x @ p["wg"])
    else:
        h = _ACTS[act](h)
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# Mixture of Experts (sort-based grouped dispatch, capacity factor)
# ---------------------------------------------------------------------------


def moe_init(gen, cfg: ModelConfig, dtype, device, lead=()):
    mo = cfg.moe
    d = cfg.d_model
    p = {
        "router": nn.normal_init(gen, (d, mo.n_experts), 0.02, device, torch.float32, lead),
        "we_i": nn.normal_init(gen, (mo.n_experts, d, mo.d_ff), 0.02, device, dtype, lead),
        "we_g": nn.normal_init(gen, (mo.n_experts, d, mo.d_ff), 0.02, device, dtype, lead),
        "we_o": nn.normal_init(gen, (mo.n_experts, mo.d_ff, d), 0.02, device, dtype, lead),
    }
    if mo.n_shared_experts:
        p["shared"] = mlp_init(gen, d, mo.d_ff * mo.n_shared_experts, dtype, device, lead=lead)
    return p


def _top_k(scores, k):
    """``jax.lax.top_k``: the k largest, ties to the lower index (a stable
    descending sort keeps equal scores in index order; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p, cfg: ModelConfig, x, act="silu"):
    """Token-choice top-k routing with the reference's sort-based grouped
    dispatch: within each token group the (token, expert) assignments are
    stably sorted by expert and packed into an (E, capacity) buffer, the
    overflow dropped; the expert FFNs are batched matrix products. Both
    argsorts are stable and the ``searchsorted`` sides are the reference's,
    so the same tokens drop. Returns (y, aux load-balance loss)."""
    mo = cfg.moe
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    E, k = mo.n_experts, mo.topk

    logits = xt.float() @ p["router"]
    if mo.router_scoring == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    gate, expert_idx = _top_k(scores, k)                              # (T, k)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    probs_mean = torch.softmax(logits, dim=-1).mean(dim=0)
    counts = torch.zeros((E,), device=x.device).index_add_(
        0, expert_idx.reshape(-1), torch.ones(T * k, device=x.device))
    aux = mo.router_aux_weight * E * torch.sum(counts / (T * k) * probs_mean)

    gs = min(mo.group_size, T)
    while T % gs:
        gs //= 2
    G = T // gs
    cap = int(np.ceil(gs * k / E * mo.capacity_factor))

    e_g = expert_idx.reshape(G, gs * k)
    g_g = gate.reshape(G, gs * k).to(xt.dtype)
    x_g = xt.reshape(G, gs, d)
    rows = torch.arange(G, device=x.device)[:, None]

    sort_idx = torch.argsort(e_g, dim=-1, stable=True)               # (G, gs*k)
    sorted_e = torch.gather(e_g, 1, sort_idx)
    eye = torch.arange(E, device=x.device).expand(G, E).contiguous()
    first = torch.searchsorted(sorted_e, eye, side="left")           # (G, E)
    cnt_e = torch.searchsorted(sorted_e, eye, side="right") - first

    slot = torch.arange(cap, device=x.device)
    slot_pos = first[:, :, None] + slot                              # (G, E, cap)
    valid = slot < cnt_e[:, :, None]
    slot_pos = slot_pos.clamp(0, gs * k - 1).reshape(G, E * cap)
    tok = torch.gather(sort_idx, 1, slot_pos) // k                   # (G, E*cap)
    buf = x_g[rows, tok]                                             # (G, E*cap, d)
    buf = torch.where(valid.reshape(G, E * cap, 1), buf, 0).reshape(G, E, cap, d)

    h = torch.einsum("gecd,edf->gecf", buf, p["we_i"])
    h = h * _ACTS[act](torch.einsum("gecd,edf->gecf", buf, p["we_g"]))
    out_buf = torch.einsum("gecf,efd->gecd", h, p["we_o"])            # (G, E, cap, d)

    inv = torch.argsort(sort_idx, dim=-1, stable=True)
    rank_sorted = torch.arange(gs * k, device=x.device) - torch.gather(first, 1, sorted_e)
    rank_j = torch.gather(rank_sorted, 1, inv)                       # (G, gs*k)
    keep_j = rank_j < cap
    slot_j = e_g * cap + rank_j.clamp(max=cap - 1)
    contrib = out_buf.reshape(G, E * cap, d)[rows, slot_j]           # (G, gs*k, d)
    w = (g_g * keep_j)[..., None]
    y = (contrib * w).reshape(G, gs, k, d).sum(dim=2).reshape(B, S, d)

    if mo.n_shared_experts:
        y = y + mlp_apply(p["shared"], x, act)
    return y, aux
