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
fp32 gate weights, and every state is fp32. Every product with a weight in
the params' dtype (the mLSTM's ``up``, ``mq``, ``mk``, ``mv``, ``down``; the
sLSTM's ``wx`` and its FFN's ``wi``, ``wg``, ``wo``) goes through
:func:`_mm`: in bf16 its sums are fp32 and it is rounded to bf16 once, so a
row's bits do not depend on how many rows the product has. A bf16 GEMM
picks its blocking by the row count, so without this the prefill over S - 1
tokens handed the decode step another state than the forward over S
computes; the reference's forward gives its first S - 1 rows the same bits
either way. The fp32 gate products take fp64 sums rounded once to fp32
(:func:`_mm_gate`) for the same reason.

The stabilizer starts at the finite sentinel -1e30, never -inf (-inf - -inf
is NaN); a chunkwise input padded past S takes input gates of -1e30 and
forget gates of 0, so it adds nothing and carries the state through.
Prefill runs the chunkwise form (:func:`_mlstm_chunkwise`, chunks of
:data:`CHUNK` tokens) and one token (decode) the exact step
(:func:`_mlstm_step`), which is also the chunkwise form's oracle. The sLSTM
recurrence is a loop over t: the reference runs it through
``_segmented_scan(segment=128)``, whose segments only set what its backward
recomputes, so the loop computes the same steps. Under autograd the loop
runs inside :class:`_SLSTMScan`, whose backward is the chain rule written
out (the same gradients, far fewer host ops than autograd's).

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
from repro_torch.kernels.ops import _mm_f32
from repro_torch.models import nn
from repro_torch.models.layers import _full, rmsnorm, rmsnorm_init

NEG = -1e30   # the stabilizer's start and the padded input gates
# The chunkwise form's chunk, the same for every S (the reference takes
# min(1024, S)): each chunk's tensors then have one shape, so every op of it
# computes a row's values in the same order and lanes whatever S is. Over
# min(1024, S) the CPU's vectorized exp and sums give the (t, s) entries of
# a chunk of 127 and of 128 other bits, which bf16 rounding carries on.
CHUNK = 128


class _MatmulF32(torch.autograd.Function):
    """(M, k) x (k, n) bf16 -> (M, n) bf16 with fp32 sums and one rounding,
    forward and backward: ``ops._mm_f32`` (cuBLAS's bf16 product with an
    fp32 output on the card, the fp32-widened product on the CPU; bf16
    products are exact in fp32), then one cast. The backward's two products
    take the same route on the bf16 cotangent, each rounded once to its
    input's dtype, so no derivative of ``torch.mm(out_dtype=)`` is relied
    on; widening the inputs under autograd instead would keep fp32 copies
    of them for the backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b).to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = _mm_f32(g, b.T).to(a.dtype) if ctx.needs_input_grad[0] else None
        gb = _mm_f32(a.T, g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return ga, gb


def _mm_gate(xf, w):
    """The fp32 gate product ``xf @ w`` of a (..., k) activation and a (k, H)
    fp32 gate weight, its sums in fp64 and rounded to fp32 once, so that a
    row's gate has the same bits whatever the number of rows: cuBLAS picks
    its fp32 kernel for so narrow a product by the row count (on an H100
    80GB HBM3 at 700 W, 87.6% of the gates took other bits over 254 rows
    than over 256), and fp64 sums rounded once do not show it. Autograd
    takes the gradient through the same casts."""
    return (xf.double() @ w.double()).float()


def _mm(x, w):
    """``x @ w`` of a (..., k) activation and a (k, n) weight. In bf16 with
    fp32 sums and one rounding to bf16 (:class:`_MatmulF32`), so that each
    row's result has the same bits whatever the number of rows; in fp32 the
    plain product (``.float()`` of an fp32 tensor is itself)."""
    if x.dtype != torch.bfloat16:
        return x @ w
    out = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


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


def mlstm_apply(p, cfg: ModelConfig, x, *, cache=None, mode="train", chunk=CHUNK):
    """x: (B, S, d). Returns (y, new cache; None in train mode). Over S > 1
    tokens the chunkwise form runs in chunks of ``chunk`` tokens, the tail
    padded, whatever S (see :data:`CHUNK`)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    xb, z = _mm(x, p["up"]).chunk(2, dim=-1)   # (B, S, di)
    di = xb.shape[-1]
    hd = di // H

    q = _mm(xb, p["mq"]).reshape(B, S, H, hd).float()
    k = _mm(xb, p["mk"]).reshape(B, S, H, hd).float() / (hd ** 0.5)
    v = _mm(xb, p["mv"]).reshape(B, S, H, hd).float()
    xf = xb.float()
    ig = _mm_gate(xf, p["wi"]) + p["bi"]            # (B, S, H) log input gate
    fg = F.logsigmoid(_mm_gate(xf, p["wf"]) + p["bf"])   # log forget gate

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
            carry, ys = _mlstm_chunkwise(carry0, q, k, v, ig, fg, chunk=chunk)
    y = ys.reshape(B, S, di).to(x.dtype)
    y = rmsnorm(p["out_norm"], y, cfg.norm_eps) * F.silu(z)
    out = _mm(y, p["down"])
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


def _slstm_step(gx_t, r, c, n, h, m):
    """One step of the sLSTM recurrence: gx_t (B, 4, H, hd) the input part
    of the gates, r (H, hd, 4 hd), the states (B, H, hd) each. Returns
    (pre, c, n, h, m): the gates' pre-activations (B, 4, H, hd) and the new
    states."""
    B, _, H, hd = gx_t.shape
    rc = torch.einsum("bhk,hkg->bhg", h, r).reshape(B, H, 4, hd)
    pre = gx_t + rc.transpose(1, 2)
    i_t, f_t, z_t, o_t = pre.unbind(1)
    z_t = torch.tanh(z_t)
    o_t = torch.sigmoid(o_t)
    a = F.logsigmoid(f_t) + m                              # log f + m_{t-1}
    m_new = torch.maximum(a, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(a - m_new)
    c = f_p * c + i_p * z_t
    n = torch.clamp(f_p * n + i_p, min=1.0)
    return pre, c, n, o_t * (c / n), m_new


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM recurrence over S steps with a gradient: (hs (B, S, H, hd),
    c, n, h, m) of :func:`_slstm_step` applied in turn, from gx (B, S, 4, H,
    hd), r and the initial states.

    Forward: the same steps as the plain loop, so the same bits, run without
    autograd; it keeps every step's pre-activations and states. Backward: the
    chain rule written out, one pass from the last step to the first, with
    the derivatives that need no carried state (the gates', the stabilizer's
    and the clamp's, as torch's autograd takes them: a tie of
    ``torch.maximum`` splits the gradient in halves, the clamp passes it at
    1 and above) computed for all steps at once before the pass; the
    gradient of r and of gx in one product and one copy after it. Autograd
    through the plain loop records ~20 ops a step forward and ~70 backward,
    each at a host's per-op cost; this pass is ~28 plain ops a step."""

    @staticmethod
    def forward(ctx, gx, r, c, n, h, m):
        pres, cs, ns, hs, ms = [], [c], [n], [h], [m]
        for gx_t in gx.unbind(1):
            pre, c, n, h, m = _slstm_step(gx_t, r, c, n, h, m)
            pres.append(pre)
            cs.append(c)
            ns.append(n)
            hs.append(h)
            ms.append(m)
        ctx.save_for_backward(r, torch.stack(pres), torch.stack(cs), torch.stack(ns),
                              torch.stack(hs), torch.stack(ms))
        return torch.stack(hs[1:], dim=1), c, n, h, m

    @staticmethod
    def backward(ctx, gy, gc, gn, gh, gm):
        r, pre, cs, ns, hs, ms = ctx.saved_tensors
        S, B, _, H, hd = pre.shape
        i_all, f_all, zp, op = pre.unbind(2)               # (S, B, H, hd) each
        z = torch.tanh(zp)
        o = torch.sigmoid(op)
        a = F.logsigmoid(f_all) + ms[:-1]
        i_p = torch.exp(i_all - ms[1:])
        f_p = torch.exp(a - ms[1:])
        keep_n = (f_p * ns[:-1] + i_p >= 1.0).float()
        w_a = torch.where(a == i_all, 0.5, (a > i_all).float())
        w_i = 1.0 - w_a
        ratio = cs[1:] / ns[1:]
        dc_dh = o / ns[1:]                                 # d c_t of d h_t
        dn_dh = o * cs[1:] / (ns[1:] * ns[1:])             # -d n_t of d h_t
        df_da = torch.sigmoid(-f_all)                      # log sigmoid's derivative
        dz_dzp = 1.0 - z * z
        do_dop = o * (1.0 - o)
        zeros = torch.zeros_like(hs[0])
        dc, dn, dh, dm = (zeros if g is None else g for g in (gc, gn, gh, gm))
        dpre = torch.empty((S, B, H, 4, hd), dtype=pre.dtype, device=pre.device)
        for t in range(S - 1, -1, -1):
            g_t = dh if gy is None else dh + gy[:, t]
            do = g_t * ratio[t]
            dc = dc + g_t * dc_dh[t]
            dn = (dn - g_t * dn_dh[t]) * keep_n[t]
            df_p = dc * cs[t] + dn * ns[t]
            di_p = dc * z[t] + dn
            dz = dc * i_p[t]
            dc = dc * f_p[t]
            dn = dn * f_p[t]
            e_i = di_p * i_p[t]
            e_f = df_p * f_p[t]
            dm_new = dm - e_i - e_f
            dm = e_f + dm_new * w_a[t]                     # d a = d m_{t-1}
            torch.stack((e_i + dm_new * w_i[t], dm * df_da[t], dz * dz_dzp[t], do * do_dop[t]),
                        dim=2, out=dpre[t])
            dh = torch.einsum("bhg,hkg->bhk", dpre[t].reshape(B, H, 4 * hd), r)
        g_gx = dpre.permute(1, 0, 3, 2, 4).contiguous()     # (B, S, 4, H, hd)
        g_r = torch.einsum("sbhk,sbhg->hkg", hs[:-1], dpre.reshape(S, B, H, 4 * hd))
        return g_gx, g_r, dc, dn, dh, dm


def slstm_apply(p, cfg: ModelConfig, x, *, cache=None, mode="train"):
    """x: (B, S, d). Returns (y, new cache; None in train mode).

    The gate layout is (i, f, z, o) in both parts, but not the same axes:
    the input part is ``wx``'s columns in four d-blocks, (B, 4, H, hd); the
    recurrent part is four hd-blocks of each head's ``r`` output,
    (B, H, 4, hd)."""
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    gates_x = _mm(x, p["wx"]).float() + p["b"]              # (B, S, 4d)
    gx = gates_x.reshape(B, S, 4, H, hd)
    r = p["r"]

    if mode == "decode":
        if cache is None:
            raise ValueError("decode takes a cache")
        c, n, h, m = cache["c"], cache["n"], cache["h"], cache["m"]
    else:
        c = n = h = torch.zeros((B, H, hd), device=x.device)
        m = torch.full((B, H, hd), NEG, device=x.device)
    with torch.profiler.record_function("slstm_scan"):
        if torch.is_grad_enabled() and (gx.requires_grad or r.requires_grad):
            hs, c, n, h, m = _SLSTMScan.apply(gx, r, c, n, h, m)
        else:
            steps = []
            for gx_t in gx.unbind(1):                      # (B, 4, H, hd) a step
                _, c, n, h, m = _slstm_step(gx_t, r, c, n, h, m)
                steps.append(h)
            hs = torch.stack(steps, dim=1)
        y = hs.reshape(B, S, d).to(x.dtype)
    # the gated FFN (post-up-projection, factor 4/3)
    yn = rmsnorm(p["ffn_norm"], y, cfg.norm_eps)
    ff = _mm(yn, p["ffn"]["wi"]) * F.silu(_mm(yn, p["ffn"]["wg"]))
    out = y + _mm(ff, p["ffn"]["wo"])
    new_cache = None if mode == "train" else {"c": c, "n": n, "h": h, "m": m}
    return out, new_cache
