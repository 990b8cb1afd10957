"""Transformer substrate assembly: plan -> segments -> stacked layers
(counterpart of ``repro/models/transformer.py``).

A ``ModelConfig`` becomes a per-layer *plan* (mixer kind + FFN kind); the
plan is grouped into *segments* (N identical layers, or a P-periodic
pattern like Jamba's [attn 1 : mamba 7]); each segment's params are stacked
on a leading repeats axis, as the reference's scanned stacks are, and its
layers run one after another. Caches thread through the same stacks.

Public entry points, as the reference's:

    model = TransformerLM(cfg, device="cuda")
    params = model.init(seed)
    loss, metrics = model.train_loss(params, {"tokens": ..., "labels": ...})
    caches, logits = model.prefill(params, batch, cache_len=...)
    logits, caches = model.decode_step(params, batch, caches)

Ported here: attention (GQA/MQA; prefill and the training forward through
the flash kernel, training's backward by the reference's flash backward),
multi-head latent attention (DeepSeek V2/V3: prefill through the flash
kernel at the qk head dim, decode in the absorbed form) and Mamba mixers,
MLP and MoE FFNs — every layer of Jamba, of DeepSeek and of the dense
archs — the xLSTM blocks (mLSTM, sLSTM: plain torch, as the reference's
plain XLA), the encoder-decoder of SeamlessM4T (the audio stub:
``batch["enc_embeds"]`` (B, T, d) frame embeddings through a bidirectional
encoder stack, whose output every decoder layer reads through
cross-attention; prefill keeps each layer's projected memory K/V as its
cross cache, so decode runs no encoder), the vision stub (Qwen2-VL:
``batch["embeds"]`` in place of tokens, (B, S, 3) M-RoPE positions), and
``train_loss``, whose cross-entropy goes through the fused CE kernel
(``ops.ce_loss_mean``). All ten reference archs build. Gradients reach every
weight: a Mamba layer's training scan goes through ``ops.SSMScan``, whose
backward is the ``ssm_scan_bwd`` kernel on the card; attention, the
encoder's and cross-attention included, through ``ops.FlashAttention``; the
MoE layer and the xLSTM blocks train as they stand (sorts, gathers, cuBLAS
products, plain recurrences).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import ce_loss_mean
from repro_torch.models import nn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (
    attention_apply,
    attention_init,
    cross_attention_apply,
    cross_attention_init,
    embed_init,
    embed_lookup,
    init_attn_cache,
    init_cross_cache,
    init_mla_cache,
    mla_apply,
    mla_init,
    mlp_apply,
    mlp_init,
    moe_apply,
    moe_init,
    rmsnorm,
    rmsnorm_init,
)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map

# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str   # attn | mla | mamba | mlstm | slstm
    ffn: str     # mlp | moe | none
    cross: bool = False  # decoder cross-attention (enc-dec)
    dense_ff: int = 0    # ff size when ffn == mlp


def layer_plan(cfg: ModelConfig, *, decoder: bool = True) -> List[LayerSpec]:
    n = cfg.n_layers if decoder else cfg.encoder_layers
    plan = []
    for i in range(n):
        if not decoder:
            plan.append(LayerSpec("attn", "mlp", dense_ff=cfg.d_ff))
            continue
        if cfg.xlstm_pattern:
            kind = cfg.xlstm_pattern[i % len(cfg.xlstm_pattern)]
            plan.append(LayerSpec("mlstm" if kind == "m" else "slstm", "none"))
            continue
        if cfg.attn_period:
            # Jamba: one attention layer per period (at the middle slot, per
            # the released model), Mamba elsewhere; MoE every other layer.
            mixer = "attn" if i % cfg.attn_period == cfg.attn_period // 2 else "mamba"
        elif cfg.mla is not None:
            mixer = "mla"
        else:
            mixer = "attn"
        if cfg.moe is not None:
            mo = cfg.moe
            if i < mo.first_dense:
                # DeepSeek-style leading dense layers use a wider dense FFN.
                ffn, dff = "mlp", (_dense_ff(cfg) if cfg.arch_type == "moe" else cfg.d_ff)
            elif mo.every > 1 and i % mo.every != 1:
                # Jamba: MoE every other layer, plain MLP elsewhere.
                ffn, dff = "mlp", cfg.d_ff
            else:
                ffn, dff = "moe", 0
        else:
            ffn, dff = "mlp", cfg.d_ff
        plan.append(LayerSpec(mixer, ffn, cross=cfg.encoder_layers > 0, dense_ff=dff))
    return plan


def _dense_ff(cfg: ModelConfig) -> int:
    """Dense-layer FFN width for MoE archs' leading dense layers."""
    mo = cfg.moe
    return mo.d_ff * (mo.topk + mo.n_shared_experts)


@dataclasses.dataclass
class Segment:
    specs: Tuple[LayerSpec, ...]  # one period of the pattern
    repeats: int


def segment_plan(plan: List[LayerSpec]) -> List[Segment]:
    """Split the plan into stackable segments (see module docstring)."""
    if not plan:
        return []
    n = len(plan)
    # whole-plan periodicity (only useful when it yields >1 repeat)
    for P in range(1, n // 2 + 1):
        if n % P:
            continue
        if all(plan[i] == plan[i % P] for i in range(n)):
            return [Segment(tuple(plan[:P]), n // P)]
    # strip the longest identical prefix, recurse
    j = 1
    while j < n and plan[j] == plan[0]:
        j += 1
    return [Segment((plan[0],), j)] + segment_plan(plan[j:])


# ---------------------------------------------------------------------------
# Per-layer init / cache / apply
# ---------------------------------------------------------------------------


def _sublayer_init(gen, spec: LayerSpec, cfg: ModelConfig, dtype, device, lead):
    p: Dict[str, Any] = {"norm1": rmsnorm_init(cfg.d_model, dtype, device, lead)}
    if spec.mixer == "attn":
        p["mixer"] = attention_init(gen, cfg, dtype, device, lead)
    elif spec.mixer == "mla":
        p["mixer"] = mla_init(gen, cfg, dtype, device, lead)
    elif spec.mixer == "mamba":
        p["mixer"] = ssm_mod.mamba_init(gen, cfg, dtype, device, lead)
    elif spec.mixer == "mlstm":
        p["mixer"] = xlstm_mod.mlstm_init(gen, cfg, dtype, device, lead)
    elif spec.mixer == "slstm":
        p["mixer"] = xlstm_mod.slstm_init(gen, cfg, dtype, device, lead)
    else:
        raise ValueError(spec.mixer)
    if spec.cross:
        p["cross_norm"] = rmsnorm_init(cfg.d_model, dtype, device, lead)
        p["cross"] = cross_attention_init(gen, cfg, dtype, device, lead)
    if spec.ffn == "mlp":
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, device, lead)
        p["ffn"] = mlp_init(gen, cfg.d_model, spec.dense_ff, dtype, device,
                            gated=cfg.act != "relu", lead=lead)
    elif spec.ffn == "moe":
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, device, lead)
        p["ffn"] = moe_init(gen, cfg, dtype, device, lead)
    return p


def _sublayer_cache(spec: LayerSpec, cfg: ModelConfig, batch, cache_len, window, dtype,
                    device, lead, memory_len=0):
    eff_len = min(cache_len, window) if window else cache_len
    if spec.mixer == "attn":
        c = {"mixer": init_attn_cache(cfg, batch, eff_len, dtype, device, lead)}
    elif spec.mixer == "mla":
        c = {"mixer": init_mla_cache(cfg, batch, eff_len, dtype, device, lead)}
    elif spec.mixer == "mamba":
        c = {"mixer": ssm_mod.init_mamba_cache(cfg, batch, dtype, device, lead)}
    elif spec.mixer == "mlstm":
        c = {"mixer": xlstm_mod.init_mlstm_cache(cfg, batch, dtype, device, lead)}
    else:
        c = {"mixer": xlstm_mod.init_slstm_cache(cfg, batch, dtype, device, lead)}
    if spec.cross:
        c["cross"] = init_cross_cache(cfg, batch, memory_len, dtype, device, lead)
    return c


def _sublayer_apply(p, spec: LayerSpec, cfg: ModelConfig, x, *, positions, cache, mode,
                    window, memory):
    new_cache: Dict[str, Any] = {}
    aux = 0.0
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    mixer_cache = None if cache is None else cache["mixer"]
    if spec.mixer == "attn":
        out, mc, _ = attention_apply(p["mixer"], cfg, h, positions=positions,
                                     cache=mixer_cache, mode=mode, window=window)
    elif spec.mixer == "mla":
        out, mc, _ = mla_apply(p["mixer"], cfg, h, positions=positions,
                               cache=mixer_cache, mode=mode, window=window)
    elif spec.mixer == "mamba":
        out, mc = ssm_mod.mamba_apply(p["mixer"], cfg, h, cache=mixer_cache, mode=mode)
    elif spec.mixer == "mlstm":
        out, mc = xlstm_mod.mlstm_apply(p["mixer"], cfg, h, cache=mixer_cache, mode=mode)
    else:
        out, mc = xlstm_mod.slstm_apply(p["mixer"], cfg, h, cache=mixer_cache, mode=mode)
    if mc is not None:
        new_cache["mixer"] = mc
    x = x + out
    if spec.cross:
        h = rmsnorm(p["cross_norm"], x, cfg.norm_eps)
        out, cc, _ = cross_attention_apply(p["cross"], cfg, h, memory,
                                           cache=None if cache is None else cache.get("cross"),
                                           mode=mode)
        if cc is not None:
            new_cache["cross"] = cc
        x = x + out
    if spec.ffn == "mlp":
        h = rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + mlp_apply(p["ffn"], h, cfg.act)
    elif spec.ffn == "moe":
        h = rmsnorm(p["norm2"], x, cfg.norm_eps)
        out, moe_aux = moe_apply(p["ffn"], cfg, h, cfg.act)
        aux = aux + moe_aux
        x = x + out
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------


def _stack_init(gen, segments: List[Segment], cfg: ModelConfig, dtype, device):
    """One tree per segment, each leaf stacked over the segment's repeats."""
    return [
        {f"sub{j}": _sublayer_init(gen, spec, cfg, dtype, device, (seg.repeats,))
         for j, spec in enumerate(seg.specs)}
        for seg in segments
    ]


def _stack_cache(segments, cfg, batch, cache_len, window, dtype, device, memory_len=0):
    return [
        {f"sub{j}": _sublayer_cache(spec, cfg, batch, cache_len, window, dtype, device,
                                    (seg.repeats,), memory_len)
         for j, spec in enumerate(seg.specs)}
        for seg in segments
    ]


def _repeat_apply(p_rep, c_subs, specs, cfg: ModelConfig, x, positions, mode, window,
                  memory):
    """One repeat of a segment: its layers in order, ``c_subs`` holding each
    layer's cache (or None). Returns (x, the repeat's new caches, its aux
    loss)."""
    nc_rep = {}
    aux = 0.0
    for j, spec in enumerate(specs):
        x, nc, a = _sublayer_apply(p_rep[f"sub{j}"], spec, cfg, x, positions=positions,
                                   cache=c_subs[j], mode=mode, window=window, memory=memory)
        nc_rep[f"sub{j}"] = nc
        aux = aux + a
    return x, nc_rep, aux


def _stack_apply(stack_params, segments: List[Segment], cfg: ModelConfig, x, *, positions,
                 caches, mode, window, memory=None):
    """Each segment's repeats in order, each repeat's layers in order (the
    reference's scan over a segment, unrolled); new caches are stacked back
    on the repeats axis. ``memory`` is the encoder's output that the
    decoder's cross-attention reads (None without an encoder, and in
    decode, where the cross caches hold its K/V). Under ``cfg.remat``, with
    grad mode on, each repeat runs inside ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint(body)``), the memory among its arguments:
    its activations are dropped after the forward and recomputed in the
    backward."""
    new_caches = []
    aux_total = 0.0
    remat = cfg.remat and torch.is_grad_enabled()
    for si, seg in enumerate(segments):
        p_seg = stack_params[si]
        c_seg = None if caches is None else caches[si]
        ncs = []
        for r in range(seg.repeats):
            p_rep = tree_map(lambda a: a[r], p_seg)
            c_subs = ([None] * len(seg.specs) if c_seg is None else
                      [tree_map(lambda a: a[r], c_seg[f"sub{j}"]) for j in range(len(seg.specs))])
            args = (p_rep, c_subs, seg.specs, cfg, x, positions, mode, window, memory)
            if remat:
                x, nc_rep, a = torch.utils.checkpoint.checkpoint(
                    _repeat_apply, *args, use_reentrant=False)
            else:
                x, nc_rep, a = _repeat_apply(*args)
            aux_total = aux_total + a
            ncs.append(nc_rep)
        if any(tree_leaves(n) for n in ncs):
            new_caches.append(tree_map(lambda *xs: torch.stack(xs), *ncs))
        else:
            new_caches.append({})
    return x, new_caches, aux_total


# ---------------------------------------------------------------------------
# Chunked cross-entropy
# ---------------------------------------------------------------------------


def chunked_cross_entropy(hidden, head_w, labels, chunk: int):
    """Mean next-token CE over sequence chunks of ``chunk`` (all at once for
    0), each chunk's logits computed in the params' dtype and taken to fp32,
    as the reference's. This is the plain oracle; ``train_loss`` computes the
    same function through ``ops.ce_loss_mean``."""
    B, S, _ = hidden.shape
    step = S if chunk <= 0 else chunk
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, step):
        logits = (hidden[:, s0:s0 + step] @ head_w).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, s0:s0 + step, None].long())[..., 0]
        tot = tot + (logz - gold).sum()
    return tot / (B * S)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class TransformerLM:
    """The LM substrate on ``device`` (default ``"cuda"``; raises without a
    card). ``param_shapes()`` states the params' shapes and dtypes on the
    ``meta`` device without allocating them."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.plan = layer_plan(cfg, decoder=True)
        self.segments = segment_plan(self.plan)
        self.enc_plan = layer_plan(cfg, decoder=False)
        self.enc_segments = segment_plan(self.enc_plan)
        self.dtype = getattr(torch, cfg.param_dtype)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)

    # -- init ---------------------------------------------------------------
    def _init_on(self, gen, device):
        cfg = self.cfg
        params = {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, self.dtype, device),
            "layers": _stack_init(gen, self.segments, cfg, self.dtype, device),
            "final_norm": rmsnorm_init(cfg.d_model, self.dtype, device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = nn.normal_init(
                gen, (cfg.d_model, cfg.vocab_size), 0.02, device, self.dtype)
        if self.enc_segments:
            params["encoder"] = {
                "layers": _stack_init(gen, self.enc_segments, cfg, self.dtype, device),
                "final_norm": rmsnorm_init(cfg.d_model, self.dtype, device),
            }
        return params

    def init(self, seed: int):
        """Params drawn from ``seed`` by a ``torch.Generator`` on the model's
        device, so they never pass through the host."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return self._init_on(gen, self.device)

    def param_shapes(self):
        return self._init_on(None, torch.device("meta"))

    # -- helpers ------------------------------------------------------------
    def _head(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"]["table"].T
        return params["lm_head"]

    def _embed_in(self, params, batch):
        """Token embeddings in the compute dtype; for the vision stub (or any
        batch that brings them) ``batch["embeds"]`` (B, S, d), already
        projected, taken in the params' dtype as the reference takes them.
        The reference's ``embed_onehot`` (a one-hot matmul that avoids
        gathering from a vocab-sharded table) gives the same rows: the port
        always gathers."""
        cfg = self.cfg
        if cfg.modality == "vision" or "embeds" in batch:
            x = batch["embeds"].to(self.dtype)
        else:
            x = embed_lookup(params["embed"], batch["tokens"])
        if cfg.tie_embeddings:
            x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
        return x.to(self.compute_dtype)

    def _positions(self, batch, S, offset=0):
        if "positions" in batch:
            return batch["positions"]
        x = batch["tokens"] if "tokens" in batch else batch["embeds"]
        B = x.shape[0]
        pos = offset + torch.arange(S, device=x.device)
        return pos[None, :].expand(B, S)

    def _encode(self, params, batch):
        """The audio stub's encoder: ``batch["enc_embeds"]`` (B, T, d) frame
        embeddings in the compute dtype at positions 0..T-1 through the
        encoder stack, bidirectional (``mode="encode"``, no sliding window),
        then the encoder's final norm: the memory (B, T, d)."""
        cfg = self.cfg
        x = batch["enc_embeds"].to(self.compute_dtype)
        B, T, _ = x.shape
        pos = torch.arange(T, device=x.device)[None, :].expand(B, T)
        x, _, _ = _stack_apply(
            params["encoder"]["layers"], self.enc_segments,
            dataclasses.replace(cfg, sliding_window=0), x, positions=pos, caches=None,
            mode="encode", window=0)
        return rmsnorm(params["encoder"]["final_norm"], x, cfg.norm_eps)

    # -- forward ------------------------------------------------------------
    def forward(self, params, batch, *, mode, caches=None, window=0):
        """(final hidden (B, S, d), new caches, aux loss). With an encoder the
        batch brings ``enc_embeds``, encoded in every mode but decode, whose
        cross caches hold the memory's K/V already."""
        x = self._embed_in(params, batch)
        B, S, _ = x.shape
        positions = self._positions(batch, S, batch.get("pos_offset", 0))
        memory = (self._encode(params, batch) if self.enc_segments and mode != "decode"
                  else None)
        x, new_caches, aux = _stack_apply(
            params["layers"], self.segments, self.cfg, x, positions=positions,
            caches=caches, mode=mode, window=window, memory=memory)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return x, new_caches, aux

    # -- entry points -------------------------------------------------------
    def train_loss(self, params, batch):
        """Mean next-token CE of ``batch["labels"]`` (B, S) plus the MoE
        aux loss: (loss, {"ce", "aux"}). The CE goes through
        ``ops.ce_loss_mean`` (the fused CE kernel on the card), which
        computes what ``chunked_cross_entropy`` computes; ``cfg.ce_chunk``
        chunks its backward."""
        cfg = self.cfg
        hidden, _, aux = self.forward(params, batch, mode="train", window=cfg.sliding_window)
        ce = ce_loss_mean(hidden, self._head(params), batch["labels"], chunk=cfg.ce_chunk)
        return ce + aux, {"ce": ce, "aux": aux}

    def loss(self, params, batch):
        """(loss, aux-dict) for a ``{"tokens", "labels"}`` dict or a
        ``(tokens, labels)`` tuple."""
        if isinstance(batch, tuple):
            batch = {"tokens": batch[0], "labels": batch[1]}
        return self.train_loss(params, batch)

    def init_caches(self, batch_size, cache_len, *, window=0, memory_len=0):
        """Zeroed caches of ``cache_len`` slots; the cross caches (an
        encoder-decoder's) of ``memory_len`` frames."""
        return _stack_cache(self.segments, self.cfg, batch_size, cache_len, window,
                            self.dtype, self.device, memory_len)

    def prefill(self, params, batch, *, cache_len=0, window=0):
        """Run the prompt through the stack, writing K/V (and recurrent
        states) into preallocated caches of ``cache_len`` slots (default: the
        prompt length; rolling when sliding-window is on). Returns (caches,
        logits (B, 1, V) fp32 of the last position). The prompt is
        ``batch["tokens"]`` (B, S), or ``batch["embeds"]`` (B, S, d) with
        ``batch["positions"]`` for the vision stub; the audio stub adds
        ``batch["enc_embeds"]`` (B, T, d), whose T frames size the cross
        caches."""
        x = batch["tokens"] if "tokens" in batch else batch["embeds"]
        B, S = x.shape[0], x.shape[1]
        memory_len = batch["enc_embeds"].shape[1] if "enc_embeds" in batch else 0
        caches = self.init_caches(B, cache_len or S, window=window, memory_len=memory_len)
        hidden, caches, _ = self.forward(params, batch, mode="prefill", caches=caches,
                                         window=window)
        logits = (hidden[:, -1:] @ self._head(params)).float()
        return caches, logits

    def decode_step(self, params, batch, caches, *, window=0):
        """batch: {'tokens': (B, 1)} or {'embeds': (B, 1, d)}, plus optional
        'positions'/'pos_offset'; an encoder-decoder takes no ``enc_embeds``
        (its cross caches hold the memory's K/V).
        Returns (logits (B, 1, V) fp32, new caches)."""
        hidden, new_caches, _ = self.forward(params, batch, mode="decode", caches=caches,
                                             window=window)
        logits = (hidden @ self._head(params)).float()
        return logits, new_caches


# ---------------------------------------------------------------------------
# Analytic parameter counts
# ---------------------------------------------------------------------------


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count from shapes on the ``meta`` device (nothing is
    allocated). ``active_only`` counts only topk + shared experts per MoE
    layer."""
    model = TransformerLM(cfg, device="meta")
    total = sum(int(np.prod(leaf.shape)) for leaf in tree_leaves(model.param_shapes()))
    if not active_only or cfg.moe is None:
        return total
    mo = cfg.moe
    per_expert = 3 * cfg.d_model * mo.d_ff  # wi, wg, wo
    n_moe_layers = sum(1 for s in layer_plan(cfg) if s.ffn == "moe")
    inactive = (mo.n_experts - mo.topk) * per_expert * n_moe_layers
    return total - inactive
