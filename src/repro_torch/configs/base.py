"""Model / run configuration schema for the transformer substrate.

One ``ModelConfig`` instance fully describes any of the assigned
architectures (dense / MoE / SSM / hybrid / VLM / audio). Every config file
in this package cites its source model card / paper.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective SSM hyper-parameters (defaults per arXiv:2312.00752
    as used by Jamba, arXiv:2403.19887)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek Multi-head Latent Attention (arXiv:2405.04434 / 2412.19437)."""

    q_lora_rank: int = 0  # 0 -> full-rank q projection (v2-lite)
    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    n_shared_experts: int = 0
    topk: int = 2
    d_ff: int = 0                 # per-expert hidden size
    every: int = 1                # MoE FFN every `every` layers (jamba: 2)
    first_dense: int = 0          # leading dense layers (deepseek v3: 3)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_scoring: str = "softmax"   # softmax (v2) | sigmoid (v3)
    group_size: int = 4096        # token group for sort-based dispatch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # attention
    attn_bias: bool = False        # qwen2: bias on QKV only
    sliding_window: int = 0        # 0 = full attention
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    attn_q_chunk: int = 1024       # blocked-attention tile sizes
    attn_k_chunk: int = 1024

    # mlp
    act: str = "silu"              # silu (SwiGLU) | gelu (GeGLU) | relu

    # subsystem configs (None when unused)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # hybrid (jamba): one attention layer every `attn_period` layers
    attn_period: int = 0
    # xlstm: block pattern, e.g. "mmmsmmmm" (m = mLSTM, s = sLSTM)
    xlstm_pattern: Optional[str] = None

    # encoder-decoder (audio): n_layers = decoder layers
    encoder_layers: int = 0
    # modality stub: inputs are precomputed embeddings, not token ids
    modality: Optional[str] = None  # None | "vision" | "audio"

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    qk_norm: bool = False

    # numerics / memory policy
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    optimizer_dtype: str = "float32"   # adam moments dtype (bf16 = beyond-paper)
    remat: bool = False
    ce_chunk: int = 0              # sequence-chunked cross entropy (0 = off)
    scan_layers: bool = True       # lax.scan over layer stacks

    # long-context override applied for the long_500k shape (see DESIGN.md)
    long_context_window: int = 8192

    # --- perf levers (hillclimbs; see EXPERIMENTS.md §Perf) ---
    # decode-time embedding lookup as one-hot matmul (collective-free under a
    # vocab-sharded table, vs the gather's table all-gather fallback)
    embed_onehot: bool = False
    # for head-gated archs (heads % tp != 0): reshard the attention batch
    # over (data, model) so the model axis contributes batch parallelism to
    # attention instead of computing 16x-replicated
    shard_attn_batch_over_model: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline's
        MODEL_FLOPS = 6*N*D and for sanity tests."""
        from repro_torch.models.transformer import count_params_analytic

        return count_params_analytic(self)

    def n_active_params(self) -> int:
        from repro_torch.models.transformer import count_params_analytic

        return count_params_analytic(self, active_only=True)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced variant of the same family for CPU smoke tests: 2 layers,
    d_model<=512, <=4 experts, small vocab."""
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    head_dim = min(cfg.resolved_head_dim, 64)
    changes = dict(
        n_layers=2 if not cfg.attn_period else cfg.attn_period,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        encoder_layers=2 if cfg.encoder_layers else 0,
        attn_q_chunk=64,
        attn_k_chunk=64,
        ce_chunk=0,
        remat=False,
        param_dtype="float32",
        compute_dtype="float32",
        scan_layers=cfg.scan_layers,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=min(cfg.moe.n_experts, 4),
            topk=min(cfg.moe.topk, 2),
            d_ff=min(cfg.moe.d_ff, 256) if cfg.moe.d_ff else 0,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            first_dense=min(cfg.moe.first_dense, 1),
            group_size=64,
        )
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(
            q_lora_rank=64 if cfg.mla.q_lora_rank else 0,
            kv_lora_rank=32,
            qk_rope_dim=16,
            qk_nope_dim=32,
            v_head_dim=32,
        )
    if cfg.mrope_sections is not None:
        # Rescale the M-RoPE sections to the reduced head_dim (ratios kept).
        half = head_dim // 2
        t = half // 2
        hw = (half - t) // 2
        changes["mrope_sections"] = (half - 2 * hw, hw, hw)
    if cfg.xlstm_pattern:
        changes["n_layers"] = len(_min_pattern(cfg.xlstm_pattern))
        changes["xlstm_pattern"] = _min_pattern(cfg.xlstm_pattern)
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)


def _min_pattern(pattern: str) -> str:
    """Smallest pattern containing every block type present."""
    kinds = sorted(set(pattern), key=pattern.index)
    return "".join(kinds)
