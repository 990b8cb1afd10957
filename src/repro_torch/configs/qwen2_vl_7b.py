"""Qwen2-VL-7B [arXiv:2409.12191]: 28L, d_model 3584, 28 heads, GQA 4 KV
heads, SwiGLU d_ff 18944, vocab 152064, QKV bias, M-RoPE (16/24/24 sections).

VLM carve-out (see DESIGN.md): the ViT encoder + patch-merger projector are a
STUB — ``input_specs`` feeds precomputed, already-projected patch+text
embeddings (B, S, d_model) and 3-D M-RoPE position ids (B, S, 3)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        arch_type="vlm",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab_size=152_064,
        attn_bias=True,
        act="silu",
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),
        modality="vision",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
        ce_chunk=512,
    )
