"""Qwen2-72B [arXiv:2407.10671]: 80L, d_model 8192, 64 heads, GQA 8 KV heads,
SwiGLU d_ff 29568, vocab 152064, QKV bias."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        arch_type="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab_size=152_064,
        attn_bias=True,
        act="silu",
        rope_theta=1_000_000.0,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
        ce_chunk=512,
    )
