"""Gemma 2B [arXiv:2403.08295]: 18L, d_model 2048, 8 heads, MQA (1 KV head),
head_dim 256, GeGLU d_ff 16384, vocab 256000, tied embeddings."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        arch_type="dense",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256_000,
        act="gelu",
        rope_theta=10_000.0,
        tie_embeddings=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
        ce_chunk=512,
    )
