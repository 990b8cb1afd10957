"""Gemma 7B [arXiv:2403.08295]: 28L, d_model 3072, 16 heads / 16 KV heads
(MHA; MQA is only on the 2B), head_dim 256, GeGLU d_ff 24576, vocab 256000,
tied embeddings."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        arch_type="dense",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256_000,
        act="gelu",
        rope_theta=10_000.0,
        tie_embeddings=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
        ce_chunk=512,
    )
