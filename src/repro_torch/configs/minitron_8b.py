"""Minitron-8B [arXiv:2407.14679] — width-pruned Nemotron-4 15B: 32L,
d_model 4096, 32 heads, GQA 8 KV heads, d_ff 16384, vocab 256000,
squared-ReLU MLP in the original; we use the gated-SiLU equivalent width."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        arch_type="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=256_000,
        act="relu",
        rope_theta=10_000.0,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
        ce_chunk=512,
    )
