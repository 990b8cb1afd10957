"""Jamba v0.1 52B [arXiv:2403.19887]: 32L hybrid, d_model 4096, 32 heads,
GQA 8 KV heads, d_ff 14336, vocab 65536. Attention:Mamba = 1:7 (one attention
layer per 8-layer block, middle slot), MoE every other layer: 16 experts,
top-2, expert width = d_ff. Mamba: d_state 16, d_conv 4, expand 2.
long_500k runs natively (Mamba state is O(1); the 4 attention layers keep a
full KV cache, linear in context)."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        arch_type="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=65_536,
        act="silu",
        attn_period=8,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        moe=MoEConfig(
            n_experts=16,
            n_shared_experts=0,
            topk=2,
            d_ff=14336,
            every=2,
            capacity_factor=1.25,
            router_scoring="softmax",
            group_size=4096,
        ),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
        ce_chunk=512,
    )
