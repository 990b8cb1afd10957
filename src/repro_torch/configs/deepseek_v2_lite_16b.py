"""DeepSeek-V2-Lite 16B [arXiv:2405.04434]: 27L, d_model 2048, 16 heads, MLA
(kv_lora 512, no q-lora on Lite, rope 64, nope 128, v 128), vocab 102400.
MoE: 2 shared + 64 routed experts, top-6, expert d_ff 1408, softmax scoring,
first layer dense. (The assignment note "160 routed" matches V2-236B, not
Lite; we follow the header's 64e as the Lite model card specifies.)"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        arch_type="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=102_400,
        act="silu",
        rope_theta=10_000.0,
        moe=MoEConfig(
            n_experts=64,
            n_shared_experts=2,
            topk=6,
            d_ff=1408,
            first_dense=1,
            capacity_factor=1.25,
            router_scoring="softmax",
            group_size=4096,
        ),
        mla=MLAConfig(
            q_lora_rank=0,
            kv_lora_rank=512,
            qk_rope_dim=64,
            qk_nope_dim=128,
            v_head_dim=128,
        ),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
        ce_chunk=512,
    )
