"""DeepSeek-V3 671B [arXiv:2412.19437]: 61L, d_model 7168, 128 heads, MLA
(kv_lora 512, q_lora 1536, rope 64, nope 128, v 128), vocab 129280.
MoE: 1 shared + 256 routed experts, top-8, expert d_ff 2048, sigmoid scoring,
first 3 layers dense (wide FFN). MTP head is implemented as an optional extra
in the launcher (single extra depth-1 predictor), not part of the backbone.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        arch_type="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=2048,          # per-expert width (assignment); dense layers 9x
        vocab_size=129_280,
        act="silu",
        rope_theta=10_000.0,
        moe=MoEConfig(
            n_experts=256,
            n_shared_experts=1,
            topk=8,
            d_ff=2048,
            first_dense=3,
            capacity_factor=1.25,
            router_scoring="sigmoid",
            group_size=4096,
        ),
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_rope_dim=64,
            qk_nope_dim=128,
            v_head_dim=128,
        ),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        optimizer_dtype="bfloat16",  # memory-roofline necessity at this scale
        remat=True,
        ce_chunk=512,
    )
