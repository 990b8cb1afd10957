"""xLSTM 350M [arXiv:2405.04517]: 24 blocks, d_model 1024, 4 heads, vocab
50304, d_ff 0 (no separate FFN blocks — mLSTM blocks carry a 2x
pre-up-projection, sLSTM blocks a 4/3 gated FFN, per the paper). Block
pattern xLSTM[7:1]: one sLSTM per 8 blocks. Fully recurrent -> long_500k
runs natively with O(1) state."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        arch_type="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50_304,
        xlstm_pattern="mmmsmmmm",
        tie_embeddings=False,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        ce_chunk=512,
    )
