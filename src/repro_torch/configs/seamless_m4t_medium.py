"""SeamlessM4T-medium [arXiv:2308.11596]: encoder-decoder backbone,
d_model 1024, 16 heads (MHA), d_ff 4096, vocab 256206 (exact value kept).
12 encoder + 12 decoder layers (the medium card's depths); the speech front-end
(mel+w2v-BERT conv feature extractor) is a STUB — ``input_specs`` provides
precomputed frame embeddings (B, T_frames, d_model).

Decode shapes lower the DECODER serve_step with a fixed 4096-frame encoder
memory (see DESIGN.md §long_500k policy)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        arch_type="audio",
        n_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab_size=256_206,
        act="relu",
        encoder_layers=12,
        modality="audio",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
        ce_chunk=512,
    )
