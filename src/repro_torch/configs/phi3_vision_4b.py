"""phi-3-vision-4.2b — VLM: phi3-mini backbone 32L d=3072, 32H MHA,
d_ff 8192, vocab 32064 + CLIP frontend (STUB: input_specs feeds precomputed
patch embeddings; n_patches positions are prepended to the text sequence).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]
"""

from dataclasses import replace

from ..models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    d_ff=8192,
    vocab_size=32064,
    attention=AttentionConfig(
        kind="gqa", n_heads=32, n_kv_heads=32, head_dim=96,
        rope_theta=10_000.0,
    ),
    norm="rmsnorm",
    activation="silu",
    n_patches=256,          # precomputed patch embeddings (stub frontend)
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)

SMOKE_CONFIG = replace(
    CONFIG,
    n_layers=2, d_model=64, d_ff=128, vocab_size=256, n_patches=8,
    attention=replace(CONFIG.attention, n_heads=4, n_kv_heads=4, head_dim=16),
)
