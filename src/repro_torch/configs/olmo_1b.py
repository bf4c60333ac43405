"""olmo-1b — dense 16L d=2048, 16H MHA, d_ff 8192, vocab 50304;
non-parametric LayerNorm (no scale/bias, arXiv:2402.00838).
[arXiv:2402.00838; hf]
"""

from dataclasses import replace

from ..models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    d_ff=8192,
    vocab_size=50304,
    attention=AttentionConfig(
        kind="gqa", n_heads=16, n_kv_heads=16, head_dim=128,
        rope_theta=10_000.0,
    ),
    norm="nonparametric_ln",
    activation="silu",
    tie_embeddings=True,
    source="arXiv:2402.00838",
)

SMOKE_CONFIG = replace(
    CONFIG,
    n_layers=2, d_model=64, d_ff=128, vocab_size=256,
    attention=replace(CONFIG.attention, n_heads=4, n_kv_heads=4, head_dim=16),
)
