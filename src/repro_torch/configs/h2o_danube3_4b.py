"""h2o-danube-3-4b — dense 24L d=3840, 32H GQA(kv=8), d_ff 10240,
vocab 32000; llama+mistral mix with sliding-window attention (window 4096).
[arXiv:2401.16818; unverified]
"""

from dataclasses import replace

from ..models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    d_ff=10240,
    vocab_size=32000,
    attention=AttentionConfig(
        kind="gqa", n_heads=32, n_kv_heads=8, head_dim=120,
        window=4096, rope_theta=10_000.0,
    ),
    norm="rmsnorm",
    activation="silu",
    source="arXiv:2401.16818",
)

SMOKE_CONFIG = replace(
    CONFIG,
    n_layers=2, d_model=64, d_ff=128, vocab_size=256,
    attention=replace(CONFIG.attention, n_heads=4, n_kv_heads=2, head_dim=16,
                      window=16),
)
