"""falcon-mamba-7b — pure SSM (mamba-1) 64L d=4096, attention-free,
ssm_state 16, vocab 65024.  Runs the long_500k cell (O(1)/token state).
[arXiv:2410.05355; unverified]
"""

from dataclasses import replace

from ..models.config import AttentionConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    d_ff=0,                      # attention-free, no FFN sublayer width
    vocab_size=65024,
    attention=AttentionConfig(kind="none", n_heads=0, n_kv_heads=0, head_dim=0),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, chunk=256),
    norm="rmsnorm",
    activation="silu",
    source="arXiv:2410.05355",
)

SMOKE_CONFIG = replace(
    CONFIG,
    n_layers=2, d_model=64, vocab_size=256,
    ssm=replace(CONFIG.ssm, d_state=4, chunk=8),
)
