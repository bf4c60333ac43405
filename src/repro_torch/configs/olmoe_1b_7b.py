"""olmoe-1b-7b — MoE 16L d=2048, 16H MHA, vocab 50304;
64 experts (d_expert 1024) top-8, no shared experts.
[arXiv:2409.02060; hf]
"""

from dataclasses import replace

from ..models.config import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    d_ff=1024,
    vocab_size=50304,
    attention=AttentionConfig(
        kind="gqa", n_heads=16, n_kv_heads=16, head_dim=128,
        rope_theta=10_000.0,
    ),
    moe=MoEConfig(n_experts=64, top_k=8, n_shared_experts=0, d_expert=1024,
                  capacity_factor=1.25, every=1),
    norm="rmsnorm",
    activation="silu",
    source="arXiv:2409.02060",
)

SMOKE_CONFIG = replace(
    CONFIG,
    n_layers=2, d_model=64, d_ff=32, vocab_size=256,
    attention=replace(CONFIG.attention, n_heads=4, n_kv_heads=4, head_dim=16),
    moe=replace(CONFIG.moe, n_experts=8, top_k=2, d_expert=32),
)
