"""deepseek-moe-16b — MoE 28L d=2048, 16H MHA, vocab 102400;
fine-grained 64 routed experts (d_expert 1408) top-6 + 2 shared experts.
[arXiv:2401.06066; hf]
"""

from dataclasses import replace

from ..models.config import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    d_ff=1408,                 # == d_expert (fine-grained experts)
    vocab_size=102400,
    attention=AttentionConfig(
        kind="gqa", n_heads=16, n_kv_heads=16, head_dim=128,
        rope_theta=10_000.0,
    ),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2, d_expert=1408,
                  capacity_factor=1.25, every=1),
    norm="rmsnorm",
    activation="silu",
    source="arXiv:2401.06066",
)

SMOKE_CONFIG = replace(
    CONFIG,
    n_layers=2, d_model=64, d_ff=48, vocab_size=256,
    attention=replace(CONFIG.attention, n_heads=4, n_kv_heads=4, head_dim=16),
    moe=replace(CONFIG.moe, n_experts=8, top_k=2, n_shared_experts=1,
                d_expert=48),
)
