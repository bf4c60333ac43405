"""jamba-v0.1-52b — hybrid 32L d=4096: Mamba:attention 7:1 interleave
(1 attention layer per 8, offset 3 as in the release), 32H GQA(kv=8)
d_ff 14336, MoE 16 experts top-2 on every other layer, vocab 65536.
[arXiv:2403.19887; hf]
"""

from dataclasses import replace

from ..models.config import (AttentionConfig, ModelConfig, MoEConfig,
                             SSMConfig)

CONFIG = ModelConfig(
    arch_id="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    attention=AttentionConfig(
        kind="gqa", n_heads=32, n_kv_heads=8, head_dim=128,
        rope_theta=10_000.0,
    ),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, chunk=256),
    moe=MoEConfig(n_experts=16, top_k=2, n_shared_experts=0, d_expert=14336,
                  capacity_factor=1.25, every=2),
    attn_period=8,
    attn_offset=3,
    train_microbatches=8,   # memory: 66 GiB/dev -> fits (EXPERIMENTS §Perf)
    norm="rmsnorm",
    activation="silu",
    source="arXiv:2403.19887",
)

SMOKE_CONFIG = replace(
    CONFIG,
    n_layers=8, d_model=64, d_ff=96, vocab_size=256,
    attention=replace(CONFIG.attention, n_heads=4, n_kv_heads=2, head_dim=16),
    ssm=replace(CONFIG.ssm, d_state=4, chunk=8),
    moe=replace(CONFIG.moe, n_experts=4, top_k=2, d_expert=96),
)
