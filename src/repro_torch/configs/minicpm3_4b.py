"""minicpm3-4b — dense 62L d=2560, 40H MLA, d_ff 6400, vocab 73448.

MLA geometry per hf:openbmb/MiniCPM3-4B: q_lora_rank 768, kv_lora_rank 256,
qk_nope_head_dim 64, qk_rope_head_dim 32, v_head_dim 64.
[hf:openbmb/MiniCPM3-4B; hf]
"""

from dataclasses import replace

from ..models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    d_ff=6400,
    vocab_size=73448,
    attention=AttentionConfig(
        kind="mla", n_heads=40, n_kv_heads=40, head_dim=64,
        q_lora_rank=768, kv_lora_rank=256,
        qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64,
        rope_theta=10_000.0,
    ),
    norm="rmsnorm",
    activation="silu",
    tie_embeddings=True,
    train_microbatches=8,   # memory: 58 GiB/dev -> fits (EXPERIMENTS §Perf)
    source="hf:openbmb/MiniCPM3-4B",
)

SMOKE_CONFIG = replace(
    CONFIG,
    n_layers=2, d_model=64, d_ff=128, vocab_size=256,
    attention=replace(CONFIG.attention, n_heads=4, n_kv_heads=4, head_dim=16,
                      q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
)
