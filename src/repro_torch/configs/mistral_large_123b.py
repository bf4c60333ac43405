"""mistral-large-123b — dense 88L d=12288, 96H GQA(kv=8), d_ff 28672,
vocab 32768.  The FSDP stress architecture of the pool.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]
"""

from dataclasses import replace

from ..models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    d_ff=28672,
    vocab_size=32768,
    attention=AttentionConfig(
        kind="gqa", n_heads=96, n_kv_heads=8, head_dim=128,
        rope_theta=1_000_000.0,
    ),
    norm="rmsnorm",
    activation="silu",
    train_microbatches=8,   # grad-accumulation: 256 -> 8 x 32 (memory knob)
    param_dtype="bfloat16", # bf16 master + f32 adam moments (§Perf iter 4)
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)

SMOKE_CONFIG = replace(
    CONFIG,
    n_layers=2, d_model=64, d_ff=160, vocab_size=256,
    attention=replace(CONFIG.attention, n_heads=8, n_kv_heads=2, head_dim=8),
)
