"""whisper-small — enc-dec 12L+12L d=768, 12H MHA, d_ff 3072, vocab 51865;
conv frontend STUB (input_specs feeds 1500 precomputed frame embeddings).
[arXiv:2212.04356; unverified]
"""

from dataclasses import replace

from ..models.config import (AttentionConfig, EncDecConfig, ModelConfig)

CONFIG = ModelConfig(
    arch_id="whisper-small",
    family="audio",
    n_layers=12,                  # decoder layers
    d_model=768,
    d_ff=3072,
    vocab_size=51865,
    attention=AttentionConfig(
        kind="gqa", n_heads=12, n_kv_heads=12, head_dim=64,
    ),
    enc_dec=EncDecConfig(n_encoder_layers=12, encoder_len=1500),
    norm="layernorm",
    activation="gelu",
    tie_embeddings=True,
    max_seq_len=32768,
    train_microbatches=4,   # memory: 28 GiB/dev -> fits (EXPERIMENTS §Perf)
    source="arXiv:2212.04356",
)

SMOKE_CONFIG = replace(
    CONFIG,
    n_layers=2, d_model=64, d_ff=128, vocab_size=256, max_seq_len=64,
    attention=replace(CONFIG.attention, n_heads=4, n_kv_heads=4, head_dim=16),
    enc_dec=EncDecConfig(n_encoder_layers=2, encoder_len=16),
)
