"""AI21-Jamba2-Mini — hybrid 32L d=4096: Mamba-1 and attention 7:1
(attention where i % 8 == 4), 32H GQA(kv=8) of 128 without positional
encoding, an expert FFN where i % 2 == 1 (16 experts of 14336, top-2, the
gates not renormalised, dropless), dense SwiGLU 14336 elsewhere, Mamba
d_state 16, d_conv 4, expand 2, dt_rank 256 with RMSNorms on dt, B and C,
vocab 65536 untied.  [hf:ai21labs/AI21-Jamba2-Mini config.json;
transformers' modeling_jamba.py; arXiv:2403.19887]

Not one of ``ARCH_IDS``: the JAX package has no such config, and the
tests hold every arch of that list to it.  ``get_config("jamba2-mini")``
loads it.
"""

from dataclasses import replace

from ..models.config import (AttentionConfig, ModelConfig, MoEConfig,
                             SSMConfig)

CONFIG = ModelConfig(
    arch_id="jamba2-mini",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    attention=AttentionConfig(
        kind="gqa", n_heads=32, n_kv_heads=8, head_dim=128, rope=False,
    ),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, dt_rank=256, chunk=256,
                  inner_norms=True),
    moe=MoEConfig(n_experts=16, top_k=2, n_shared_experts=0, d_expert=14336,
                  every=2, renormalize=False, dropless=True),
    attn_period=8,
    attn_offset=4,
    norm="rmsnorm",
    activation="silu",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    source="https://huggingface.co/ai21labs/AI21-Jamba2-Mini",
)

SMOKE_CONFIG = replace(
    CONFIG,
    d_model=64, d_ff=96, vocab_size=256,
    attention=replace(CONFIG.attention, n_heads=4, n_kv_heads=2,
                      head_dim=16),
    ssm=replace(CONFIG.ssm, d_state=4, dt_rank=8, chunk=8),
    moe=replace(CONFIG.moe, n_experts=4, d_expert=96),
    n_layers=8,
    param_dtype="float32",
    compute_dtype="float32",
)
