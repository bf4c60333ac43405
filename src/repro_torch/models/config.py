"""Unified model-config schema covering all 10 assigned architectures.

One dataclass drives model construction, sharding rules, input specs, the
ACADL workload extraction and the dry-run.  Per-family extras live in
optional sub-configs (attention / MoE / SSM / enc-dec / modality stubs).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Literal, Optional, Tuple

__all__ = ["AttentionConfig", "MoEConfig", "SSMConfig", "EncDecConfig",
           "ModelConfig", "LayerKind", "SHAPES", "ShapeConfig"]

LayerKind = Literal["attn", "mamba"]


@dataclass(frozen=True)
class AttentionConfig:
    kind: Literal["gqa", "mla", "none"] = "gqa"
    n_heads: int = 16
    n_kv_heads: int = 16
    head_dim: int = 128
    window: int = 0                      # >0: sliding-window attention (SWA)
    rope_theta: float = 10_000.0
    # --- MLA (multi-head latent attention, MiniCPM3 / DeepSeek-V2 style) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    @property
    def qk_head_dim(self) -> int:
        if self.kind == "mla":
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        return self.head_dim


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0            # DeepSeekMoE shared experts
    d_expert: int = 0                    # per-expert FFN width
    capacity_factor: float = 1.25
    every: int = 1                       # MoE layer period (jamba: 2)
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                     # 0 -> ceil(d_model / 16)
    chunk: int = 256                     # scan chunk (memory/remat knob)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def dt_rank_of(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


@dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 12
    encoder_len: int = 1500              # whisper: 30 s of 10 ms frames / 2


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: AttentionConfig = AttentionConfig()
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    enc_dec: Optional[EncDecConfig] = None
    norm: Literal["rmsnorm", "layernorm", "nonparametric_ln"] = "rmsnorm"
    activation: Literal["silu", "gelu"] = "silu"
    tie_embeddings: bool = False
    # hybrid (jamba): attention every `attn_period` layers, offset `attn_offset`
    attn_period: int = 1
    attn_offset: int = 0
    # modality stubs
    n_patches: int = 0                   # vlm: precomputed patch embeddings
    # implementation selection
    attention_impl: str = "chunked"   # chunked | dense | flash_pallas[_interpret]
    ssm_impl: str = "chunked_scan"    # chunked_scan | pallas[_interpret]
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # hierarchical remat: save the residual stream every `remat_group`
    # pattern-period repeats; backward recomputes the group (memory knob for
    # deep/wide stacks — mistral-large's 88 x (B,S,d) carries)
    remat_group: int = 1
    # gradient-accumulation microbatches in train_step (memory knob: all
    # activation-linked buffers scale with B/microbatches)
    train_microbatches: int = 1
    # max positions for caches
    max_seq_len: int = 1 << 20
    # notes for DESIGN/EXPERIMENTS bookkeeping
    source: str = ""

    # ---- derived ---------------------------------------------------------------
    def layer_kinds(self) -> List[LayerKind]:
        """Per-layer block kind (jamba's 1:7 attention:mamba interleave)."""
        if self.family == "ssm":
            return ["mamba"] * self.n_layers
        if self.family == "hybrid":
            return ["attn" if (i % self.attn_period) == self.attn_offset
                    else "mamba" for i in range(self.n_layers)]
        return ["attn"] * self.n_layers

    def moe_layers(self) -> List[bool]:
        if self.moe is None:
            return [False] * self.n_layers
        return [(i % self.moe.every) == (self.moe.every - 1) or self.moe.every == 1
                for i in range(self.n_layers)]

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6·N·D."""
        a = self.attention
        d = self.d_model
        n = 0
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        kinds = self.layer_kinds()
        moe_flags = self.moe_layers()
        for kind, is_moe in zip(kinds, moe_flags):
            if kind == "attn":
                if a.kind == "mla":
                    qk = a.qk_nope_head_dim + a.qk_rope_head_dim
                    n += d * a.q_lora_rank + a.q_lora_rank * a.n_heads * qk
                    n += d * (a.kv_lora_rank + a.qk_rope_head_dim)
                    n += a.kv_lora_rank * a.n_heads * (a.qk_nope_head_dim + a.v_head_dim)
                    n += a.n_heads * a.v_head_dim * d
                else:
                    n += d * a.n_heads * a.head_dim            # q
                    n += 2 * d * a.n_kv_heads * a.head_dim     # k, v
                    n += a.n_heads * a.head_dim * d            # o
            else:  # mamba
                s = self.ssm
                di = s.d_inner(d)
                n += d * 2 * di                                 # in_proj
                n += di * s.d_conv                              # conv
                n += di * (s.dt_rank_of(d) + 2 * s.d_state)     # x_proj
                n += s.dt_rank_of(d) * di + di                  # dt_proj
                n += di * s.d_state + di                        # A_log, D
                n += di * d                                     # out_proj
            if is_moe and self.moe is not None:
                m = self.moe
                n += d * m.n_experts                            # router
                n += m.n_experts * 3 * d * m.d_expert           # routed
                n += m.n_shared_experts * 3 * d * m.d_expert    # shared
            else:
                # gated (SwiGLU): gate/up/down; non-gated (gelu): up/down
                n += (3 if self.activation == "silu" else 2) * d * self.d_ff
        if self.enc_dec is not None:
            e = self.enc_dec
            # decoder blocks counted above; add encoder stack + cross-attn
            mlp_mats = 3 if self.activation == "silu" else 2
            per_enc = 4 * d * a.n_heads * a.head_dim + mlp_mats * d * self.d_ff
            n += e.n_encoder_layers * per_enc
            n += self.n_layers * 4 * d * a.n_heads * a.head_dim  # cross-attn
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        total = self.n_params()
        routed_all = sum(m.n_experts * 3 * self.d_model * m.d_expert
                         for f in self.moe_layers() if f)
        routed_active = sum(m.top_k * 3 * self.d_model * m.d_expert
                            for f in self.moe_layers() if f)
        return total - routed_all + routed_active


# ---------------------------------------------------------------------------
# assigned input shapes (the 4 cells per architecture)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
