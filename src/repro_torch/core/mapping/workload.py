"""Workload extraction: model configs -> ACADL operator streams (paper §5).

Every architecture config doubles as an ACADL *workload*: one train or
serve step decomposes into a stream of fused-tensor operators
(GEMM / attention / scan tiles) that maps onto any modeled accelerator via
the UMA-style interface functions below.  This is the paper's §5 pipeline
(TVM/UMA -> accelerator instructions) with the DNN coming from our own
config system instead of a TVM Relay graph.

The fused-tensor abstraction level keeps streams small (one instruction per
operator tile at ``tile`` granularity — or one per whole operator at
``coarse=True``), so the AIDG estimator answers "how many cycles does one
step of arch X cost on accelerator Y" in milliseconds — the accelerator-
selection / NAS / co-design loop of §1 and §7.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...models.config import ModelConfig, ShapeConfig
from ..acadl import Instruction, isa

__all__ = ["OperatorCall", "extract_operators", "map_to_gamma",
           "map_to_tpu", "UMA_REGISTRY", "register_operator"]


@dataclass(frozen=True)
class OperatorCall:
    """One fused DNN operator instance (the UMA interface-function unit)."""

    op: str                 # "gemm" | "attention" | "scan" | "elementwise"
    m: int = 1              # rows (tokens)
    k: int = 1              # contraction
    n: int = 1              # cols
    count: int = 1          # identical repeats (layers folded in)
    tag: str = ""

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n * self.count

    @property
    def words(self) -> int:
        return (self.m * self.k + self.k * self.n + self.m * self.n) * self.count


def extract_operators(cfg: ModelConfig, shape: ShapeConfig) -> List[OperatorCall]:
    """Per-step operator stream for a (config, shape) cell.

    Decode counts one token; train counts fwd+bwd (3x fwd MACs)."""
    a = cfg.attention
    d = cfg.d_model
    if shape.mode == "decode":
        tokens = shape.global_batch            # one new token per sequence
        ctx = shape.seq_len
    else:
        tokens = shape.global_batch * shape.seq_len
        ctx = shape.seq_len
    mult = 3 if shape.mode == "train" else 1   # bwd ~= 2x fwd MACs

    ops: List[OperatorCall] = []
    kinds = cfg.layer_kinds()
    moes = cfg.moe_layers()
    n_attn = sum(1 for k in kinds if k == "attn")
    n_mamba = len(kinds) - n_attn
    n_moe = sum(moes)
    n_dense = len(kinds) - n_moe if cfg.d_ff > 0 else 0

    if n_attn:
        if a.kind == "mla":
            qk = a.qk_nope_head_dim + a.qk_rope_head_dim
            ops += [
                OperatorCall("gemm", tokens, d, a.q_lora_rank, n_attn * mult, "q_down"),
                OperatorCall("gemm", tokens, a.q_lora_rank, a.n_heads * qk, n_attn * mult, "q_up"),
                OperatorCall("gemm", tokens, d, a.kv_lora_rank + a.qk_rope_head_dim, n_attn * mult, "kv_down"),
                OperatorCall("gemm", tokens, a.kv_lora_rank, a.n_heads * (a.qk_nope_head_dim + a.v_head_dim), n_attn * mult, "kv_up"),
                OperatorCall("gemm", tokens, a.n_heads * a.v_head_dim, d, n_attn * mult, "o"),
            ]
            attn_dim = a.v_head_dim
        else:
            hq = a.n_heads * a.head_dim
            hkv = a.n_kv_heads * a.head_dim
            ops += [
                OperatorCall("gemm", tokens, d, hq, n_attn * mult, "q"),
                OperatorCall("gemm", tokens, d, 2 * hkv, n_attn * mult, "kv"),
                OperatorCall("gemm", tokens, hq, d, n_attn * mult, "o"),
            ]
            attn_dim = a.head_dim
        eff_ctx = min(ctx, a.window) if a.window > 0 else ctx
        if shape.mode != "decode":
            eff_ctx = eff_ctx // 2  # causal average
        ops.append(OperatorCall(
            "attention", tokens * a.n_heads, eff_ctx, 2 * attn_dim,
            n_attn * mult, "attn_core"))

    if n_mamba and cfg.ssm is not None:
        s = cfg.ssm
        di = s.d_inner(d)
        ops += [
            OperatorCall("gemm", tokens, d, 2 * di, n_mamba * mult, "ssm_in"),
            OperatorCall("gemm", tokens, di, s.dt_rank_of(d) + 2 * s.d_state, n_mamba * mult, "ssm_proj"),
            OperatorCall("scan", tokens, di * s.d_state, 2, n_mamba * mult, "ssm_scan"),
            OperatorCall("gemm", tokens, di, d, n_mamba * mult, "ssm_out"),
        ]

    if n_dense:
        ops.append(OperatorCall("gemm", tokens, d, 3 * cfg.d_ff, n_dense * mult, "mlp"))
    if n_moe and cfg.moe is not None:
        m = cfg.moe
        active = m.top_k + m.n_shared_experts
        ops.append(OperatorCall("gemm", tokens * active, d, 3 * m.d_expert,
                                n_moe * mult, "moe"))
        ops.append(OperatorCall("gemm", tokens, d, m.n_experts, n_moe * mult, "router"))

    # embedding / unembedding
    ops.append(OperatorCall("gemm", tokens, d, cfg.vocab_size, mult, "unembed"))
    if cfg.enc_dec is not None:
        e = cfg.enc_dec
        enc_tokens = shape.global_batch * e.encoder_len * (mult if shape.mode == "train" else 1)
        hq = a.n_heads * a.head_dim
        ops += [
            OperatorCall("gemm", enc_tokens, d, 4 * hq, e.n_encoder_layers, "enc_attn_proj"),
            OperatorCall("attention", enc_tokens * a.n_heads, e.encoder_len, 2 * a.head_dim, e.n_encoder_layers, "enc_attn"),
            OperatorCall("gemm", enc_tokens, d, 2 * cfg.d_ff, e.n_encoder_layers, "enc_mlp"),
            OperatorCall("gemm", tokens, d, 2 * hq, cfg.n_layers * mult, "xattn_q"),
            OperatorCall("attention", tokens * a.n_heads, e.encoder_len, 2 * a.head_dim, cfg.n_layers * mult, "xattn"),
        ]
    return ops


# ---------------------------------------------------------------------------
# UMA-style operator-interface registry (paper §5)
# ---------------------------------------------------------------------------

UMA_REGISTRY: Dict[Tuple[str, str], object] = {}


def register_operator(accelerator: str, op: str):
    """Register an interface function mapping an OperatorCall to ACADL
    instructions on ``accelerator`` (cf. ``oma_tiled_gemm`` in §5)."""

    def deco(fn):
        UMA_REGISTRY[(accelerator, op)] = fn
        return fn
    return deco


def _tiles(x: int, t: int) -> int:
    return max(1, -(-x // t))


@register_operator("tpu_v5e", "gemm")
def _tpu_gemm(call: OperatorCall, unit_prefix: str = "", tile: int = 128,
              coarse: bool = True) -> List[Instruction]:
    """GEMM -> MXU gemm instructions.  ``coarse``: one instruction per
    repeat with the whole op's macs (fused-tensor abstraction level)."""
    out: List[Instruction] = []
    VW = 1 << 24
    if coarse:
        m, k, n = call.m, call.k, call.n
        for r in range(call.count):
            addr = (hash((call.tag, r)) % (1 << 14)) * 4
            st = f"dstage.{r % 8}"
            # HBM -> VMEM via the async copy engine, then VMEM -> vregs
            out.append(isa.t_load(st, VW + addr, (k, n), unit="dma0"))
            out.append(isa.t_store(st, addr + 1, shape=(k, n), unit="dma0"))
            out.append(isa.t_load("v.a", addr, (m, k), unit="lsu0"))
            out.append(isa.t_load("v.b", addr + 1, (k, n), unit="lsu0"))
            out.append(isa.t_gemm("v.acc", "v.a", "v.b", unit="mxu0",
                                  tile=(m, k, n)))
            out.append(isa.t_store("v.acc", addr + 2, shape=(m, n), unit="lsu0"))
        return out
    mt, kt, nt = (_tiles(call.m, tile), _tiles(call.k, tile),
                  _tiles(call.n, tile))
    for r in range(call.count * mt * nt):
        out.append(isa.t_load("v.a", 0, (tile, tile * kt), unit="lsu0"))
        out.append(isa.t_load("v.b", 1, (tile * kt, tile), unit="lsu0"))
        out.append(isa.t_gemm("v.acc", "v.a", "v.b", unit="mxu0",
                              tile=(tile, tile * kt, tile)))
        out.append(isa.t_store("v.acc", 2, shape=(tile, tile), unit="lsu0"))
    return out


@register_operator("tpu_v5e", "attention")
def _tpu_attention(call: OperatorCall, coarse: bool = True) -> List[Instruction]:
    out = [isa.t_load("v.q", 0, (call.m, call.n // 2), unit="lsu0"),
           isa.t_load("v.k", 1, (call.k, call.n // 2), unit="lsu0"),
           isa.t_load("v.vv", 2, (call.k, call.n // 2), unit="lsu0")]
    for r in range(call.count):
        out.append(isa.t_attn("v.s", "v.q", "v.k", "v.vv", unit="vpu0",
                              tile=(call.m, call.k, call.n // 2)))
    out.append(isa.t_store("v.s", 3, shape=(call.m, call.n // 2), unit="lsu0"))
    return out


@register_operator("tpu_v5e", "scan")
def _tpu_scan(call: OperatorCall, coarse: bool = True) -> List[Instruction]:
    out = [isa.t_load("v.a", 0, (call.m, call.k), unit="lsu0")]
    for r in range(call.count):
        out.append(isa.t_scan("v.s", "v.s", "v.a", "v.b", unit="vpu0",
                              words=call.m * call.k))
    out.append(isa.t_store("v.s", 1, shape=(call.m, call.k), unit="lsu0"))
    return out


@register_operator("gamma", "gemm")
def _gamma_gemm_op(call: OperatorCall, units=(("lsu0", "matMulFu0", "vrf0"),),
                   tile: int = 8) -> List[Instruction]:
    from .gemm import gamma_gemm
    # map the logical gemm onto 8x8 gamma tiles, folding count into m
    m = min(call.m * call.count, 512)  # cap the emitted stream
    k = min(call.k, 64)
    n = min(call.n, 64)
    m, k, n = (max(tile, (x // tile) * tile) for x in (m, k, n))
    return gamma_gemm(m, k, n, tile=tile, units=units)


@register_operator("gamma", "attention")
def _gamma_attention_op(call: OperatorCall,
                        units=(("lsu0", "matAddFu0", "vrf0"),),
                        tile: int = 8) -> List[Instruction]:
    """Attention -> Γ̈ ``t_attn`` tile stream (``mapping.fused``), the
    q/kv extents capped so the emitted stream stays simulator-sized."""
    from .fused import gamma_attention
    seq = max(tile, min(call.m * call.count, 256) // tile * tile)
    ctx = max(tile, min(call.k, 128) // tile * tile)
    hd = max(1, min(call.n // 2, 64))
    return gamma_attention(seq, ctx, hd, tile=tile, units=units)


@register_operator("gamma", "scan")
def _gamma_scan_op(call: OperatorCall,
                   units=(("lsu0", "matAddFu0", "vrf0"),),
                   tile: int = 8) -> List[Instruction]:
    """Selective scan -> Γ̈ chunked-scan stream; tokens capped, state
    columns striped across the provided units."""
    from .fused import gamma_scan
    tokens = max(tile, min(call.m * call.count, 1024) // tile * tile)
    d_state = max(len(units), min(call.k, 64))
    d_state -= d_state % len(units)
    return gamma_scan(tokens, d_state, tile=tile, units=units)


def map_to_tpu(cfg: ModelConfig, shape: ShapeConfig,
               per_device: int = 512) -> List[Instruction]:
    """Full-step operator stream mapped onto the TPU-v5e ACADL model.

    ``per_device``: divide every operator's token dimension by the chip
    count (the ACADL model is one core; the mesh scales tokens)."""
    prog: List[Instruction] = []
    for call in extract_operators(cfg, shape):
        m = max(1, call.m // per_device)
        scaled = OperatorCall(call.op, m, call.k, call.n, call.count, call.tag)
        fn = UMA_REGISTRY.get(("tpu_v5e", call.op))
        if fn is None:
            continue
        prog.extend(fn(scaled))
    return prog


def map_to_gamma(cfg: ModelConfig, shape: ShapeConfig,
                 units=(("lsu0", "matMulFu0", "vrf0"),)) -> List[Instruction]:
    """Full-step operator stream mapped onto the Γ̈ ACADL model: GEMMs via
    the matMul units, attention/scan via the matAdd units (their register
    triples derived by name from ``units``); unmapped kinds are skipped."""
    attn_units = tuple((lsu, fu.replace("matMulFu", "matAddFu"), vrf)
                       for lsu, fu, vrf in units)
    prog: List[Instruction] = []
    for call in extract_operators(cfg, shape):
        fn = UMA_REGISTRY.get(("gamma", call.op))
        if fn is None:
            continue
        kw = {"units": units if call.op == "gemm" else attn_units}
        prog.extend(fn(call, **kw))
        if len(prog) > 4000:   # bounded stream for the event simulator
            break
    return prog
