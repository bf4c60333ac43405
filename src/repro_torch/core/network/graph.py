"""Layer-graph frontend: model config -> ordered per-layer operator graph.

The paper's central demonstration is mapping *entire DNNs* onto
ACADL-modeled accelerators and inferring end-to-end timing (§1, §5, §7;
Lübeck et al. 2024 make the layer-graph level the unit of automatic
performance-model generation).  ``repro_torch.core.mapping.workload`` already
extracts a model's per-step operator *totals* (one ``OperatorCall`` per
operator kind, layer counts folded into ``count``); this module recovers
the **execution order**: the sequence of per-layer operator instances one
forward step actually runs, e.g. for a 16-block decoder-only LM

    [q, kv, attn_core, o, mlp] x 16, unembed

Each instance carries a ``count=1`` ``OperatorCall`` (its exact shape) and
the graph records which instances share a shape — the unit of AIDG
compile-caching downstream (16 identical blocks lower to ONE compiled
per-layer program repeated 16 times).

The expansion is validated against ``extract_operators``: every extracted
call's folded ``count`` must equal its number of occurrences in the
expanded sequence (times the train-mode multiplier), so the layer graph
can never silently drift from the operator-extraction shapes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from ...models.config import ModelConfig, ShapeConfig
from ..mapping.workload import OperatorCall, extract_operators

__all__ = ["LayerInstance", "LayerGraph", "extract_layer_graph",
           "NETWORK_SHAPE"]

# the reference whole-network shape: single-token decode at a small batch.
# Sizes keep every per-layer program event-simulatable in tests while the
# coarse (fused-tensor) latency models still see the real layer shapes.
NETWORK_SHAPE = ShapeConfig("net_decode", seq_len=2048, global_batch=8,
                            mode="decode")


@dataclass(frozen=True)
class LayerInstance:
    """One per-layer operator instance in execution order."""

    tag: str                 # operator-extraction tag ("q", "mlp", ...)
    call: OperatorCall       # exact shape, count = 1
    unique: int              # index into LayerGraph.unique


@dataclass
class LayerGraph:
    """The expanded execution sequence of a model's forward step.

    ``unique`` holds one ``OperatorCall`` per distinct (op, m, k, n) shape;
    ``instances`` the full ordered sequence referencing it; ``runs`` the
    run-length encoding of ``instances`` by unique id — the structure the
    max-plus composition consumes."""

    arch_id: str
    shape: ShapeConfig
    instances: List[LayerInstance]
    unique: List[OperatorCall]

    @property
    def runs(self) -> List[Tuple[int, int]]:
        """Run-length encoding [(unique_id, consecutive instances), ...]."""
        out: List[Tuple[int, int]] = []
        for inst in self.instances:
            if out and out[-1][0] == inst.unique:
                out[-1] = (inst.unique, out[-1][1] + 1)
            else:
                out.append((inst.unique, 1))
        return out

    @property
    def ops(self) -> Tuple[str, ...]:
        """The distinct operator kinds the network needs an arch to map."""
        return tuple(sorted({c.op for c in self.unique}))

    def counts(self) -> Dict[int, int]:
        """unique id -> total instances across the sequence."""
        out: Dict[int, int] = {}
        for inst in self.instances:
            out[inst.unique] = out.get(inst.unique, 0) + 1
        return out


def _block_tags(cfg: ModelConfig, kind: str, is_moe: bool) -> List[str]:
    """Execution-order operator tags of one decoder block."""
    tags: List[str] = []
    if kind == "attn":
        if cfg.attention.kind == "mla":
            tags += ["q_down", "q_up", "kv_down", "kv_up", "attn_core", "o"]
        else:
            tags += ["q", "kv", "attn_core", "o"]
        if cfg.enc_dec is not None:
            tags += ["xattn_q", "xattn"]
    else:
        tags += ["ssm_in", "ssm_proj", "ssm_scan", "ssm_out"]
    if is_moe and cfg.moe is not None:
        tags += ["router", "moe"]
    elif cfg.d_ff > 0:
        tags += ["mlp"]
    return tags


def extract_layer_graph(cfg: ModelConfig, shape: ShapeConfig = NETWORK_SHAPE
                        ) -> LayerGraph:
    """Expand (config, shape) into the ordered per-layer operator sequence.

    Raises ``ValueError`` if the expansion disagrees with
    ``extract_operators`` about any operator's total count — the two views
    must describe the same network."""
    calls = extract_operators(cfg, shape)
    per_tag: Dict[str, OperatorCall] = {}
    folded: Dict[str, int] = {}
    for c in calls:
        if c.tag in per_tag:
            raise ValueError(f"duplicate operator tag {c.tag!r} in "
                             f"{cfg.arch_id}")
        per_tag[c.tag] = OperatorCall(c.op, c.m, c.k, c.n, 1, c.tag)
        folded[c.tag] = c.count

    tags: List[str] = []
    if cfg.enc_dec is not None:
        for _ in range(cfg.enc_dec.n_encoder_layers):
            tags += ["enc_attn_proj", "enc_attn", "enc_mlp"]
    for kind, is_moe in zip(cfg.layer_kinds(), cfg.moe_layers()):
        tags += _block_tags(cfg, kind, is_moe)
    tags.append("unembed")

    # consistency: occurrences x train multiplier == extracted fold count
    mult = 3 if shape.mode == "train" else 1
    occur: Dict[str, int] = {}
    for t in tags:
        occur[t] = occur.get(t, 0) + 1
    enc_tags = {"enc_attn_proj", "enc_attn", "enc_mlp"}
    for tag, n in folded.items():
        # encoder ops run forward-only even in train mode upstream
        expect = occur.get(tag, 0) * (1 if tag in enc_tags else mult)
        if expect != n:
            raise ValueError(
                f"{cfg.arch_id}: layer-graph expansion has {expect} "
                f"x {tag!r} but extract_operators folded count {n}")
    missing = [t for t in tags if t not in per_tag]
    if missing:
        raise ValueError(f"{cfg.arch_id}: no extracted operator for tags "
                         f"{sorted(set(missing))}")

    unique: List[OperatorCall] = []
    by_shape: Dict[Tuple, int] = {}
    instances: List[LayerInstance] = []
    for t in tags:
        call = per_tag[t]
        key = (call.op, call.m, call.k, call.n)
        if key not in by_shape:
            by_shape[key] = len(unique)
            unique.append(call)
        instances.append(LayerInstance(t, call, by_shape[key]))
    return LayerGraph(cfg.arch_id, shape, instances, unique)
