"""Roofline analysis of a counted step on the H100 (the port of
``repro.launch.roofline``).

Three terms per (arch x shape x mesh) cell:

    compute    = FLOPs/dev            / (dense bf16 peak FLOP/s per card)
    memory     = bytes/dev            / (HBM bytes/s per card)
    collective = collective bytes/dev / (NVLink bytes/s per card, one way)

The reference reads XLA's compiled HLO text (``parse_dot_flops``,
``parse_collective_bytes``).  The port has no HLO: ``StepCounter``, a
``TorchDispatchMode``, counts the step as it runs, on one rank's local
shards.  A DTensor op reaches the mode first at its global shape; the
mode returns ``NotImplemented``, DTensor runs it (redistributing its
operands) and the mode then sees each local op and each functional
collective on the local tensors.  DTensor also runs every op once on
``FakeTensor``s of the global shapes to derive the output's metadata;
those runs are not work and are skipped.

* FLOPs: ``torch.utils.flop_counter``'s formulas (matmul-like ops: ``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, convolutions, attention) on the local
  shapes — the reference's ``dot_flops_per_device``.
* bytes: every op's local tensor operands and results once (views and
  allocations excluded): an eager upper estimate with no fusion, larger
  than what XLA's fused HLO moves.
* collectives: each ``_c10d_functional`` collective by kind, its payload
  (the result's bytes, as the reference reads the HLO result type) times
  the ring factor ``_FACTOR``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["HW_H100", "roofline_terms", "RooflineCell", "StepCounter",
           "COLLECTIVES"]

# NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU data sheet), at the
# 700 W limit: "NVIDIA H100 80GB HBM3, 700.00 W" as nvidia-smi names it
HW_H100 = {
    "peak_bf16_flops": 989e12,     # dense BF16 tensor-core FLOP/s per card
    "hbm_bytes_per_s": 3.35e12,    # HBM3 per card
    # NVLink 4: the data sheet's 900 GB/s per GPU is both directions
    # together (18 links x 50 GB/s); one direction is 450 GB/s
    "ici_bytes_per_s": 450e9,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# ring-algorithm traffic factors (bytes moved per device / payload bytes)
_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
           "all-to-all": 1.0, "collective-permute": 1.0}

# torch's functional collectives -> the HLO kinds
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}

_DTYPE_BYTES = {torch.float64: 8, torch.float32: 4, torch.bfloat16: 2,
                torch.float16: 2, torch.int64: 8, torch.int32: 4,
                torch.int16: 2, torch.int8: 1, torch.uint8: 1,
                torch.bool: 1}

_ALLOCATIONS = {"empty", "empty_strided", "empty_like", "new_empty",
                "new_empty_strided"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * _DTYPE_BYTES.get(t.dtype, t.element_size())


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


@dataclass
class StepCounter(TorchDispatchMode):
    """Counts what one rank does while active: ``flops`` (and
    ``flops_by_op``), ``bytes`` and ``collectives`` ({kind: {"count",
    "bytes"}}, bytes with the ring factor).  Use as a context manager
    around the step.  ``device``: the device type whose work is counted
    (``"meta"`` for the dry run's shards, ``"cuda"`` on the card; None:
    every op), so that the small host tensors DTensor computes its shard
    offsets with are not counted as the step's work."""

    device: Optional[str] = None
    flops: float = 0.0
    bytes: float = 0.0
    flops_by_op: Dict[str, float] = field(default_factory=dict)
    collectives: Dict[str, Dict[str, float]] = field(
        default_factory=lambda: {k: {"count": 0, "bytes": 0.0}
                                 for k in COLLECTIVES})

    def __post_init__(self):
        super().__init__()

    @property
    def collective_bytes(self) -> float:
        return sum(v["bytes"] for v in self.collectives.values())

    @property
    def collective_counts(self) -> Dict[str, int]:
        return {k: v["count"] for k, v in self.collectives.items()
                if v["count"]}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor lower it to local ops
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if any(_is_fake(t) for t in ins + outs):
            return out                 # DTensor's shape propagation
        if self.device is not None and not any(
                t.device.type == self.device for t in ins + outs):
            return out                 # DTensor's bookkeeping on the host
        packet = func._overloadpacket
        ns, name = func.namespace, packet.__name__
        if ns == "_c10d_functional":
            kind = _KIND.get(name)
            if kind is not None:
                c = self.collectives[kind]
                c["count"] += 1
                c["bytes"] += sum(_nbytes(t) for t in outs) * _FACTOR[kind]
            return out
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            self.flops_by_op[name] = self.flops_by_op.get(name, 0.0) + f
        if not func.is_view and name not in _ALLOCATIONS:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        return out


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   hw: Dict[str, float] = HW_H100) -> Dict[str, float]:
    return {
        "compute_s": flops / hw["peak_bf16_flops"],
        "memory_s": hbm_bytes / hw["hbm_bytes_per_s"],
        "collective_s": coll_bytes / hw["ici_bytes_per_s"],
    }


@dataclass
class RooflineCell:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float
    useful_ratio: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """compute_term / max-term: 1.0 = compute-bound at peak."""
        return self.compute_s / max(self.bound_s, 1e-30)
