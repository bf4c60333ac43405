"""ACADL pipeline stages (paper §3).

``PipelineStage`` forwards instructions: ``receive()`` is called by another
stage's ``forward()``; an instruction can only be forwarded if the receiving
stage is ``ready()``; it resides ``latency`` cycles before being forwarded.

``ExecuteStage`` inherits from PipelineStage and contains FunctionalUnits.
On receive it checks whether a contained unit supports the instruction
(operation in ``to_process`` + register accessibility); if so the unit
processes it and the ExecuteStage's own latency is *not* accumulated.

``InstructionFetchStage`` inherits from ExecuteStage, owns an issue buffer of
``issue_buffer_size`` instructions, fetches through a contained
InstructionMemoryAccessUnit every cycle while space remains, and may forward
multiple instructions out-of-order in the same clock cycle.
"""

from __future__ import annotations

from typing import List, Optional

from .base import ACADLObject, Instruction, latency_t, LatencyLike, _as_latency
from .units import FunctionalUnit, InstructionMemoryAccessUnit

__all__ = ["PipelineStage", "ExecuteStage", "InstructionFetchStage"]


class PipelineStage(ACADLObject):
    def __init__(self, name: str, latency: LatencyLike = 1):
        super().__init__(name)
        self.latency = _as_latency(latency)
        # wired by ArchitectureGraph.finalize() from FORWARD edges
        self.forward_targets: List["PipelineStage"] = []

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{type(self).__name__}(name={self.name!r}, latency={self.latency!r})"


class ExecuteStage(PipelineStage):
    def __init__(self, name: str, latency: LatencyLike = 1):
        super().__init__(name, latency)
        # wired by ArchitectureGraph.finalize() from CONTAINS edges
        self.functional_units: List[FunctionalUnit] = []

    def unit_for(self, instruction: Instruction) -> Optional[FunctionalUnit]:
        """First contained FunctionalUnit that supports the instruction."""
        for fu in self.functional_units:
            if fu.supports(instruction):
                return fu
        return None


class InstructionFetchStage(ExecuteStage):
    def __init__(self, name: str, latency: LatencyLike = 1, issue_buffer_size: int = 4):
        super().__init__(name, latency)
        self.issue_buffer_size = issue_buffer_size

    @property
    def imau(self) -> Optional[InstructionMemoryAccessUnit]:
        for fu in self.functional_units:
            if isinstance(fu, InstructionMemoryAccessUnit):
                return fu
        return None
