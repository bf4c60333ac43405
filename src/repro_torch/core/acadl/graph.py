"""Architecture graph (AG): the UML object diagram of a modeled architecture.

``ArchitectureGraph`` holds the instantiated ACADL objects and validated
edges, wires the convenience pointers the simulator uses (contained units,
readable/writable register files and storages, forward targets), and checks
global well-formedness beyond per-edge validity:

* object names are unique (checked at registration);
* every InstructionFetchStage contains an InstructionMemoryAccessUnit with a
  connected instruction memory;
* DataStorage ``read_write_ports`` bounds the number of connected
  MemoryAccessUnits;
* CONTAINS is exclusive — a FunctionalUnit belongs to exactly one stage.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .base import ACADLObject
from .edges import ACADLEdge, EdgeType
from .pipeline import ExecuteStage, InstructionFetchStage, PipelineStage
from .storage import DataStorage, RegisterFile
from .units import FunctionalUnit, InstructionMemoryAccessUnit, MemoryAccessUnit

__all__ = ["ArchitectureGraph", "AGValidityError"]


class AGValidityError(ValueError):
    pass


class ArchitectureGraph:
    def __init__(self, objects: Sequence[ACADLObject], edges: Sequence[ACADLEdge]):
        self.objects: List[ACADLObject] = list(objects)
        self.edges: List[ACADLEdge] = list(edges)
        self.by_name: Dict[str, ACADLObject] = {o.name: o for o in self.objects}
        if len(self.by_name) != len(self.objects):
            raise AGValidityError("duplicate object names in AG")
        self._finalize()
        self._validate()

    # -- wiring ------------------------------------------------------------------
    def _finalize(self) -> None:
        # reset wiring (idempotent construction)
        for o in self.objects:
            if isinstance(o, PipelineStage):
                o.forward_targets = []
            if isinstance(o, ExecuteStage):
                o.functional_units = []
            if isinstance(o, FunctionalUnit):
                o.readable_rfs = []
                o.writable_rfs = []
            if isinstance(o, MemoryAccessUnit):
                o.readable_storages = []
                o.writable_storages = []
            if isinstance(o, DataStorage):
                o.backing = None

        for e in self.edges:
            s, t, k = e.source, e.target, e.edge_type
            if k is EdgeType.FORWARD:
                s.forward_targets.append(t)
            elif k is EdgeType.CONTAINS:
                s.functional_units.append(t)
            elif k is EdgeType.READ_DATA:
                if isinstance(s, RegisterFile):
                    t.readable_rfs.append(s)
                elif isinstance(s, DataStorage) and isinstance(t, (MemoryAccessUnit,)):
                    t.readable_storages.append(s)
                elif isinstance(s, DataStorage) and isinstance(t, DataStorage):
                    t.backing = s  # cache fill path: t reads (fills) from s
            elif k is EdgeType.WRITE_DATA:
                if isinstance(s, FunctionalUnit) and isinstance(t, RegisterFile):
                    s.writable_rfs.append(t)
                elif isinstance(s, MemoryAccessUnit) and isinstance(t, DataStorage):
                    s.writable_storages.append(t)

    # -- global validity -----------------------------------------------------------
    def _validate(self) -> None:
        # CONTAINS exclusivity
        owner: Dict[str, str] = {}
        for e in self.edges:
            if e.edge_type is EdgeType.CONTAINS:
                prev = owner.setdefault(e.target.name, e.source.name)
                if prev != e.source.name:
                    raise AGValidityError(
                        f"FunctionalUnit {e.target.name!r} contained by both "
                        f"{prev!r} and {e.source.name!r} (composition must be exclusive)"
                    )
        # fetch stages need an instruction path
        for o in self.objects:
            if isinstance(o, InstructionFetchStage):
                imau = o.imau
                if imau is None:
                    raise AGValidityError(
                        f"InstructionFetchStage {o.name!r} contains no InstructionMemoryAccessUnit"
                    )
                if imau.instruction_memory is None:
                    raise AGValidityError(
                        f"InstructionMemoryAccessUnit {imau.name!r} has no instruction memory "
                        f"(READ_DATA edge from a DataStorage)"
                    )
        # port bounds
        port_users: Dict[str, set] = {}
        for e in self.edges:
            if e.edge_type in (EdgeType.READ_DATA, EdgeType.WRITE_DATA):
                st, mau = None, None
                if isinstance(e.source, DataStorage) and isinstance(e.target, MemoryAccessUnit):
                    st, mau = e.source, e.target
                elif isinstance(e.source, MemoryAccessUnit) and isinstance(e.target, DataStorage):
                    st, mau = e.target, e.source
                if st is not None:
                    port_users.setdefault(st.name, set()).add(mau.name)
        for st_name, users in port_users.items():
            st = self.by_name[st_name]
            if len(users) > st.read_write_ports:
                raise AGValidityError(
                    f"DataStorage {st_name!r} has {len(users)} connected MemoryAccessUnits "
                    f"but only read_write_ports={st.read_write_ports}"
                )

    # -- queries ------------------------------------------------------------------
    def of_type(self, cls) -> List[ACADLObject]:
        return [o for o in self.objects if isinstance(o, cls)]

    @property
    def fetch_stages(self) -> List[InstructionFetchStage]:
        return self.of_type(InstructionFetchStage)

    @property
    def pipeline_stages(self) -> List[PipelineStage]:
        return self.of_type(PipelineStage)

    @property
    def functional_units(self) -> List[FunctionalUnit]:
        return self.of_type(FunctionalUnit)

    @property
    def storages(self) -> List[DataStorage]:
        return self.of_type(DataStorage)

    def timing_reset(self) -> None:
        for st in self.storages:
            st.timing_reset()

    def describe(self) -> str:
        """Human-readable AG summary (block-diagram-as-text)."""
        lines = [f"ArchitectureGraph: {len(self.objects)} objects, {len(self.edges)} edges"]
        for o in self.objects:
            lines.append(f"  {type(o).__name__:28s} {o.name}")
        for e in self.edges:
            lines.append(f"  {e.source.name} --{e.edge_type.value}--> {e.target.name}")
        return "\n".join(lines)
