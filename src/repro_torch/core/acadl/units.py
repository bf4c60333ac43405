"""ACADL functional units (paper §3).

``FunctionalUnit`` executes Instructions passed to ``process()`` and changes
architectural state through the RegisterFiles it is connected to via
``READ_DATA``/``WRITE_DATA`` edges.  It can only process Instructions whose
``operation`` is in ``to_process`` *and* whose read/write register sets are
accessible through those edges.  Processing takes ``latency`` cycles once all
data dependencies from previous instructions are resolved.

``MemoryAccessUnit`` additionally accesses DataStorages;
``InstructionMemoryAccessUnit`` adds ``fetch()`` reading ``length``
instructions starting at ``address`` from the instruction memory.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .base import ACADLObject, Data, Instruction, latency_t, LatencyLike, _as_latency
from .storage import DataStorage, RegisterFile

__all__ = [
    "FunctionalUnit",
    "MemoryAccessUnit",
    "InstructionMemoryAccessUnit",
]


class FunctionalUnit(ACADLObject):
    def __init__(self, name: str, to_process: Iterable[str] = (),
                 latency: LatencyLike = 1):
        super().__init__(name)
        self.to_process: Set[str] = set(to_process)
        self.latency = _as_latency(latency)
        # wired by ArchitectureGraph.finalize() from READ_DATA/WRITE_DATA edges
        self.readable_rfs: List[RegisterFile] = []
        self.writable_rfs: List[RegisterFile] = []

    # -- access checks ---------------------------------------------------------
    def _find_rf(self, rfs: Sequence[RegisterFile], reg: str) -> Optional[RegisterFile]:
        for rf in rfs:
            if rf.has(reg):
                return rf
        return None

    def can_access(self, instruction: Instruction) -> bool:
        """Register-set accessibility check (paper §3: FunctionalUnits can only
        process Instructions whose read/write registers are accessible)."""
        for reg in instruction.read_registers:
            if self._find_rf(self.readable_rfs, reg) is None:
                return False
        for reg in instruction.write_registers:
            if self._find_rf(self.writable_rfs, reg) is None:
                return False
        return True

    def supports(self, instruction: Instruction) -> bool:
        if instruction.operation not in self.to_process:
            return False
        if instruction.unit_hint is not None and instruction.unit_hint != self.name:
            return False
        return self.can_access(instruction)

    # -- functional simulation -------------------------------------------------
    def read(self, reg: str) -> Any:
        rf = self._find_rf(self.readable_rfs, reg)
        if rf is None:
            raise KeyError(f"{self.name}: no readable RegisterFile holds {reg!r}")
        return rf.read(reg)

    def write(self, reg: str, value: Any) -> None:
        rf = self._find_rf(self.writable_rfs, reg)
        if rf is None:
            raise KeyError(f"{self.name}: no writable RegisterFile holds {reg!r}")
        rf.write(reg, value)

    def process(self, instruction: Instruction) -> None:
        """Functional part of processing (timing is the simulator's job)."""
        from .base import ExecutionEnv

        env = ExecutionEnv(self.read, self.write, self._read_mem, self._write_mem)
        instruction.execute(env)

    # memory access is only available on MemoryAccessUnit
    def _read_mem(self, address: int) -> Any:
        raise TypeError(f"{type(self).__name__} {self.name!r} has no memory access")

    def _write_mem(self, address: int, value: Any) -> None:
        raise TypeError(f"{type(self).__name__} {self.name!r} has no memory access")


class MemoryAccessUnit(FunctionalUnit):
    """FunctionalUnit that additionally accesses DataStorages (paper §3)."""

    def __init__(self, name: str, to_process: Iterable[str] = ("load", "store"),
                 latency: LatencyLike = 1):
        super().__init__(name, to_process, latency)
        # wired by ArchitectureGraph.finalize()
        self.readable_storages: List[DataStorage] = []
        self.writable_storages: List[DataStorage] = []

    def _storage_for(self, storages: Sequence[DataStorage], address: int) -> Optional[DataStorage]:
        best = None
        for st in storages:
            cov = getattr(st, "covers", None)
            if cov is not None:
                if cov(address):
                    return st
            elif best is None:
                best = st
        return best

    def _read_mem(self, address: int) -> Any:
        st = self._storage_for(self.readable_storages, address)
        if st is None:
            raise KeyError(f"{self.name}: no readable DataStorage covers address {address:#x}")
        return st.read(address)

    def _write_mem(self, address: int, value: Any) -> None:
        st = self._storage_for(self.writable_storages, address)
        if st is None:
            raise KeyError(f"{self.name}: no writable DataStorage covers address {address:#x}")
        st.write(address, value)

    # -- timing helper: storage chain for an address ---------------------------
    def storage_chain(self, kind: str, address: int) -> List[DataStorage]:
        """The storages consulted for an access, nearest first.

        For a cache in front of a memory this is [cache, memory]; the
        simulator charges the cache's (hit|miss) latency, a miss already
        includes the backing-store trip (paper §6: after ``miss_latency``
        cycles the cache simulator is updated and the slot becomes ready).
        """
        storages = self.readable_storages if kind == "read" else self.writable_storages
        st = self._storage_for(storages, address)
        return [st] if st is not None else []


class InstructionMemoryAccessUnit(MemoryAccessUnit):
    """Adds ``fetch()``: read ``length`` instructions from instruction memory."""

    def __init__(self, name: str, latency: LatencyLike = 1):
        super().__init__(name, to_process=(), latency=latency)

    @property
    def instruction_memory(self) -> Optional[DataStorage]:
        return self.readable_storages[0] if self.readable_storages else None

    def fetch(self, address: int, length: int) -> List[Instruction]:
        imem = self.instruction_memory
        if imem is None:
            raise RuntimeError(f"{self.name}: no instruction memory connected")
        out: List[Instruction] = []
        for a in range(address, address + length):
            word = imem.read(a)
            if isinstance(word, Instruction):
                out.append(word)
        return out
