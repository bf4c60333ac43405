"""ACADL — Abstract Computer Architecture Description Language (Müller et al. 2024).

Public surface mirrors the paper's Python front-end:

    from repro_torch.core.acadl import *

    @generate
    def my_arch():
        ...ACADLObject subclasses + ACADLEdge(...)...

    my_arch()
    ag = create_ag()
    result = simulate(ag, program)
"""

from .base import ACADLObject, Data, Instruction, latency_t
from .edges import (
    ACADLDanglingEdge,
    ACADLEdge,
    CONTAINS,
    DanglingEdge,
    EdgeType,
    EdgeValidityError,
    FORWARD,
    READ_DATA,
    WRITE_DATA,
    connect_dangling_edge,
    create_ag,
    generate,
)
from .graph import AGValidityError, ArchitectureGraph
from .pipeline import ExecuteStage, InstructionFetchStage, PipelineStage
from .storage import (
    CacheInterface,
    DataStorage,
    DRAM,
    MemoryInterface,
    RegisterFile,
    SetAssociativeCache,
    SRAM,
)
from .units import FunctionalUnit, InstructionMemoryAccessUnit, MemoryAccessUnit
from .sim import EventSimulator, SimResult, TraceEntry, build_trace, simulate
from . import isa

__all__ = [
    "ACADLObject", "Data", "Instruction", "latency_t",
    "ACADLEdge", "ACADLDanglingEdge", "DanglingEdge", "EdgeType",
    "READ_DATA", "WRITE_DATA", "CONTAINS", "FORWARD",
    "connect_dangling_edge", "generate", "create_ag",
    "EdgeValidityError", "AGValidityError", "ArchitectureGraph",
    "PipelineStage", "ExecuteStage", "InstructionFetchStage",
    "RegisterFile", "DataStorage", "MemoryInterface", "SRAM", "DRAM",
    "CacheInterface", "SetAssociativeCache",
    "FunctionalUnit", "MemoryAccessUnit", "InstructionMemoryAccessUnit",
    "EventSimulator", "SimResult", "TraceEntry", "build_trace", "simulate",
    "isa",
]
