"""ACADL edges, dangling edges and the ``@generate``/``create_ag`` front-end.

The paper's Python front-end (§4) works as follows:

* architecture implementations are Python functions decorated with
  ``@generate``; calling the function registers every instantiated
  ``ACADLObject`` and ``ACADLEdge`` into an implicit builder and *implicitly
  checks the validity of all edges*;
* ``create_ag()`` then instantiates the architecture graph (AG);
* ``ACADLEdge(src, dst, edge_type)`` connects instantiated objects;
* ``ACADLDanglingEdge`` (aka ``DanglingEdge``) has only a source *or* a
  target and provides template interfaces; ``connect_dangling_edge()`` joins
  two dangling edges (or a dangling edge and an object) into a real edge,
  validity-checked against the class diagram.  Unconnected dangling edges
  simply never materialize.
"""

from __future__ import annotations

import enum
import functools
import threading
from typing import List, Optional, Union

__all__ = [
    "EdgeType",
    "READ_DATA",
    "WRITE_DATA",
    "CONTAINS",
    "FORWARD",
    "ACADLEdge",
    "ACADLDanglingEdge",
    "DanglingEdge",
    "connect_dangling_edge",
    "generate",
    "create_ag",
    "EdgeValidityError",
]


class EdgeType(enum.Enum):
    """Typed relations from the ACADL class diagram (Fig. 1)."""

    READ_DATA = "READ_DATA"      # association: caller reads data from callee (:read())
    WRITE_DATA = "WRITE_DATA"    # association: caller writes data to callee (:write())
    CONTAINS = "CONTAINS"        # composition: stage contains functional units
    FORWARD = "FORWARD"          # association: pipeline stage forwards instructions


READ_DATA = EdgeType.READ_DATA
WRITE_DATA = EdgeType.WRITE_DATA
CONTAINS = EdgeType.CONTAINS
FORWARD = EdgeType.FORWARD


class EdgeValidityError(TypeError):
    """Raised when an edge violates the ACADL class diagram."""


def _edge_is_valid(src, dst, edge_type: EdgeType) -> Optional[str]:
    """Return an error string when (src, dst, edge_type) violates Fig. 1.

    The admissible relations, per the class diagram and the modeling
    examples (§4):

    * FORWARD: PipelineStage -> PipelineStage (incl. ExecuteStage and
      InstructionFetchStage subclasses).
    * CONTAINS: ExecuteStage -> FunctionalUnit (incl. MemoryAccessUnit /
      InstructionMemoryAccessUnit subclasses).
    * READ_DATA: RegisterFile -> FunctionalUnit, DataStorage ->
      MemoryAccessUnit, DataStorage -> DataStorage (cache fill path, cf.
      ``ACADLEdge(dmem0, dcache0, READ_DATA)``), RegisterFile ->
      InstructionMemoryAccessUnit (pc read) and DataStorage ->
      InstructionMemoryAccessUnit (instruction memory read).
    * WRITE_DATA: FunctionalUnit -> RegisterFile, MemoryAccessUnit ->
      DataStorage, DataStorage -> DataStorage (write-back path),
      InstructionMemoryAccessUnit -> RegisterFile (pc increment) and
      FunctionalUnit -> FunctionalUnit register forwarding is *not* allowed —
      forwarding between template PEs goes through the neighbour's
      RegisterFile (cf. §4.2).
    """

    # Local imports: edges.py is imported by base.py at class-definition time.
    from .pipeline import PipelineStage, ExecuteStage
    from .units import FunctionalUnit, MemoryAccessUnit, InstructionMemoryAccessUnit
    from .storage import DataStorage, RegisterFile

    if edge_type is EdgeType.FORWARD:
        if isinstance(src, PipelineStage) and isinstance(dst, PipelineStage):
            return None
        return f"FORWARD requires PipelineStage -> PipelineStage, got {type(src).__name__} -> {type(dst).__name__}"

    if edge_type is EdgeType.CONTAINS:
        if isinstance(src, ExecuteStage) and isinstance(dst, FunctionalUnit):
            return None
        return f"CONTAINS requires ExecuteStage -> FunctionalUnit, got {type(src).__name__} -> {type(dst).__name__}"

    if edge_type is EdgeType.READ_DATA:
        if isinstance(src, RegisterFile) and isinstance(dst, FunctionalUnit):
            return None
        if isinstance(src, DataStorage) and isinstance(dst, (MemoryAccessUnit, InstructionMemoryAccessUnit)):
            return None
        if isinstance(src, DataStorage) and isinstance(dst, DataStorage):
            return None  # memory -> cache fill
        return (
            "READ_DATA requires RegisterFile->FunctionalUnit, DataStorage->MemoryAccessUnit "
            f"or DataStorage->DataStorage, got {type(src).__name__} -> {type(dst).__name__}"
        )

    if edge_type is EdgeType.WRITE_DATA:
        if isinstance(src, FunctionalUnit) and isinstance(dst, RegisterFile):
            return None
        if isinstance(src, MemoryAccessUnit) and isinstance(dst, DataStorage):
            return None
        if isinstance(src, DataStorage) and isinstance(dst, DataStorage):
            return None  # cache -> memory write-back
        return (
            "WRITE_DATA requires FunctionalUnit->RegisterFile, MemoryAccessUnit->DataStorage "
            f"or DataStorage->DataStorage, got {type(src).__name__} -> {type(dst).__name__}"
        )

    return f"unknown edge type {edge_type!r}"  # pragma: no cover


class ACADLEdge:
    """A validated, typed edge between two instantiated ACADL objects."""

    __slots__ = ("source", "target", "edge_type")

    def __init__(self, source, target, edge_type: EdgeType):
        err = _edge_is_valid(source, target, edge_type)
        if err is not None:
            raise EdgeValidityError(f"invalid edge {source!r} -> {target!r}: {err}")
        self.source = source
        self.target = target
        self.edge_type = edge_type
        builder = _current_builder()
        if builder is not None:
            builder.register_edge(self)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"ACADLEdge({self.source.name} -> {self.target.name}, {self.edge_type.value})"


class ACADLDanglingEdge:
    """An edge with only a source *or* a target (template interface).

    Unconnected dangling edges never instantiate an ``ACADLEdge``.
    """

    __slots__ = ("source", "target", "edge_type", "connected")

    def __init__(self, edge_type: EdgeType, source=None, target=None):
        if (source is None) == (target is None):
            raise ValueError("DanglingEdge needs exactly one of source/target")
        self.edge_type = edge_type
        self.source = source
        self.target = target
        self.connected = False

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        side = f"{self.source.name} ->" if self.source is not None else f"-> {self.target.name}"
        return f"DanglingEdge({side}, {self.edge_type.value})"


DanglingEdge = ACADLDanglingEdge  # paper uses both spellings


def connect_dangling_edge(a: Union[ACADLDanglingEdge, object], b: Union[ACADLDanglingEdge, object]) -> ACADLEdge:
    """Join two dangling edges — or a dangling edge and an ACADL object —
    into a validated ``ACADLEdge`` (paper §4.2).
    """

    from .base import ACADLObject

    def _is_dangling(x) -> bool:
        return isinstance(x, ACADLDanglingEdge)

    if _is_dangling(a) and _is_dangling(b):
        if a.edge_type is not b.edge_type:
            raise EdgeValidityError(
                f"cannot connect dangling edges of different types: {a.edge_type} vs {b.edge_type}"
            )
        src = a.source if a.source is not None else b.source
        dst = a.target if a.target is not None else b.target
        if src is None or dst is None:
            raise EdgeValidityError("connected dangling edges must supply one source and one target")
        edge = ACADLEdge(src, dst, a.edge_type)
        a.connected = b.connected = True
        return edge

    if _is_dangling(a) != _is_dangling(b):
        dangler, obj = (a, b) if _is_dangling(a) else (b, a)
        if not isinstance(obj, ACADLObject):
            raise EdgeValidityError(f"cannot connect dangling edge to non-ACADL object {obj!r}")
        if dangler.source is not None:
            edge = ACADLEdge(dangler.source, obj, dangler.edge_type)
        else:
            edge = ACADLEdge(obj, dangler.target, dangler.edge_type)
        dangler.connected = True
        return edge

    raise EdgeValidityError("connect_dangling_edge needs at least one dangling edge")


# ---------------------------------------------------------------------------
# Builder context: @generate + create_ag()
# ---------------------------------------------------------------------------


class _AGBuilder:
    def __init__(self) -> None:
        self.objects: List[object] = []
        self.edges: List[ACADLEdge] = []
        self._names = set()

    def register_object(self, obj) -> None:
        if obj.name in self._names:
            raise ValueError(f"duplicate ACADL object name {obj.name!r} — names are unique identifiers")
        self._names.add(obj.name)
        self.objects.append(obj)

    def register_edge(self, edge: ACADLEdge) -> None:
        self.edges.append(edge)


_tls = threading.local()


def _builder_stack() -> List[_AGBuilder]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _current_builder() -> Optional[_AGBuilder]:
    stack = _builder_stack()
    return stack[-1] if stack else None


def generate(fn):
    """Decorator encapsulating an architecture implementation (paper §4.1).

    Calling the decorated function collects all objects/edges instantiated in
    its body (edge validity is checked at instantiation) and stores them for
    the next ``create_ag()`` call.  The decorated function's return value is
    passed through, so templates can hand back object handles.
    """

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        builder = _AGBuilder()
        _builder_stack().append(builder)
        try:
            result = fn(*args, **kwargs)
        finally:
            _builder_stack().pop()
        _tls.last_builder = builder
        return result

    wrapper.__acadl_generate__ = True
    return wrapper


def create_ag():
    """Instantiate the AG of the most recently generated architecture."""

    from .graph import ArchitectureGraph

    builder = getattr(_tls, "last_builder", None)
    if builder is None:
        raise RuntimeError("create_ag() called before any @generate-decorated function ran")
    return ArchitectureGraph(builder.objects, builder.edges)
