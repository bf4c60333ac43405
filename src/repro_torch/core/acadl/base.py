"""ACADL base classes: ACADLObject, Data, latency_t, Instruction.

Faithful to Müller et al. 2024 §3 (Fig. 1 class diagram):

* ``ACADLObject`` is the virtual base class; its only attribute is ``name``,
  the unique identifier of each object.
* ``Data`` represents any data stored in memories, registers and immediates.
  ``size`` is the data size in bits, ``payload`` the value used by the
  functional simulation.
* ``latency_t`` describes a time delta in clock cycles — either a constant
  integer or a function evaluated during performance estimation (the paper
  allows a string containing a function; we accept callables and strings).
* ``Instruction`` carries read/write register sets, read/write memory address
  sets, immediates, a mnemonic (``operation``) and a ``function`` implementing
  the data manipulation for the functional simulation.  Instructions are not
  limited to fine-grained operations: a single instruction may perform a
  matrix-matrix multiplication (fused-tensor abstraction level).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple, Union

__all__ = [
    "ACADLObject",
    "Data",
    "latency_t",
    "LatencyLike",
    "Instruction",
]


class latency_t:
    """A time delta in clock cycles.

    Either a non-negative integer constant, or a callable/str expression
    evaluated at simulation time with a context dict (e.g. the accessed
    address, current cycle, stateful memory model).  ``latency_t(1)`` mirrors
    the paper's Python front-end notation.
    """

    __slots__ = ("value", "fn", "expr")

    def __init__(self, value: Union[int, str, Callable[..., int]]):
        self.fn: Optional[Callable[..., int]] = None
        self.expr: Optional[str] = None
        if isinstance(value, latency_t):
            self.value = value.value
            self.fn = value.fn
            self.expr = value.expr
        elif isinstance(value, int):
            if value < 0:
                raise ValueError(f"latency must be >= 0, got {value}")
            self.value = value
        elif callable(value):
            self.value = None
            self.fn = value
        elif isinstance(value, str):
            # The paper allows "a string containing a function that is
            # evaluated during the performance estimation".
            self.value = None
            self.expr = value
        else:
            raise TypeError(f"latency_t expects int, str or callable, got {type(value)}")

    def is_static(self) -> bool:
        return self.value is not None

    def resolve(self, **ctx: Any) -> int:
        if self.value is not None:
            return self.value
        if self.fn is not None:
            return int(self.fn(**ctx))
        assert self.expr is not None
        return int(eval(self.expr, {"__builtins__": {}}, dict(ctx)))  # noqa: S307 - paper-specified semantics

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        if self.value is not None:
            return f"latency_t({self.value})"
        return f"latency_t(<dynamic {self.expr or self.fn}>)"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, int):
            return self.value == other
        if isinstance(other, latency_t):
            return (self.value, self.expr) == (other.value, other.expr) and self.fn is other.fn
        return NotImplemented

    def __hash__(self) -> int:
        return hash((self.value, self.expr, id(self.fn)))


LatencyLike = Union[int, str, Callable[..., int], latency_t]


def _as_latency(value: LatencyLike) -> latency_t:
    return value if isinstance(value, latency_t) else latency_t(value)


class ACADLObject:
    """Virtual base class for every computer-architecture module in ACADL."""

    _registry_counter = itertools.count()

    def __init__(self, name: str):
        if not isinstance(name, str) or not name:
            raise ValueError("ACADLObject requires a non-empty string name")
        self.name = name
        # creation order — used for deterministic AG iteration
        self._uid = next(ACADLObject._registry_counter)
        from .edges import _current_builder  # local import to avoid a cycle

        builder = _current_builder()
        if builder is not None:
            builder.register_object(self)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{type(self).__name__}(name={self.name!r})"


@dataclass
class Data:
    """Any data stored in memories, registers and immediates.

    ``size`` is the size in bits; ``payload`` is the actual value used by the
    functional simulation (int, float, numpy array for tensor-level data, ...).
    """

    size: int
    payload: Any = None

    def copy(self) -> "Data":
        return Data(self.size, self.payload)


@dataclass
class Instruction:
    """A unit of architectural state change (paper §3).

    ``operation`` is the mnemonic; ``function`` manipulates data when the
    instruction is processed by a FunctionalUnit (functional simulation).
    ``read_registers``/``write_registers`` name registers, while
    ``read_addresses``/``write_addresses`` are memory addresses.  Addresses may
    be given indirectly as ``("reg", name)`` tuples resolved against a register
    file at execution time (register-indirect addressing, cf. Listing 5's
    ``load [r9] => r6``).

    ``unit_hint`` optionally pins the instruction to a named
    FunctionalUnit/ExecuteStage — used by the operator-mapping layer to emit
    deterministic schedules that the AIDG estimator and the event-driven
    simulator agree on.
    """

    operation: str
    read_registers: Tuple[str, ...] = ()
    write_registers: Tuple[str, ...] = ()
    read_addresses: Tuple[Any, ...] = ()
    write_addresses: Tuple[Any, ...] = ()
    immediates: Tuple[Any, ...] = ()
    function: Optional[Callable[..., Any]] = None
    size: int = 32
    unit_hint: Optional[str] = None
    # free-form metadata (e.g. tensor tile coordinates); never inspected by
    # the simulator, useful for debugging and benchmarks.
    tags: Dict[str, Any] = field(default_factory=dict)

    def execute(self, env: "ExecutionEnv") -> None:
        """Run ``function`` against an execution environment.

        Called by FunctionalUnit.process() during the functional simulation.
        """
        if self.function is not None:
            self.function(env, self)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        rr = ",".join(map(str, self.read_registers))
        wr = ",".join(map(str, self.write_registers))
        return f"Instruction({self.operation} r[{rr}] -> w[{wr}])"


class ExecutionEnv:
    """Register/memory access facade handed to Instruction.function.

    Bridges the functional simulation to RegisterFiles and DataStorages that
    the executing FunctionalUnit is connected to.
    """

    def __init__(self, read_reg: Callable[[str], Any], write_reg: Callable[[str, Any], None],
                 read_mem: Callable[[int], Any], write_mem: Callable[[int, Any], None]):
        self.read_reg = read_reg
        self.write_reg = write_reg
        self.read_mem = read_mem
        self.write_mem = write_mem
