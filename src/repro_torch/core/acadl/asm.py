"""Tiny label-resolving assembler for ACADL scalar programs.

Branch instructions take offsets relative to the next instruction; writing
loops by hand is error-prone, so ``ProgramBuilder`` provides labels:

    pb = ProgramBuilder()
    pb.emit(isa.movi("r1", 0))
    pb.label("loop")
    ...
    pb.branch_ne("r1", 8, "loop")
    program = pb.build()
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple, Union

from . import isa
from .base import Instruction

__all__ = ["ProgramBuilder"]


class ProgramBuilder:
    def __init__(self) -> None:
        # entries: Instruction | ("branch", maker(offset)->Instruction, label)
        self._items: List[Union[Instruction, Tuple[str, Callable[[int], Instruction], str]]] = []
        self._labels: Dict[str, int] = {}

    def emit(self, instr: Instruction) -> "ProgramBuilder":
        self._items.append(instr)
        return self

    def label(self, name: str) -> "ProgramBuilder":
        if name in self._labels:
            raise ValueError(f"duplicate label {name!r}")
        self._labels[name] = len(self._items)
        return self

    def branch_eq(self, src: str, imm, label: str) -> "ProgramBuilder":
        self._items.append(("branch", lambda off: isa.beqi(src, imm, off), label))
        return self

    def branch_ne(self, src: str, imm, label: str) -> "ProgramBuilder":
        self._items.append(("branch", lambda off: isa.bnei(src, imm, off), label))
        return self

    def jump(self, label: str) -> "ProgramBuilder":
        self._items.append(("branch", lambda off: isa.jumpi(off), label))
        return self

    def build(self) -> List[Instruction]:
        program: List[Instruction] = []
        for i, item in enumerate(self._items):
            if isinstance(item, Instruction):
                program.append(item)
            else:
                _, maker, label = item
                if label not in self._labels:
                    raise ValueError(f"undefined label {label!r}")
                offset = self._labels[label] - (i + 1)
                program.append(maker(offset))
        return program

    def __len__(self) -> int:
        return len(self._items)
