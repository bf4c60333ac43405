"""Parallel-pattern mapping for the Plasticine-derived model (paper §6
references [27]): map / reduce pipelines over PMU-resident vectors.

``plasticine_map_reduce`` computes ``reduce(+, map(f, x))`` for a vector
striped across the PMUs: each PCU loads its stripe, applies the map in its
SIMD pipeline, reduces locally, and PCU 0 combines the partials — the
canonical Plasticine execution of a parallel pattern.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np

from ..acadl import Instruction
from ..acadl.base import ExecutionEnv
from ..acadl.graph import ArchitectureGraph
from .workload import _tiles  # noqa: F401  (shared helper)

__all__ = ["init_vector_memory", "plasticine_map_reduce", "read_scalar"]

PMU_WINDOW = 0x10000


def init_vector_memory(ag: ArchitectureGraph, x: np.ndarray, n_pmu: int) -> None:
    stripes = np.array_split(x.astype(np.float64), n_pmu)
    for j, s in enumerate(stripes):
        ag.by_name[f"pmu{j}"].write(j * PMU_WINDOW, s.copy())


def read_scalar(ag: ArchitectureGraph, n_pmu: int) -> float:
    out = ag.by_name["pmu0"].read(0 * PMU_WINDOW + 1)
    return float(np.asarray(out).sum())


def _map_op(dst: str, src: str, fn_name: str, unit: str, words: int) -> Instruction:
    f = {"square": lambda v: v * v, "relu": lambda v: np.maximum(v, 0),
         "exp": np.exp}[fn_name]

    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_reg(dst, f(np.asarray(env.read_reg(src))))
    return Instruction("map", (src,), (dst,), function=fn, unit_hint=unit,
                       tags={"words": words})


def _reduce_op(dst: str, src: str, unit: str, words: int) -> Instruction:
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_reg(dst, np.asarray(env.read_reg(src)).sum(keepdims=True))
    return Instruction("reduce", (src,), (dst,), function=fn, unit_hint=unit,
                       tags={"words": words})


def _combine(dst: str, a: str, b: str, unit: str) -> Instruction:
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_reg(dst, np.asarray(env.read_reg(a)) +
                      np.asarray(env.read_reg(b)))
    return Instruction("matadd", (a, b), (dst,), function=fn, unit_hint=unit,
                       tags={"words": 1})


def _ld(dst: str, addr: int, unit: str, words: int) -> Instruction:
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_reg(dst, env.read_mem(addr))
    return Instruction("t_load", (), (dst,), read_addresses=(addr,),
                       function=fn, unit_hint=unit, tags={"words": words})


def _st(src: str, addr: int, unit: str, words: int = 1) -> Instruction:
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_mem(addr, env.read_reg(src))
    return Instruction("t_store", (src,), (), write_addresses=(addr,),
                       function=fn, unit_hint=unit, tags={"words": words})


def plasticine_map_reduce(n: int, n_pcu: int, n_pmu: int,
                          map_fn: str = "square") -> List[Instruction]:
    """sum(map_fn(x)) with x striped over the PMUs, one PCU per stripe."""
    prog: List[Instruction] = []
    stripe = -(-n // n_pmu)
    active = min(n_pcu, n_pmu)
    # each PCU: load stripe -> map -> local reduce
    for i in range(active):
        prog.append(_ld(f"v{i}.0", i * PMU_WINDOW, f"pcu_mau{i}", stripe))
        prog.append(_map_op(f"v{i}.1", f"v{i}.0", map_fn, f"pcu_fu{i}", stripe))
        prog.append(_reduce_op(f"v{i}.2", f"v{i}.1", f"pcu_fu{i}", stripe))
        prog.append(_st(f"v{i}.2", i * PMU_WINDOW + 2, f"pcu_mau{i}"))
    # PCU 0 combines the partials (reads every PMU)
    prog.append(_ld("v0.3", 0 * PMU_WINDOW + 2, "pcu_mau0", 1))
    for i in range(1, active):
        prog.append(_ld("v0.4", i * PMU_WINDOW + 2, "pcu_mau0", 1))
        prog.append(_combine("v0.3", "v0.3", "v0.4", "pcu_fu0"))
    prog.append(_st("v0.3", 0 * PMU_WINDOW + 1, "pcu_mau0"))
    return prog
