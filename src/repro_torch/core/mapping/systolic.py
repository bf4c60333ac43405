"""Output-stationary GeMM mapping for the parameterizable systolic array
(paper §4.2, Fig. 4).

Dataflow: activations (A) stream right through the ``a`` channel, weights
(B) stream down through the ``b`` channel, each PE accumulates its output
element in ``acc``.  After the K reduction, results drain right through the
``a`` channel into the per-row store units.

The instruction stream is emitted in program order; the skewed wavefront
emerges from the register dependencies (PE (r,c)'s mac at step k reads the
``a`` forwarded by PE (r,c-1) at step k and the ``b`` forwarded by PE
(r-1,c)), which the out-of-order issue of the timing simulation resolves —
exactly the paper's "multiple instructions can be forwarded out-of-order at
the same time" semantics.

Matrices larger than the array are tiled over (rows × columns) output tiles;
the K dimension streams fully through each tile residency.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..acadl import Instruction
from ..acadl.base import ExecutionEnv
from ..acadl.graph import ArchitectureGraph

__all__ = [
    "systolic_gemm_program",
    "init_systolic_memory",
    "read_systolic_result",
]


# -- architecture-specific instruction builders --------------------------------


def _sa_load(dst: str, addr: int, unit: str) -> Instruction:
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_reg(dst, env.read_mem(addr))
    return Instruction("load", (), (dst,), read_addresses=(addr,), function=fn,
                       unit_hint=unit)


def _sa_store(src: str, addr: int, unit: str) -> Instruction:
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_mem(addr, env.read_reg(src))
    return Instruction("store", (src,), (), write_addresses=(addr,), function=fn,
                       unit_hint=unit)


def _sa_mac_fwd(r: int, c: int, rows: int, cols: int, unit: str,
                a_fwd: Optional[str], b_fwd: Optional[str]) -> Instruction:
    """acc[r][c] += a*b; forward a right and b down (when neighbours exist)."""
    a_reg, b_reg, acc_reg = f"a[{r}][{c}]", f"b[{r}][{c}]", f"acc[{r}][{c}]"
    writes = (acc_reg,) + ((a_fwd,) if a_fwd else ()) + ((b_fwd,) if b_fwd else ())

    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        a, b = env.read_reg(a_reg), env.read_reg(b_reg)
        env.write_reg(acc_reg, env.read_reg(acc_reg) + a * b)
        if a_fwd:
            env.write_reg(a_fwd, a)
        if b_fwd:
            env.write_reg(b_fwd, b)
    return Instruction("mac_fwd", (a_reg, b_reg, acc_reg), writes, function=fn,
                       unit_hint=unit)


def _sa_init_acc(r: int, c: int, unit: str) -> Instruction:
    acc_reg = f"acc[{r}][{c}]"

    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_reg(acc_reg, 0)
    return Instruction("drain", (), (acc_reg,), function=fn, unit_hint=unit)


def _sa_drain(src: str, dst: str, unit: str) -> Instruction:
    """Move a value one hop right along the a/drain channel."""
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_reg(dst, env.read_reg(src))
    return Instruction("drain", (src,), (dst,), function=fn, unit_hint=unit)


# -- data placement --------------------------------------------------------------


def init_systolic_memory(ag: ArchitectureGraph, a: np.ndarray, b: np.ndarray,
                         a_base: int = 0x1000, b_base: int = 0x40000,
                         memory: str = "dram0") -> None:
    mem = ag.by_name[memory]
    m, k = a.shape
    k2, l = b.shape
    assert k == k2
    for i in range(m):
        for kk in range(k):
            mem.write(a_base + i * k + kk, float(a[i, kk]))
    for kk in range(k):
        for j in range(l):
            mem.write(b_base + kk * l + j, float(b[kk, j]))


def read_systolic_result(ag: ArchitectureGraph, m: int, l: int,
                         c_base: int = 0x80000, memory: str = "dram0") -> np.ndarray:
    mem = ag.by_name[memory]
    out = np.zeros((m, l))
    for i in range(m):
        for j in range(l):
            out[i, j] = mem.read(c_base + i * l + j)
    return out


# -- program generation ------------------------------------------------------------


def systolic_gemm_program(m: int, k: int, l: int, rows: int, columns: int,
                          a_base: int = 0x1000, b_base: int = 0x40000,
                          c_base: int = 0x80000) -> List[Instruction]:
    """Emit the full instruction stream for C(m×l) = A(m×k) B(k×l) on a
    rows×columns output-stationary array.  m and l are tiled by the array
    shape; ragged edges fall back to partially-used PEs."""
    prog: List[Instruction] = []
    for ti in range(0, m, rows):
        tr = min(rows, m - ti)          # active rows in this tile
        for tj in range(0, l, columns):
            tc = min(columns, l - tj)   # active columns
            prog.extend(_tile_program(ti, tj, tr, tc, k, l, rows, columns,
                                      a_base + ti * k, b_base + tj,
                                      c_base + ti * l + tj))
    return prog


def _tile_program(ti: int, tj: int, tr: int, tc: int, k: int, l: int,
                  rows: int, columns: int, a_tile_base: int, b_tile_base: int,
                  c_tile_base: int) -> List[Instruction]:
    prog: List[Instruction] = []
    # 1. reset accumulators of active PEs
    for r in range(tr):
        for c in range(tc):
            prog.append(_sa_init_acc(r, c, f"fu[{r}][{c}]"))

    # 2. K reduction: stream A right / B down, mac everywhere
    for kk in range(k):
        for r in range(tr):  # A[r, kk] enters column 0 of row r
            prog.append(_sa_load(f"a[{r}][0]", a_tile_base + r * k + kk,
                                 f"mau_lu_row{r}"))
        for c in range(tc):  # B[kk, c] enters row 0 of column c
            prog.append(_sa_load(f"b[0][{c}]", b_tile_base + kk * l + c,
                                 f"mau_lu_col{c}"))
        for r in range(tr):
            for c in range(tc):
                a_fwd = f"a[{r}][{c + 1}]" if c + 1 < tc else None
                b_fwd = f"b[{r + 1}][{c}]" if r + 1 < tr else None
                prog.append(_sa_mac_fwd(r, c, rows, columns, f"fu[{r}][{c}]",
                                        a_fwd, b_fwd))

    # 3. drain: shift accumulators right through the a-channel into the
    # per-row store unit register, rightmost column first; partial tiles
    # keep hopping through the inactive PEs to the physical last column
    for r in range(tr):
        for s in range(tc):
            src_col = tc - 1 - s
            cur = f"acc[{r}][{src_col}]"
            for cc in range(src_col, columns):
                dst = (f"out_su_row{r}" if cc == columns - 1
                       else f"a[{r}][{cc + 1}]")
                prog.append(_sa_drain(cur, dst, f"fu[{r}][{cc}]"))
                cur = dst
            prog.append(_sa_store(f"out_su_row{r}",
                                  c_tile_base + r * l + src_col,
                                  f"mau_su_row{r}"))
    return prog
