"""Tiled GeMM operator mappings onto ACADL models (paper §5).

Three abstraction levels, matching the paper's examples:

* ``oma_gemm_looped``   — scalar level with control flow (Listing 5 style):
  three nested register-counted loops around the built-in ``mac``.
* ``oma_gemm_unrolled`` — scalar level, branch-free, *tiled* execution order
  (the divide-and-conquer order of eq. (1)-(5)); tiling changes the cache hit
  pattern, which the timing simulation rewards — this is the knob the paper's
  ``oma_tiled_gemm(...)`` interface function exposes to TVM/UMA.
* ``gamma_gemm``        — fused-tensor level for Γ̈ (Listing 4 style):
  ``t_load``/``t_gemm``(+activation)/``t_add``/``t_store`` tile streams,
  round-robin across compute units.

Address map convention (row-major): A (m×n) at ``a_base + i*n + k``, B (n×l)
at ``b_base + k*l + j``, C (m×l) at ``c_base + i*l + j``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..acadl import Instruction
from ..acadl import isa
from ..acadl.asm import ProgramBuilder
from ..acadl.graph import ArchitectureGraph

__all__ = [
    "init_gemm_memory",
    "read_gemm_result",
    "oma_gemm_looped",
    "oma_gemm_unrolled",
    "gamma_gemm",
]


# ---------------------------------------------------------------------------
# data placement helpers
# ---------------------------------------------------------------------------


def init_gemm_memory(ag: ArchitectureGraph, a: np.ndarray, b: np.ndarray,
                     a_base: int = 0x1000, b_base: int = 0x2000,
                     c_base: int = 0x3000, memory: str = "dmem0",
                     tile: Optional[int] = None) -> Dict[str, int]:
    """Write A and B into the data memory word-by-word (scalar level) or
    tile-by-tile (fused-tensor level, ``tile`` = tile edge)."""
    mem = ag.by_name[memory]
    m, n = a.shape
    n2, l = b.shape
    assert n == n2
    if tile is None:
        for i in range(m):
            for k in range(n):
                mem.write(a_base + i * n + k, float(a[i, k]))
        for k in range(n):
            for j in range(l):
                mem.write(b_base + k * l + j, float(b[k, j]))
    else:
        # tile-granular addressing: one address per tile
        for ti in range(m // tile):
            for tk in range(n // tile):
                mem.write(a_base + ti * (n // tile) + tk,
                          a[ti * tile:(ti + 1) * tile, tk * tile:(tk + 1) * tile].copy())
        for tk in range(n // tile):
            for tj in range(l // tile):
                mem.write(b_base + tk * (l // tile) + tj,
                          b[tk * tile:(tk + 1) * tile, tj * tile:(tj + 1) * tile].copy())
    return {"a_base": a_base, "b_base": b_base, "c_base": c_base}


def read_gemm_result(ag: ArchitectureGraph, m: int, l: int, c_base: int = 0x3000,
                     memory: str = "dmem0", tile: Optional[int] = None) -> np.ndarray:
    mem = ag.by_name[memory]
    if tile is None:
        out = np.zeros((m, l))
        for i in range(m):
            for j in range(l):
                out[i, j] = mem.read(c_base + i * l + j)
        return out
    out = np.zeros((m, l))
    for ti in range(m // tile):
        for tj in range(l // tile):
            out[ti * tile:(ti + 1) * tile, tj * tile:(tj + 1) * tile] = \
                mem.read(c_base + ti * (l // tile) + tj)
    return out


# ---------------------------------------------------------------------------
# OMA scalar-level mappings
# ---------------------------------------------------------------------------


def oma_gemm_looped(m: int, n: int, l: int, a_base: int = 0x1000,
                    b_base: int = 0x2000, c_base: int = 0x3000) -> List[Instruction]:
    """Listing-5-style looped GeMM: registers count i/j/k, the built-in
    ``mac`` accumulates, branches close the loops."""
    pb = ProgramBuilder()
    pb.emit(isa.movi("r1", 0))                 # i = 0
    pb.label("Li")
    pb.emit(isa.movi("r2", 0))                 # j = 0
    pb.label("Lj")
    pb.emit(isa.movi("r8", 0))                 # acc = 0
    pb.emit(isa.movi("r3", 0))                 # k = 0
    pb.label("Lk")
    pb.emit(isa.muli("r4", "r1", n))           # r4 = i*n
    pb.emit(isa.add("r4", "r4", "r3"))         # r4 += k
    pb.emit(isa.addi("r4", "r4", a_base))      # r4 += a_base
    pb.emit(isa.load("r6", ("reg", "r4")))     # r6 = A[i,k]
    pb.emit(isa.muli("r5", "r3", l))           # r5 = k*l
    pb.emit(isa.add("r5", "r5", "r2"))         # r5 += j
    pb.emit(isa.addi("r5", "r5", b_base))      # r5 += b_base
    pb.emit(isa.load("r7", ("reg", "r5")))     # r7 = B[k,j]
    pb.emit(isa.mac("r8", "r6", "r7"))         # acc += A*B
    pb.emit(isa.addi("r3", "r3", 1))           # k += 1
    pb.branch_ne("r3", n, "Lk")
    pb.emit(isa.muli("r9", "r1", l))           # r9 = i*l
    pb.emit(isa.add("r9", "r9", "r2"))         # r9 += j
    pb.emit(isa.addi("r9", "r9", c_base))      # r9 += c_base
    pb.emit(isa.store("r8", ("reg", "r9")))    # C[i,j] = acc
    pb.emit(isa.addi("r2", "r2", 1))           # j += 1
    pb.branch_ne("r2", l, "Lj")
    pb.emit(isa.addi("r1", "r1", 1))           # i += 1
    pb.branch_ne("r1", m, "Li")
    return pb.build()


def oma_gemm_unrolled(m: int, n: int, l: int, tile_m: int = 0, tile_n: int = 0,
                      tile_l: int = 0, a_base: int = 0x1000, b_base: int = 0x2000,
                      c_base: int = 0x3000) -> List[Instruction]:
    """Branch-free scalar GeMM in *tiled* execution order.

    ``tile_* = 0`` means untiled (row-major ijk order).  With tiling, the
    (i,j,k) space is visited tile-by-tile per eq. (1)-(5): output tiles reuse
    A tiles across the j loop, which the data cache rewards.
    """
    tm = tile_m or m
    tn = tile_n or n
    tl = tile_l or l
    out: List[Instruction] = []
    for ti in range(0, m, tm):
        for tj in range(0, l, tl):
            # acc-per-output-element lives in r8 between k-tiles via C rewrite
            for i in range(ti, min(ti + tm, m)):
                for j in range(tj, min(tj + tl, l)):
                    out.append(isa.movi("r8", 0))
                    for tk in range(0, n, tn):
                        for k in range(tk, min(tk + tn, n)):
                            out.append(isa.load("r6", a_base + i * n + k))
                            out.append(isa.load("r7", b_base + k * l + j))
                            out.append(isa.mac("r8", "r6", "r7"))
                    out.append(isa.store("r8", c_base + i * l + j))
    return out


# ---------------------------------------------------------------------------
# Γ̈ fused-tensor-level mapping
# ---------------------------------------------------------------------------


def gamma_gemm(m: int, n: int, l: int, tile: int = 8,
               units: Sequence[Tuple[str, str, str]] = (("lsu0", "matMulFu0", "vrf0"),),
               a_base: int = 0x1000, b_base: int = 0x2000, c_base: int = 0x100000,
               activation: int = 0) -> List[Instruction]:
    """Fused-tensor tiled GeMM for Γ̈ (paper Listing 4).

    ``units`` is a sequence of (load/store MAU name, compute FU name, vector
    register prefix) triples; output tiles round-robin across them so
    instructions for different hardware components issue in parallel and
    execute out-of-order (paper §4.3).  The optional ``activation`` (1=ReLU)
    is applied by the *final* k-tile gemm of each output tile.

    ``c_base`` defaults into the DRAM range (reachable from every load/store
    unit).  Passing a scratchpad-range base (e.g. ``0x3000``) reproduces
    Listing 4's store-to-scratchpad — valid when every emitting unit is
    adjacent to that scratchpad (n_units <= 2 on the ring topology).
    """
    assert m % tile == 0 and n % tile == 0 and l % tile == 0
    mt, nt, lt = m // tile, n // tile, l // tile
    prog: List[Instruction] = []
    u = 0
    for ti in range(mt):
        for tj in range(lt):
            lsu, cfu, vrf = units[u % len(units)]
            u += 1
            acc_reg = f"{vrf}.acc"
            for tk in range(nt):
                a_addr = a_base + ti * nt + tk
                b_addr = b_base + tk * lt + tj
                ra, rb = f"{vrf}.a", f"{vrf}.b"
                prog.append(isa.t_load(ra, a_addr, (tile, tile), unit=lsu))
                prog.append(isa.t_load(rb, b_addr, (tile, tile), unit=lsu))
                last = tk == nt - 1
                act = activation if last else 0
                if tk == 0:
                    prog.append(isa.t_gemm(acc_reg, ra, rb, activation=act, unit=cfu,
                                           tile=(tile, tile, tile)))
                else:
                    prog.append(isa.t_gemm(acc_reg, ra, rb, activation=act,
                                           acc=acc_reg, unit=cfu,
                                           tile=(tile, tile, tile)))
            prog.append(isa.t_store(acc_reg, c_base + ti * lt + tj,
                                    shape=(tile, tile), unit=lsu))
    return prog
