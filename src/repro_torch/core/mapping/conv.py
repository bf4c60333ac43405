"""Convolution mappings (paper §5 mentions conv via input transformations).

* ``eyeriss_conv2d`` — row-stationary dataflow on the Eyeriss-derived model
  (paper §6 references [26]): filter rows stay in a PE, ifmap rows slide
  diagonally, psums accumulate vertically.  One ``row_conv`` instruction =
  one 1-D convolution of an ifmap row with a filter row; ``psum_add``
  merges partials down each column.
* ``oma_conv2d_im2col`` — scalar fallback: im2col + the OMA tiled GeMM
  (the §5 "input data transformations" path).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..acadl import Instruction
from ..acadl.base import ExecutionEnv
from ..acadl.graph import ArchitectureGraph

__all__ = ["init_conv_memory", "eyeriss_conv2d", "read_conv_result"]

IFM_BASE = 0x0          # GLB rows: one address per ifmap/filter/psum row
FLT_BASE = 0x40000
PSUM_BASE = 0x80000


def init_conv_memory(ag: ArchitectureGraph, ifmap: np.ndarray,
                     filt: np.ndarray, glb: str = "glb0") -> None:
    """ifmap (H, W), filt (R, S) — row-granular placement in the GLB."""
    mem = ag.by_name[glb]
    for r in range(ifmap.shape[0]):
        mem.write(IFM_BASE + r, ifmap[r].astype(np.float64).copy())
    for r in range(filt.shape[0]):
        mem.write(FLT_BASE + r, filt[r].astype(np.float64).copy())


def read_conv_result(ag: ArchitectureGraph, out_h: int,
                     glb: str = "glb0") -> np.ndarray:
    mem = ag.by_name[glb]
    rows = [np.asarray(mem.read(PSUM_BASE + r)) for r in range(out_h)]
    return np.stack(rows)


def _t_load_row(dst: str, addr: int, words: int, unit: str) -> Instruction:
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_reg(dst, env.read_mem(addr))
    return Instruction("t_load", (), (dst,), read_addresses=(addr,),
                       function=fn, unit_hint=unit, tags={"words": words})


def _t_store_row(src: str, addr: int, words: int, unit: str) -> Instruction:
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_mem(addr, env.read_reg(src))
    return Instruction("t_store", (src,), (), write_addresses=(addr,),
                       function=fn, unit_hint=unit, tags={"words": words})


def _row_conv(r: int, c: int, out_w: int, flt_w: int, unit: str) -> Instruction:
    """ps[r][c] = conv1d(ifm[r][c], w[r][c]) — valid mode."""
    w_reg, i_reg, p_reg = f"w[{r}][{c}]", f"ifm[{r}][{c}]", f"ps[{r}][{c}]"

    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        w = np.asarray(env.read_reg(w_reg))
        x = np.asarray(env.read_reg(i_reg))
        out = np.asarray([np.dot(x[j:j + len(w)], w)
                          for j in range(len(x) - len(w) + 1)])
        env.write_reg(p_reg, out)
    return Instruction("row_conv", (w_reg, i_reg), (p_reg,), function=fn,
                       unit_hint=unit,
                       tags={"words": out_w, "macs": out_w * flt_w})


def _psum_add(r_src: int, r_dst: int, c: int, out_w: int, unit: str) -> Instruction:
    """ps[r_dst][c] += ps[r_src][c] (vertical accumulation)."""
    src, dst = f"ps[{r_src}][{c}]", f"ps[{r_dst}][{c}]"

    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_reg(dst, np.asarray(env.read_reg(dst)) +
                      np.asarray(env.read_reg(src)))
    return Instruction("psum_add", (src, dst), (dst,), function=fn,
                       unit_hint=unit, tags={"words": out_w, "macs": out_w})


def eyeriss_conv2d(ifm_h: int, ifm_w: int, flt_h: int, flt_w: int,
                   rows: int, columns: int) -> List[Instruction]:
    """Row-stationary single-channel conv2d (valid).

    PE (r, c) holds filter row r and processes output rows assigned to
    logical column c; psums accumulate up the column (PE r adds into
    PE r-1, row 0 stores).  Output rows are striped over `columns`.
    """
    out_h = ifm_h - flt_h + 1
    out_w = ifm_w - flt_w + 1
    assert flt_h <= rows, (flt_h, rows)
    prog: List[Instruction] = []

    # load filter rows (stationary) into every active column
    for c in range(min(columns, out_h)):
        for r in range(flt_h):
            prog.append(_t_load_row(f"w[{r}][{c}]", FLT_BASE + r, flt_w,
                                    f"elu{r}"))

    for o in range(out_h):
        c = o % columns
        # ifmap rows o..o+flt_h-1 slide into the column's PEs
        for r in range(flt_h):
            prog.append(_t_load_row(f"ifm[{r}][{c}]", IFM_BASE + o + r,
                                    ifm_w, f"elu{r}"))
            prog.append(_row_conv(r, c, out_w, flt_w, f"efu[{r}][{c}]"))
        # vertical psum accumulation into row 0
        for r in range(flt_h - 1, 0, -1):
            prog.append(_psum_add(r, r - 1, c, out_w, f"efu[{r-1}][{c}]"))
        prog.append(_t_store_row(f"ps[0][{c}]", PSUM_BASE + o, out_w,
                                 f"esu{0}"))
    return prog
