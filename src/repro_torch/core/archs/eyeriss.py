"""Eyeriss-v1-derived accelerator model (paper §6 references [26]).

Row-stationary CNN accelerator modeled at the *tensor* abstraction level:
each PE processes 1-D convolution rows (``row_conv``) and partial-sum
accumulation (``psum_add``); a global buffer (GLB) SRAM sits between the DRAM
and the PE array; per-row load units multicast filter/ifmap rows into PE
register files, per-row store units drain psums back to the GLB.

The grid is ``rows × columns`` (Eyeriss v1: 12 × 14).  Row-stationary
dataflow: filter rows stay in a PE, ifmap rows slide diagonally, psums move
vertically — here the *dependency structure* of the emitted instruction
stream encodes the dataflow; the timing simulation extracts the parallelism.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..acadl import (
    ACADLEdge,
    CONTAINS,
    Data,
    DRAM,
    ExecuteStage,
    FORWARD,
    FunctionalUnit,
    InstructionFetchStage,
    InstructionMemoryAccessUnit,
    MemoryAccessUnit,
    READ_DATA,
    RegisterFile,
    SRAM,
    WRITE_DATA,
    create_ag,
    generate,
    latency_t,
)

__all__ = ["EyerissPE", "generate_eyeriss", "make_eyeriss_ag"]


class EyerissPE:
    """PE template: spad register file + MAC pipeline processing whole rows.

    ``row_conv`` latency = output-row taps (macs tag); matches Eyeriss's
    one-MAC-per-cycle PE with operand spads.
    """

    def __init__(self, row: int, col: int):
        self.ex = ExecuteStage(name=f"eex[{row}][{col}]", latency=latency_t(1))
        self.fu = FunctionalUnit(
            name=f"efu[{row}][{col}]",
            to_process={"row_conv", "psum_add"},
            latency=latency_t(lambda operation="", macs=1, words=1, **_: max(1, macs)),
        )
        regs = {f"w[{row}][{col}]": Data(512, None),     # filter row (stationary)
                f"ifm[{row}][{col}]": Data(512, None),   # ifmap row (sliding)
                f"ps[{row}][{col}]": Data(512, None)}    # psum row
        self.rf = RegisterFile(name=f"erf[{row}][{col}]", data_width=512,
                               registers=regs)
        ACADLEdge(self.ex, self.fu, CONTAINS)
        ACADLEdge(self.rf, self.fu, READ_DATA)
        ACADLEdge(self.fu, self.rf, WRITE_DATA)


@generate
def generate_eyeriss(rows: int = 12, columns: int = 14, *,
                     glb_kw: Optional[dict] = None,
                     port_width: int = 16,
                     issue_buffer_size: int = 64) -> Dict[str, object]:
    imem0 = SRAM(name="imem0", read_latency=1, write_latency=1,
                 address_ranges=((0, 1 << 22),), port_width=port_width)
    pcrf0 = RegisterFile(name="pcrf0", data_width=32,
                         registers={"pc": Data(32, 0)})
    ifs0 = InstructionFetchStage(name="ifs0", latency=latency_t(1),
                                 issue_buffer_size=issue_buffer_size)
    imau0 = InstructionMemoryAccessUnit(name="imau0", latency=latency_t(0))
    ACADLEdge(imem0, imau0, READ_DATA)
    ACADLEdge(pcrf0, imau0, READ_DATA)
    ACADLEdge(imau0, pcrf0, WRITE_DATA)
    ACADLEdge(ifs0, imau0, CONTAINS)

    dram0 = DRAM(name="dram0", read_latency=20, write_latency=20,
                 address_ranges=((1 << 20, 1 << 22),), port_width=8,
                 max_concurrent_requests=2, read_write_ports=1)
    # 108 KB global buffer; row-granular addressing below 1<<20
    glb0 = SRAM(name="glb0", read_latency=2, write_latency=2,
                address_ranges=((0, 1 << 20),), port_width=32,
                max_concurrent_requests=4,
                read_write_ports=2 * rows + 2,
                **(glb_kw or {}))

    # DMA between DRAM and GLB
    dma_ex = ExecuteStage(name="edma_ex", latency=latency_t(1))
    dma = MemoryAccessUnit(name="edma", to_process={"t_load", "t_store"},
                           latency=latency_t(1))
    ACADLEdge(dma_ex, dma, CONTAINS)
    ACADLEdge(dram0, dma, READ_DATA)
    ACADLEdge(dma, dram0, WRITE_DATA)
    ACADLEdge(glb0, dma, READ_DATA)
    ACADLEdge(dma, glb0, WRITE_DATA)
    ACADLEdge(ifs0, dma_ex, FORWARD)
    # DMA needs a staging register file
    dma_rf = RegisterFile(name="edma_rf", data_width=512,
                          registers={f"stage{i}": Data(512, None) for i in range(8)})
    ACADLEdge(dma_rf, dma, READ_DATA)
    ACADLEdge(dma, dma_rf, WRITE_DATA)

    pes: List[List[EyerissPE]] = []
    for r in range(rows):
        pes.append([EyerissPE(r, c) for c in range(columns)])

    # per-row load unit (GLB -> PE rfs of that row) and store unit
    loaders, stores = [], []
    for r in range(rows):
        lex = ExecuteStage(name=f"elu_ex{r}", latency=latency_t(1))
        lmau = MemoryAccessUnit(name=f"elu{r}", to_process={"t_load"},
                                latency=latency_t(1))
        ACADLEdge(lex, lmau, CONTAINS)
        ACADLEdge(glb0, lmau, READ_DATA)
        for c in range(columns):
            ACADLEdge(lmau, pes[r][c].rf, WRITE_DATA)
        ACADLEdge(ifs0, lex, FORWARD)
        loaders.append(lmau)

        sex = ExecuteStage(name=f"esu_ex{r}", latency=latency_t(1))
        smau = MemoryAccessUnit(name=f"esu{r}", to_process={"t_store"},
                                latency=latency_t(1))
        ACADLEdge(sex, smau, CONTAINS)
        for c in range(columns):
            ACADLEdge(pes[r][c].rf, smau, READ_DATA)
        ACADLEdge(smau, glb0, WRITE_DATA)
        ACADLEdge(ifs0, sex, FORWARD)
        stores.append(smau)

    # vertical psum accumulation: PE (r,c) writes psum into (r-1,c)
    for r in range(1, rows):
        for c in range(columns):
            ACADLEdge(pes[r][c].fu, pes[r - 1][c].rf, WRITE_DATA)

    for r in range(rows):
        for c in range(columns):
            ACADLEdge(ifs0, pes[r][c].ex, FORWARD)

    return {"pes": pes, "glb0": glb0, "dram0": dram0, "loaders": loaders,
            "stores": stores, "dma": dma, "rows": rows, "columns": columns}


def make_eyeriss_ag(rows: int = 12, columns: int = 14, **params):
    handles = generate_eyeriss(rows, columns, **params)
    ag = create_ag()
    return ag, handles
