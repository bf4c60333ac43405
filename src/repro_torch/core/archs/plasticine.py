"""Plasticine-derived reconfigurable parallel-patterns accelerator
(paper §6 references [27]).

Modeled at the tensor level: Pattern Compute Units (PCUs) are ExecuteStages
holding a SIMD ``map``/``reduce`` FunctionalUnit over vector registers;
Pattern Memory Units (PMUs) are banked SRAM scratchpads with address-stream
MAUs; a shared DRAM feeds the PMUs through DMA MAUs.  The checkerboard
interconnect of the real chip is abstracted to PCU<->PMU register/storage
edges (ACADL models dependencies, not wires — paper §3).
"""

from __future__ import annotations

from typing import Dict, List, Optional

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

__all__ = ["generate_plasticine", "make_plasticine_ag"]

PMU_WINDOW = 0x10000  # address window per PMU


@generate
def generate_plasticine(n_pcu: int = 4, n_pmu: int = 4, *, simd_lanes: int = 16,
                        pipeline_depth: int = 6, port_width: int = 8,
                        issue_buffer_size: int = 64,
                        dram_kw: Optional[dict] = None) -> Dict[str, object]:
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

    dram0 = DRAM(name="dram0", read_latency=24, write_latency=24,
                 address_ranges=((n_pmu * PMU_WINDOW, 1 << 26),), port_width=16,
                 max_concurrent_requests=4, read_write_ports=n_pmu + 1,
                 **(dram_kw or {}))

    lanes = simd_lanes

    pmus, pmu_maus = [], []
    for j in range(n_pmu):
        pmu = SRAM(name=f"pmu{j}", read_latency=1, write_latency=1,
                   address_ranges=((j * PMU_WINDOW, (j + 1) * PMU_WINDOW),),
                   port_width=lanes, max_concurrent_requests=2,
                   read_write_ports=n_pcu + 2)
        # DMA engine DRAM <-> PMU
        dex = ExecuteStage(name=f"pdma_ex{j}", latency=latency_t(1))
        dma = MemoryAccessUnit(name=f"pdma{j}", to_process={"t_load", "t_store"},
                               latency=latency_t(1))
        drf = RegisterFile(name=f"pdma_rf{j}", data_width=32 * lanes,
                           registers={f"dstage{j}.{i}": Data(32 * lanes, None)
                                      for i in range(4)})
        ACADLEdge(dex, dma, CONTAINS)
        ACADLEdge(dram0, dma, READ_DATA)
        ACADLEdge(dma, dram0, WRITE_DATA)
        ACADLEdge(pmu, dma, READ_DATA)
        ACADLEdge(dma, pmu, WRITE_DATA)
        ACADLEdge(drf, dma, READ_DATA)
        ACADLEdge(dma, drf, WRITE_DATA)
        ACADLEdge(ifs0, dex, FORWARD)
        pmus.append(pmu)
        pmu_maus.append(dma)

    pcus = []
    for i in range(n_pcu):
        ex = ExecuteStage(name=f"pcu_ex{i}", latency=latency_t(1))
        # SIMD pipeline: `words` elements at `lanes`/cycle after fill
        fu = FunctionalUnit(
            name=f"pcu_fu{i}",
            to_process={"map", "reduce", "matadd", "scan"},
            latency=latency_t(lambda operation="", words=lanes, **_:
                              pipeline_depth + max(1, words // lanes)),
        )
        rf = RegisterFile(name=f"pcu_rf{i}", data_width=32 * lanes,
                          registers={f"v{i}.{r}": Data(32 * lanes, None)
                                     for r in range(16)})
        # per-PCU scratchpad access unit (reads/writes any PMU)
        mex = ExecuteStage(name=f"pcu_mex{i}", latency=latency_t(1))
        mau = MemoryAccessUnit(name=f"pcu_mau{i}", to_process={"t_load", "t_store"},
                               latency=latency_t(1))
        ACADLEdge(ex, fu, CONTAINS)
        ACADLEdge(rf, fu, READ_DATA)
        ACADLEdge(fu, rf, WRITE_DATA)
        ACADLEdge(mex, mau, CONTAINS)
        ACADLEdge(rf, mau, READ_DATA)
        ACADLEdge(mau, rf, WRITE_DATA)
        for pmu in pmus:
            ACADLEdge(pmu, mau, READ_DATA)
            ACADLEdge(mau, pmu, WRITE_DATA)
        ACADLEdge(ifs0, ex, FORWARD)
        ACADLEdge(ifs0, mex, FORWARD)
        pcus.append({"ex": ex, "fu": fu, "rf": rf, "mau": mau})

    return {"pcus": pcus, "pmus": pmus, "pmu_maus": pmu_maus, "dram0": dram0,
            "simd_lanes": lanes, "n_pcu": n_pcu, "n_pmu": n_pmu}


def make_plasticine_ag(n_pcu: int = 4, n_pmu: int = 4, **params):
    handles = generate_plasticine(n_pcu, n_pmu, **params)
    ag = create_ag()
    return ag, handles
