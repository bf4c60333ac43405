"""Γ̈ [gœna] — General Operationally Extendable Neural Network Accelerator
(paper §4.3, Fig. 6/7, Listing 4).

Fused-tensor-operations-level model.  The architecture is composed of
``n_units`` templates, each containing a load/store unit (``lsu<k>``), a
compute unit (``cu<k>`` holding ``matMulFu<k>`` and ``matAddFu<k>``), a
vector register file (``vrf<k>``) and a scratchpad SRAM (``spm<k>``); a
shared DRAM data memory feeds all load/store units.  Scratchpads are shared
with the *adjacent* compute unit's load/store unit (ring topology), matching
"the scratchpad is an SRAM used to store partial results that can be shared
with adjacent compute units".

Instructions for different hardware components issue in parallel and execute
out-of-order — this emerges from the timing semantics (§6): the fetch stage
forwards multiple instructions per cycle and units serialize only on data
dependencies and structural hazards.

Beyond-paper extension (recorded in DESIGN.md): ``matAddFu`` additionally
processes ``scan`` (chunked SSM recurrence) and ``attn`` (fused attention
tile) so modern attention-free/hybrid workloads can be mapped; the paper
explicitly allows instructions that "carry out complex operations".
"""

from __future__ import annotations

from typing import Dict, List

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
    connect_dangling_edge,
    create_ag,
    generate,
    latency_t,
)

__all__ = ["GammaComputeTemplate", "generate_gamma", "make_gamma_ag"]


class GammaComputeTemplate:
    """One dashed-line template of Fig. 6: load/store unit + compute unit +
    scratchpad, with the vector register file binding them."""

    def __init__(self, k: int, *, tile: int = 8, n_vregs: int = 32,
                 vreg_bits: int = 128, gemm_latency=None, lsu_latency: int = 1,
                 spm_kw: Dict | None = None):
        t = tile
        # MAC-array timing: an 8x8 fused gemm streams `tile` ranks through an
        # 8x8 MAC grid — macs / (tile*tile) cycles (+1 fill).
        if gemm_latency is None:
            gemm_latency = latency_t(
                lambda operation="", macs=t * t * t, **_: max(1, macs // (t * t) + 1))

        self.ex_lsu = ExecuteStage(name=f"ex_lsu{k}", latency=latency_t(1))
        self.lsu = MemoryAccessUnit(name=f"lsu{k}",
                                    to_process={"t_load", "t_store"},
                                    latency=latency_t(lsu_latency))
        ACADLEdge(self.ex_lsu, self.lsu, CONTAINS)

        self.cu = ExecuteStage(name=f"cu{k}", latency=latency_t(1))
        self.matMulFu = FunctionalUnit(name=f"matMulFu{k}",
                                       to_process={"gemm"},
                                       latency=gemm_latency)
        # VPU-style unit: elementwise + beyond-paper scan/attn fused ops
        self.matAddFu = FunctionalUnit(
            name=f"matAddFu{k}",
            to_process={"matadd", "scan", "attn"},
            latency=latency_t(lambda operation="", words=t * t, macs=0, **_:
                              max(1, words // t)),
        )
        ACADLEdge(self.cu, self.matMulFu, CONTAINS)
        ACADLEdge(self.cu, self.matAddFu, CONTAINS)

        regs = {f"vrf{k}.{i}": Data(vreg_bits, None) for i in range(n_vregs)}
        for special in ("a", "b", "acc"):
            regs[f"vrf{k}.{special}"] = Data(vreg_bits, None)
        self.vrf = RegisterFile(name=f"vrf{k}", data_width=vreg_bits,
                                registers=regs)

        ACADLEdge(self.vrf, self.matMulFu, READ_DATA)
        ACADLEdge(self.matMulFu, self.vrf, WRITE_DATA)
        ACADLEdge(self.vrf, self.matAddFu, READ_DATA)
        ACADLEdge(self.matAddFu, self.vrf, WRITE_DATA)
        # the load/store unit moves tiles between memories and vector registers
        ACADLEdge(self.vrf, self.lsu, READ_DATA)
        ACADLEdge(self.lsu, self.vrf, WRITE_DATA)

        # scratchpad: tile-granular addressing, one tile moves in
        # tile*tile/port words per beat
        self.spm = SRAM(name=f"spm{k}", read_latency=1, write_latency=1,
                        address_ranges=((0x3000 + k * 0x1000, 0x4000 + k * 0x1000),),
                        port_width=t * t, read_write_ports=4,
                        **(spm_kw or {}))
        ACADLEdge(self.spm, self.lsu, READ_DATA)
        ACADLEdge(self.lsu, self.spm, WRITE_DATA)


@generate
def generate_gamma(n_units: int = 2, *, tile: int = 8, n_vregs: int = 32,
                   port_width: int = 8, issue_buffer_size: int = 32,
                   dram_read_latency: int = 20, dram_write_latency: int = 20,
                   dram_port_width: int = 16) -> Dict[str, object]:
    """Instantiate the Γ̈ AG with ``n_units`` compute/scratchpad templates."""
    # fetch front-end (same structure as OMA)
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

    dram0 = DRAM(name="dram0", read_latency=dram_read_latency,
                 write_latency=dram_write_latency,
                 address_ranges=((0, 0x3000), (0x3000 + n_units * 0x1000, 1 << 22)),
                 port_width=dram_port_width,
                 max_concurrent_requests=2,
                 read_write_ports=2 * max(1, n_units))

    units: List[GammaComputeTemplate] = []
    for k in range(n_units):
        u = GammaComputeTemplate(k, tile=tile, n_vregs=n_vregs)
        # DRAM data path
        ACADLEdge(dram0, u.lsu, READ_DATA)
        ACADLEdge(u.lsu, dram0, WRITE_DATA)
        # instruction routing
        ACADLEdge(ifs0, u.ex_lsu, FORWARD)
        ACADLEdge(ifs0, u.cu, FORWARD)
        units.append(u)

    # adjacent scratchpad sharing (ring): lsu k can also access spm (k+1)%n
    if n_units > 1:
        for k, u in enumerate(units):
            nbr = units[(k + 1) % n_units]
            ACADLEdge(nbr.spm, u.lsu, READ_DATA)
            ACADLEdge(u.lsu, nbr.spm, WRITE_DATA)

    return {"imem0": imem0, "ifs0": ifs0, "dram0": dram0, "units": units,
            "tile": tile}


def make_gamma_ag(n_units: int = 2, **params):
    handles = generate_gamma(n_units, **params)
    ag = create_ag()
    return ag, handles
