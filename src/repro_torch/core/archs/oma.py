"""One MAC Accelerator (OMA) — paper §4.1, Fig. 2/3, Listing 1.

Scalar-operations-level model: one data memory behind a data cache, one
register file, an execution stage holding the ALU (``fu0``) and the memory
access unit (``mau0``), and a fetch front-end (``ifs0`` containing ``imau0``
reading ``imem0`` and the pc register file ``pcrf0``).
"""

from __future__ import annotations

from typing import Dict

from ..acadl import (
    ACADLEdge,
    CONTAINS,
    Data,
    ExecuteStage,
    FORWARD,
    FunctionalUnit,
    InstructionFetchStage,
    InstructionMemoryAccessUnit,
    MemoryAccessUnit,
    PipelineStage,
    READ_DATA,
    RegisterFile,
    SetAssociativeCache,
    SRAM,
    WRITE_DATA,
    create_ag,
    generate,
    latency_t,
)

__all__ = ["generate_oma", "make_oma_ag", "OMA_SCALAR_OPS"]

OMA_SCALAR_OPS = {
    "mov", "addi", "add", "sub", "muli", "mac", "beqi", "bnei", "jumpi", "halt",
}


@generate
def generate_oma(*, n_registers: int = 16, data_width: int = 32,
                 imem_port_width: int = 1, issue_buffer_size: int = 4,
                 fu_latency: int = 1, mac_latency: int = 1,
                 mau_latency: int = 1, dmem_read_latency: int = 10,
                 dmem_write_latency: int = 10, cache_sets: int = 64,
                 cache_ways: int = 4, cache_hit_latency: int = 1,
                 cache_miss_latency: int = 12, cache_line_size: int = 8,
                 dmem_size: int = 1 << 20) -> Dict[str, object]:
    """Instantiate the OMA architecture graph (paper Listing 1)."""

    # instruction fetch front-end
    imem0 = SRAM(name="imem0", read_latency=1, write_latency=1,
                 address_ranges=((0, 1 << 20),), port_width=imem_port_width)
    pcrf0 = RegisterFile(name="pcrf0", data_width=32,
                         registers={"pc": Data(32, 0)})
    ifs0 = InstructionFetchStage(name="ifs0", latency=latency_t(1),
                                 issue_buffer_size=issue_buffer_size)
    imau0 = InstructionMemoryAccessUnit(name="imau0", latency=latency_t(0))

    # instruction processing
    ds0 = PipelineStage(name="ds0", latency=latency_t(1))
    ex0 = ExecuteStage(name="ex0", latency=latency_t(1))
    fu0 = FunctionalUnit(
        name="fu0",
        to_process=OMA_SCALAR_OPS - {"mac"},
        latency=latency_t(fu_latency),
    )
    # the built-in MAC gets its own latency knob via a dedicated unit entry;
    # paper models a single ALU — we keep one unit but allow a distinct MAC
    # latency through a latency function
    fu0.to_process.add("mac")
    if mac_latency != fu_latency:
        base, mac_l = fu_latency, mac_latency
        fu0.latency = latency_t(lambda operation="", **_: mac_l if operation == "mac" else base)

    mau0 = MemoryAccessUnit(name="mau0", to_process={"load", "store"},
                            latency=latency_t(mau_latency))
    regs = {f"r{i}": Data(data_width, 0) for i in range(n_registers)}
    regs["z0"] = Data(data_width, 0)      # zero register (paper Listing 5)
    regs["acc"] = Data(data_width, 0)
    rf0 = RegisterFile(name="rf0", data_width=data_width, registers=regs)
    dmem0 = SRAM(name="dmem0", read_latency=dmem_read_latency,
                 write_latency=dmem_write_latency,
                 address_ranges=((0, dmem_size),))
    dcache0 = SetAssociativeCache(
        name="dcache0", sets=cache_sets, ways=cache_ways,
        hit_latency=cache_hit_latency, miss_latency=cache_miss_latency,
        cache_line_size=cache_line_size,
    )

    # edges (paper Listing 1, lines 35-51)
    ACADLEdge(imem0, imau0, READ_DATA)
    ACADLEdge(pcrf0, imau0, READ_DATA)
    ACADLEdge(imau0, pcrf0, WRITE_DATA)
    ACADLEdge(ifs0, imau0, CONTAINS)
    ACADLEdge(ifs0, ds0, FORWARD)
    ACADLEdge(ds0, ex0, FORWARD)
    ACADLEdge(ex0, fu0, CONTAINS)
    ACADLEdge(fu0, rf0, WRITE_DATA)
    ACADLEdge(rf0, fu0, READ_DATA)
    ACADLEdge(ex0, mau0, CONTAINS)
    ACADLEdge(mau0, rf0, WRITE_DATA)
    ACADLEdge(rf0, mau0, READ_DATA)
    ACADLEdge(mau0, dcache0, WRITE_DATA)
    ACADLEdge(dcache0, mau0, READ_DATA)
    ACADLEdge(dcache0, dmem0, WRITE_DATA)
    ACADLEdge(dmem0, dcache0, READ_DATA)

    return {"imem0": imem0, "pcrf0": pcrf0, "ifs0": ifs0, "imau0": imau0,
            "ds0": ds0, "ex0": ex0, "fu0": fu0, "mau0": mau0, "rf0": rf0,
            "dmem0": dmem0, "dcache0": dcache0}


def make_oma_ag(**params):
    """Generate + create the OMA AG in one call."""
    handles = generate_oma(**params)
    ag = create_ag()
    return ag, handles
