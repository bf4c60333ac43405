"""Parameterizable systolic array — paper §4.2, Fig. 4/5, Listings 2/3.

A rows×columns grid of processing elements (PEs).  Data is passed only
vertically down and horizontally right; load units feed the first row and
column, store units drain results.  Templates (Python classes instantiating
ACADL objects + dangling edges) build the AG exactly as the paper describes:
``ProcessingElement`` mirrors Listing 2, the array generator mirrors
Listing 3, load/store/fetch unit templates complete the architecture.

Dataflow implemented by the operator mapping (`repro.core.mapping.systolic`):
output-stationary GeMM — activations stream right, weights stream down,
accumulators stay in the PE, then results drain right through the ``a``
channel to the store units on the last column.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..acadl import (
    ACADLEdge,
    CONTAINS,
    DanglingEdge,
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

__all__ = ["ProcessingElement", "LoadUnit", "StoreUnit", "FetchUnit",
           "generate_systolic", "make_systolic_ag"]


class ProcessingElement:
    """PE template (paper Listing 2): ExecuteStage + FunctionalUnit +
    RegisterFile plus dangling edges as the template interface."""

    def __init__(self, regs: int, row: int, col: int, mac_latency: int = 1):
        # acadl objects
        self.ex = ExecuteStage(name=f"ex[{row}][{col}]", latency=latency_t(1))
        self.fu = FunctionalUnit(
            name=f"fu[{row}][{col}]",
            to_process={"mac_fwd", "drain"},
            latency=latency_t(mac_latency),
        )
        regdict = {f"a[{row}][{col}]": Data(32, 0),
                   f"b[{row}][{col}]": Data(32, 0),
                   f"acc[{row}][{col}]": Data(32, 0)}
        for i in range(max(0, regs - 3)):
            regdict[f"r{i}[{row}][{col}]"] = Data(32, 0)
        self.rf = RegisterFile(name=f"rf[{row}][{col}]", data_width=32,
                               registers=regdict)

        # edges
        ACADLEdge(self.ex, self.fu, CONTAINS)
        ACADLEdge(self.rf, self.fu, READ_DATA)
        ACADLEdge(self.fu, self.rf, WRITE_DATA)

        # dangling edges (template interface, paper Listing 2)
        self.ex_ingoing_forward = DanglingEdge(edge_type=FORWARD, target=self.ex)
        self.rf_ingoing_write = DanglingEdge(edge_type=WRITE_DATA, target=self.rf)
        self.rf_outgoing_read = DanglingEdge(edge_type=READ_DATA, source=self.rf)
        self.fu_outgoing_write = DanglingEdge(edge_type=WRITE_DATA, source=self.fu)


class LoadUnit:
    """Load unit template: ExecuteStage + MemoryAccessUnit supporting
    ``load``; writes into the first-row/column PE register files."""

    def __init__(self, name: str, latency: int = 1):
        self.ex = ExecuteStage(name=f"ex_{name}", latency=latency_t(1))
        self.mau = MemoryAccessUnit(name=f"mau_{name}", to_process={"load"},
                                    latency=latency_t(latency))
        ACADLEdge(self.ex, self.mau, CONTAINS)
        self.mem_read = DanglingEdge(edge_type=READ_DATA, target=self.mau)
        self.rf_write = DanglingEdge(edge_type=WRITE_DATA, source=self.mau)
        self.ingoing_forward = DanglingEdge(edge_type=FORWARD, target=self.ex)


class StoreUnit:
    """Store unit template: ExecuteStage + MemoryAccessUnit supporting
    ``store``; reads the last-column PE register files + its own out reg."""

    def __init__(self, name: str, latency: int = 1):
        self.ex = ExecuteStage(name=f"ex_{name}", latency=latency_t(1))
        self.mau = MemoryAccessUnit(name=f"mau_{name}", to_process={"store"},
                                    latency=latency_t(latency))
        self.rf = RegisterFile(name=f"rf_{name}", data_width=32,
                               registers={f"out_{name}": Data(32, 0)})
        ACADLEdge(self.ex, self.mau, CONTAINS)
        ACADLEdge(self.rf, self.mau, READ_DATA)
        self.rf_ingoing_write = DanglingEdge(edge_type=WRITE_DATA, target=self.rf)
        self.mem_write = DanglingEdge(edge_type=WRITE_DATA, source=self.mau)
        self.ingoing_forward = DanglingEdge(edge_type=FORWARD, target=self.ex)


class FetchUnit:
    """Fetch unit template: same objects/edges as the OMA front-end."""

    def __init__(self, port_width: int, issue_buffer_size: int):
        self.imem = SRAM(name="imem0", read_latency=1, write_latency=1,
                         address_ranges=((0, 1 << 22),), port_width=port_width)
        self.pcrf = RegisterFile(name="pcrf0", data_width=32,
                                 registers={"pc": Data(32, 0)})
        self.ifs = InstructionFetchStage(name="ifs0", latency=latency_t(1),
                                         issue_buffer_size=issue_buffer_size)
        self.imau = InstructionMemoryAccessUnit(name="imau0", latency=latency_t(0))
        ACADLEdge(self.imem, self.imau, READ_DATA)
        ACADLEdge(self.pcrf, self.imau, READ_DATA)
        ACADLEdge(self.imau, self.pcrf, WRITE_DATA)
        ACADLEdge(self.ifs, self.imau, CONTAINS)


@generate
def generate_systolic(rows: int, columns: int, *, mac_latency: int = 1,
                      load_latency: int = 1, store_latency: int = 1,
                      dram_read_latency: int = 4, dram_write_latency: int = 4,
                      port_width: Optional[int] = None,
                      issue_buffer_size: Optional[int] = None,
                      dram_kw: Optional[dict] = None) -> Dict[str, object]:
    """Instantiate the parameterizable systolic array (paper Listing 3)."""
    pw = port_width if port_width is not None else max(4, rows * columns)
    ibs = issue_buffer_size if issue_buffer_size is not None else 4 * pw

    fetch = FetchUnit(pw, ibs)
    # one port per connected MemoryAccessUnit: row loaders + column loaders
    # + row store units all touch the DRAM (paper Fig. 4)
    dram = DRAM(name="dram0", read_latency=dram_read_latency,
                write_latency=dram_write_latency,
                address_ranges=((0, 1 << 22),),
                max_concurrent_requests=max(1, (rows + columns) // 2),
                read_write_ports=2 * rows + columns,
                **(dram_kw or {}))

    # instantiate array that holds all PEs (paper Listing 3)
    pes: List[List[Optional[ProcessingElement]]] = [
        [None] * columns for _ in range(rows)
    ]
    for row in range(rows):
        for col in range(columns):
            pes[row][col] = ProcessingElement(regs=4, row=row, col=col,
                                              mac_latency=mac_latency)
            # vertical: top neighbour's fu writes this PE's rf (b flows down)
            if row > 0:
                connect_dangling_edge(
                    pes[row - 1][col].fu_outgoing_write,
                    pes[row][col].rf_ingoing_write,
                )
            # horizontal: left neighbour's fu writes this PE's rf (a flows right)
            if col > 0:
                connect_dangling_edge(
                    pes[row][col - 1].fu_outgoing_write,
                    pes[row][col].rf_ingoing_write,
                )
            # every PE stage is reachable from the fetch stage
            connect_dangling_edge(fetch.ifs, pes[row][col].ex_ingoing_forward)

    # load units: one per row (A stream) and one per column (B stream)
    row_loaders, col_loaders = [], []
    for row in range(rows):
        lu = LoadUnit(f"lu_row{row}", load_latency)
        connect_dangling_edge(lu.mem_read, dram)
        connect_dangling_edge(lu.rf_write, pes[row][0].rf)
        connect_dangling_edge(fetch.ifs, lu.ingoing_forward)
        row_loaders.append(lu)
    for col in range(columns):
        lu = LoadUnit(f"lu_col{col}", load_latency)
        connect_dangling_edge(lu.mem_read, dram)
        connect_dangling_edge(lu.rf_write, pes[0][col].rf)
        connect_dangling_edge(fetch.ifs, lu.ingoing_forward)
        col_loaders.append(lu)

    # store units: one per row, fed by the last column's PE through the
    # a-channel (drain dataflow); the PE fu writes the store unit's rf
    store_units = []
    for row in range(rows):
        su = StoreUnit(f"su_row{row}", store_latency)
        connect_dangling_edge(pes[row][columns - 1].fu_outgoing_write,
                              su.rf_ingoing_write)
        connect_dangling_edge(su.mem_write, dram)
        connect_dangling_edge(fetch.ifs, su.ingoing_forward)
        store_units.append(su)

    return {"pes": pes, "fetch": fetch, "dram": dram,
            "row_loaders": row_loaders, "col_loaders": col_loaders,
            "store_units": store_units, "rows": rows, "columns": columns}


def make_systolic_ag(rows: int, columns: int, **params):
    handles = generate_systolic(rows, columns, **params)
    ag = create_ag()
    return ag, handles
