"""Fused-tensor attention / selective-scan mappings for Γ̈ (beyond-paper
workloads on the paper's §4.3 accelerator).

The Γ̈ ``matAddFu`` processes the beyond-paper ``attn`` and ``scan``
fused-tensor operations (see ``repro.core.archs.gamma``), so the modern
attention and SSM workloads of the operator-extraction layer can be mapped
onto the paper's accelerator — these builders emit the tile-level
instruction streams the DSE scenario matrix evaluates.

Both builders are timing-oriented: tiles are loaded from DRAM addresses that
need not be initialised (``t_load`` of an unwritten address yields an
abstract tile and the trace stays timing-accurate), the same convention the
TPU-v5e operator mappings use.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..acadl import Instruction, isa

__all__ = ["gamma_attention", "gamma_scan"]

Q_BASE = 0x400
KV_BASE = 0x800
OUT_BASE = 0x1800
X_BASE = 0x400
D_BASE = 0xC00
S_BASE = 0x1800


def gamma_attention(seq: int, ctx: int, head_dim: int, tile: int = 8,
                    units: Sequence[Tuple[str, str, str]] = (
                        ("lsu0", "matAddFu0", "vrf0"),),
                    ) -> List[Instruction]:
    """Tiled attention ``softmax(q k^T) v`` on Γ̈: one ``t_attn`` per
    (q-tile, kv-tile) pair, issued flash-attention-style (all kv tiles
    stream through the FU per q-tile, serialized on the accumulator
    register's unit).  Timing-oriented like every builder in this module:
    the accumulator is overwritten, not functionally accumulated — the
    instruction stream models the schedule, not the arithmetic.

    ``units``: (load/store MAU, attn-capable FU, vreg prefix) triples;
    q-tiles round-robin across them like ``gamma_gemm`` output tiles.
    """
    assert seq % tile == 0 and ctx % tile == 0
    qt, kt = seq // tile, ctx // tile
    # the fixed DRAM regions must not alias, or build_trace manufactures
    # false store-to-load dependencies that corrupt the timing estimate
    assert qt <= KV_BASE - Q_BASE and 2 * qt * kt <= OUT_BASE - KV_BASE, \
        "tile counts overflow the fixed address regions"
    prog: List[Instruction] = []
    for ti in range(qt):
        lsu, fu, vrf = units[ti % len(units)]
        rq, rk, rv, ro = (f"{vrf}.0", f"{vrf}.1", f"{vrf}.2", f"{vrf}.acc")
        prog.append(isa.t_load(rq, Q_BASE + ti, (tile, head_dim), unit=lsu))
        for tj in range(kt):
            prog.append(isa.t_load(rk, KV_BASE + 2 * (ti * kt + tj),
                                   (tile, head_dim), unit=lsu))
            prog.append(isa.t_load(rv, KV_BASE + 2 * (ti * kt + tj) + 1,
                                   (tile, head_dim), unit=lsu))
            prog.append(isa.t_attn(ro, rq, rk, rv, unit=fu,
                                   tile=(tile, tile, head_dim)))
        prog.append(isa.t_store(ro, OUT_BASE + ti, shape=(tile, head_dim),
                                unit=lsu))
    return prog


def gamma_scan(tokens: int, d_state: int, tile: int = 8,
               units: Sequence[Tuple[str, str, str]] = (
                   ("lsu0", "matAddFu0", "vrf0"),),
               ) -> List[Instruction]:
    """Chunked selective-scan ``state = decay * state + x`` on Γ̈.

    The token axis is a true recurrence, so it is NEVER split across
    units: the *state* dimension is striped instead (each unit owns
    ``d_state / len(units)`` state columns and scans every token chunk
    sequentially through its own state register).  Each stripe's state
    register therefore carries the full-depth RAW chain the SSM workload
    imposes, while stripes proceed in parallel — the same decomposition a
    real multi-unit selective scan uses.  Emission interleaves stripes per
    chunk so instructions for different units issue back-to-back.
    """
    assert tokens % tile == 0
    chunks = tokens // tile
    nu = len(units)
    assert d_state % nu == 0, "state columns must stripe evenly across units"
    assert chunks * nu <= D_BASE - X_BASE, \
        "chunk count overflows the fixed address regions"
    cols = max(1, d_state // nu)
    prog: List[Instruction] = []
    for c in range(chunks):
        for k, (lsu, fu, vrf) in enumerate(units):
            rx, rd, rs = f"{vrf}.0", f"{vrf}.1", f"{vrf}.2"
            prog.append(isa.t_load(rx, X_BASE + c * nu + k, (tile, cols),
                                   unit=lsu))
            prog.append(isa.t_load(rd, D_BASE + c * nu + k, (tile, cols),
                                   unit=lsu))
            prog.append(isa.t_scan(rs, rs, rx, rd, unit=fu,
                                   words=tile * cols))
            if (c + 1) % 8 == 0 or c == chunks - 1:
                prog.append(isa.t_store(rs, S_BASE + c * nu + k,
                                        shape=(tile, cols), unit=lsu))
    return prog
