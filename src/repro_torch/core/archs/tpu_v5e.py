"""TPU-v5e-like accelerator model (fused-tensor abstraction level).

This is the ACADL model of the framework's *target hardware* — the same
constants used by the roofline analysis (197 TFLOP/s bf16, 819 GB/s HBM):

* ``mxu0``    — systolic matrix unit: ``gemm`` tiles, ``macs_per_cycle`` =
  n_mxu * 128 * 128 MACs/cycle (197e12 / 2 / 1.5e9 ≈ 65k MACs/cycle ->
  4 MXUs at 1.5 GHz).
* ``vpu0``    — vector unit: elementwise/``matadd``/``scan``/``attn``
  softmax-side work at 8*128 lanes/cycle.
* ``vmem0``   — on-chip vector memory (SRAM scratchpad), tile-granular
  addresses, very wide port.
* ``hbm0``    — HBM (DRAM timing): 819 GB/s at 1.5 GHz = 546 B/cycle =
  273 bf16 words/cycle -> port_width 256.
* ``dma0``    — async copy engine HBM <-> VMEM (the Pallas ``pltpu.emit``
  analogue); ``lsu0`` moves VMEM tiles into vector registers.

One AG = one TPU core.  Multi-chip parallelism is the JAX layer's job
(pjit/shard_map over the production mesh); ACADL models the per-chip timing
that the roofline terms summarize.  ``repro.core.mapping.workload`` maps a
model config's per-layer operator stream onto this AG at one-instruction-
per-fused-op granularity, and the AIDG estimator returns cycles -> seconds
via ``clock_ghz``.
"""

from __future__ import annotations

from typing import Dict, Optional

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

__all__ = ["generate_tpu_v5e", "make_tpu_v5e_ag", "TPU_V5E"]

# hardware constants shared with repro.launch.roofline
TPU_V5E = {
    "clock_ghz": 1.5,
    "peak_bf16_flops": 197e12,
    "hbm_bytes_per_s": 819e9,
    "ici_bytes_per_s_per_link": 50e9,
    "n_mxu": 4,
    "mxu_dim": 128,
    "vpu_lanes": 8 * 128,
    "vmem_bytes": 128 * 1024 * 1024,
    "hbm_bytes": 16 * 1024 * 1024 * 1024,
}

VMEM_WINDOW = 1 << 24   # tile-granular VMEM addresses below, HBM above


@generate
def generate_tpu_v5e(*, n_mxu: int = 4, mxu_dim: int = 128,
                     vpu_lanes: int = 1024, hbm_port_words: int = 256,
                     vmem_port_words: int = 4096,
                     issue_buffer_size: int = 128,
                     port_width: int = 16,
                     dma_concurrency: int = 8,
                     n_vregs: int = 64) -> Dict[str, object]:
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

    # memories: bf16 words (data_width 16)
    hbm0 = DRAM(name="hbm0", read_latency=100, write_latency=100,
                data_width=16, port_width=hbm_port_words,
                address_ranges=((VMEM_WINDOW, 1 << 40),),
                t_RCD=20, t_RP=20, row_size=1 << 14,
                max_concurrent_requests=dma_concurrency,
                read_write_ports=2)
    vmem0 = SRAM(name="vmem0", read_latency=2, write_latency=2,
                 data_width=16, port_width=vmem_port_words,
                 address_ranges=((0, VMEM_WINDOW),),
                 max_concurrent_requests=4, read_write_ports=4)

    # async copy engine HBM <-> VMEM
    dma_ex = ExecuteStage(name="dma_ex0", latency=latency_t(1))
    dma0 = MemoryAccessUnit(name="dma0", to_process={"t_load", "t_store"},
                            latency=latency_t(1))
    dma_rf = RegisterFile(name="dma_rf0", data_width=16 * 4096,
                          registers={f"dstage.{i}": Data(16 * 4096, None)
                                     for i in range(dma_concurrency)})
    ACADLEdge(dma_ex, dma0, CONTAINS)
    ACADLEdge(hbm0, dma0, READ_DATA)
    ACADLEdge(dma0, hbm0, WRITE_DATA)
    ACADLEdge(vmem0, dma0, READ_DATA)
    ACADLEdge(dma0, vmem0, WRITE_DATA)
    ACADLEdge(dma_rf, dma0, READ_DATA)
    ACADLEdge(dma0, dma_rf, WRITE_DATA)
    ACADLEdge(ifs0, dma_ex, FORWARD)

    # vector registers + VMEM load/store unit
    vregs = {f"v.{i}": Data(16 * 8 * 128, None) for i in range(n_vregs)}
    for sp in ("a", "b", "acc", "q", "k", "vv", "s"):
        vregs[f"v.{sp}"] = Data(16 * 8 * 128, None)
    vrf0 = RegisterFile(name="vrf0", data_width=16 * 8 * 128, registers=vregs)
    lsu_ex = ExecuteStage(name="lsu_ex0", latency=latency_t(1))
    lsu0 = MemoryAccessUnit(name="lsu0", to_process={"t_load", "t_store"},
                            latency=latency_t(1))
    ACADLEdge(lsu_ex, lsu0, CONTAINS)
    ACADLEdge(vmem0, lsu0, READ_DATA)
    ACADLEdge(lsu0, vmem0, WRITE_DATA)
    ACADLEdge(vrf0, lsu0, READ_DATA)
    ACADLEdge(lsu0, vrf0, WRITE_DATA)
    ACADLEdge(ifs0, lsu_ex, FORWARD)

    # MXU: gemm tiles at macs_per_cycle throughput (+ pipeline fill)
    macs_per_cycle = n_mxu * mxu_dim * mxu_dim
    mxu_ex = ExecuteStage(name="mxu_ex0", latency=latency_t(1))
    mxu0 = FunctionalUnit(
        name="mxu0", to_process={"gemm"},
        latency=latency_t(lambda operation="", macs=macs_per_cycle, **_:
                          mxu_dim + max(1, macs // macs_per_cycle)),
    )
    ACADLEdge(mxu_ex, mxu0, CONTAINS)
    ACADLEdge(vrf0, mxu0, READ_DATA)
    ACADLEdge(mxu0, vrf0, WRITE_DATA)
    ACADLEdge(ifs0, mxu_ex, FORWARD)

    # VPU: elementwise / softmax-side / scan at vpu_lanes words/cycle
    vpu_ex = ExecuteStage(name="vpu_ex0", latency=latency_t(1))
    vpu0 = FunctionalUnit(
        name="vpu0", to_process={"matadd", "scan", "attn"},
        latency=latency_t(lambda operation="", words=vpu_lanes, macs=0, **_:
                          8 + max(1, words // vpu_lanes)),
    )
    ACADLEdge(vpu_ex, vpu0, CONTAINS)
    ACADLEdge(vrf0, vpu0, READ_DATA)
    ACADLEdge(vpu0, vrf0, WRITE_DATA)
    ACADLEdge(ifs0, vpu_ex, FORWARD)

    return {"imem0": imem0, "ifs0": ifs0, "hbm0": hbm0, "vmem0": vmem0,
            "dma0": dma0, "lsu0": lsu0, "mxu0": mxu0, "vpu0": vpu0,
            "vrf0": vrf0, "macs_per_cycle": macs_per_cycle}


def make_tpu_v5e_ag(**params):
    handles = generate_tpu_v5e(**params)
    ag = create_ag()
    return ag, handles
