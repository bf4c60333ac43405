"""Accelerator zoo: the paper's worked examples (OMA §4.1, systolic array
§4.2, Γ̈ §4.3) plus the Eyeriss- and Plasticine-derived models referenced in
§6 and the TPU-v5e-like model of this framework's target hardware."""

from .oma import generate_oma, make_oma_ag, OMA_SCALAR_OPS
from .systolic import (
    FetchUnit,
    LoadUnit,
    ProcessingElement,
    StoreUnit,
    generate_systolic,
    make_systolic_ag,
)
from .gamma import GammaComputeTemplate, generate_gamma, make_gamma_ag
from .eyeriss import EyerissPE, generate_eyeriss, make_eyeriss_ag
from .plasticine import generate_plasticine, make_plasticine_ag
from .tpu_v5e import TPU_V5E, generate_tpu_v5e, make_tpu_v5e_ag
from .energy import (ARCH_TECH_NM, ENERGY_REGISTRY, EnergyModel,
                     TECH_TABLES, energy_model)

# name -> AG factory, the uniform handle the DSE scenario matrix
# (repro.core.aidg.explorer) iterates over.  Factories take their
# arch-specific sizing kwargs and return (ArchitectureGraph, handles).
ARCH_REGISTRY = {
    "oma": make_oma_ag,
    "systolic": make_systolic_ag,
    "gamma": make_gamma_ag,
    "eyeriss": make_eyeriss_ag,
    "plasticine": make_plasticine_ag,
    "tpu_v5e": make_tpu_v5e_ag,
}

# On-chip double-buffer capacity per architecture, in data words: the
# storage a pipelined network schedule (repro.core.network) can stage the
# NEXT layer's stationary operand into while the current layer computes.
# Derived from each model: OMA's scalar data cache, one systolic-array
# worth of PE registers plus stream buffers, the Γ̈ scratchpad, the
# Eyeriss GLB (108 KB class), the aggregate Plasticine PMU capacity, and
# the TPU-v5e VMEM (128 MiB of bf16 words).  Coarse by construction — the
# capacity gate only decides whether inter-layer overlap is credited.
ARCH_CAPACITY_WORDS = {
    "oma": 4 * 1024,
    "systolic": 16 * 1024,
    "gamma": 64 * 1024,
    "eyeriss": 54 * 1024,
    "plasticine": 256 * 1024,
    "tpu_v5e": TPU_V5E["vmem_bytes"] // 2,
}

__all__ = [
    "generate_oma", "make_oma_ag", "OMA_SCALAR_OPS",
    "ProcessingElement", "LoadUnit", "StoreUnit", "FetchUnit",
    "generate_systolic", "make_systolic_ag",
    "GammaComputeTemplate", "generate_gamma", "make_gamma_ag",
    "EyerissPE", "generate_eyeriss", "make_eyeriss_ag",
    "generate_plasticine", "make_plasticine_ag",
    "TPU_V5E", "generate_tpu_v5e", "make_tpu_v5e_ag",
    "ARCH_REGISTRY", "ARCH_CAPACITY_WORDS",
    "EnergyModel", "ENERGY_REGISTRY", "ARCH_TECH_NM", "TECH_TABLES",
    "energy_model",
]
