"""Per-op-class energy and power coefficients for every architecture in
:data:`ARCH_REGISTRY`.

Lumos-style defaults: a small per-tech-node table of dynamic energy per
operation (by coarse op category) and per word moved (by storage class),
plus a static leakage term per cycle.  The absolute numbers are
literature ballparks (Horowitz ISSCC'14 for the 45 nm anchors, scaled by
node following the usual capacitance trend) — the point is *relative*
fidelity across op classes and memory levels, which is what the DSE
objective and the ZigZag-style bottleneck report consume.

Two classifiers map the repo's own names onto table categories:

- op classes (``AIDG.classes`` entries like ``gemm@pe`` / ``t_load@mem``)
  -> ``mac`` / ``vector`` / ``mem`` / ``ctrl``;
- storage-node names (``spm`` / ``dram_port`` / ``glb`` ...)
  -> ``reg`` / ``onchip`` / ``dram``.

Both reuse the same name conventions as ``explorer.DEFAULT_SPACE``, so a
unit that the DSE scales with the ``matrix`` knob draws ``mac`` energy.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Mapping, Tuple

__all__ = [
    "TECH_TABLES", "ARCH_TECH_NM", "EnergyModel", "ENERGY_REGISTRY",
    "energy_model", "OP_CATEGORIES", "STORAGE_CLASSES",
]

OP_CATEGORIES: Tuple[str, ...] = ("mac", "vector", "mem", "ctrl")
STORAGE_CLASSES: Tuple[str, ...] = ("reg", "onchip", "dram")

# tech node (nm) -> {"op": pJ per issued operation by category,
#                    "word": pJ per word moved by storage class,
#                    "static": pJ leaked per cycle}
TECH_TABLES: Dict[int, Dict[str, object]] = {
    65: {"op": {"mac": 6.0, "vector": 2.4, "mem": 1.2, "ctrl": 0.6},
         "word": {"reg": 0.12, "onchip": 12.0, "dram": 900.0},
         "static": 40.0},
    45: {"op": {"mac": 4.0, "vector": 1.6, "mem": 0.8, "ctrl": 0.4},
         "word": {"reg": 0.08, "onchip": 8.0, "dram": 650.0},
         "static": 25.0},
    28: {"op": {"mac": 2.2, "vector": 0.9, "mem": 0.45, "ctrl": 0.22},
         "word": {"reg": 0.05, "onchip": 4.5, "dram": 420.0},
         "static": 14.0},
    22: {"op": {"mac": 1.7, "vector": 0.7, "mem": 0.35, "ctrl": 0.17},
         "word": {"reg": 0.04, "onchip": 3.4, "dram": 350.0},
         "static": 10.0},
    7: {"op": {"mac": 0.45, "vector": 0.18, "mem": 0.09, "ctrl": 0.05},
        "word": {"reg": 0.01, "onchip": 1.0, "dram": 120.0},
        "static": 3.0},
}

# Assumed implementation node per zoo architecture (publication-era
# silicon: Eyeriss 65 nm chip, OMA-class MCU 45 nm, Plasticine 28 nm,
# systolic-array exemplar 28 nm, Γ̈ 22 nm study, TPU v5e ~7 nm).
ARCH_TECH_NM: Dict[str, int] = {
    "oma": 45,
    "systolic": 28,
    "gamma": 22,
    "eyeriss": 65,
    "plasticine": 28,
    "tpu_v5e": 7,
}

_DEFAULT_NM = 45

# op-class-name -> category (first match wins; default "ctrl").  The
# patterns mirror the FU-class conventions used across the zoo and in
# ``explorer.DEFAULT_SPACE``.
_OP_PATTERNS: Tuple[Tuple[str, "re.Pattern"], ...] = (
    ("mac", re.compile(r"gemm@|^mac|row_conv@")),
    ("vector", re.compile(r"attn@|scan@|matadd@|map@|reduce@|psum_add")),
    ("mem", re.compile(r"t_load@|t_store@|^load@|^store@|drain@")),
)

# storage-node-name -> class (first match wins; default "reg").
_STORAGE_PATTERNS: Tuple[Tuple[str, "re.Pattern"], ...] = (
    ("dram", re.compile(r"dram|hbm")),
    ("onchip", re.compile(r"spm|glb|pmu|vmem|sram|imem|cache")),
)


@dataclass(frozen=True)
class EnergyModel:
    """Energy/power coefficients of one architecture.

    ``op_table`` is pJ per issued operation by op category, ``word_table``
    pJ per word moved by storage class, ``static_pj`` leakage pJ per
    cycle.  ``op_pj`` / ``word_pj`` classify repo-native names (op-class
    strings, storage-node names) and look the category up.
    """

    name: str
    tech_nm: int
    op_table: Mapping[str, float] = field(repr=False)
    word_table: Mapping[str, float] = field(repr=False)
    static_pj: float = 0.0

    @staticmethod
    def op_category(op_class_name: str) -> str:
        for cat, pat in _OP_PATTERNS:
            if pat.search(op_class_name):
                return cat
        return "ctrl"

    @staticmethod
    def storage_class(storage_name: str) -> str:
        for cls, pat in _STORAGE_PATTERNS:
            if pat.search(storage_name):
                return cls
        return "reg"

    def op_pj(self, op_class_name: str) -> float:
        """Dynamic pJ per issued instruction of this op class (classified
        by name via :meth:`op_category`)."""
        return float(self.op_table[self.op_category(op_class_name)])

    def word_pj(self, storage_name: str) -> float:
        """Access pJ per word moved through this storage node (classified
        into reg/onchip/dram via :meth:`storage_class`)."""
        return float(self.word_table[self.storage_class(storage_name)])


def _model(name: str, nm: int) -> EnergyModel:
    t = TECH_TABLES[nm]
    return EnergyModel(name=name, tech_nm=nm,
                       op_table=dict(t["op"]), word_table=dict(t["word"]),
                       static_pj=float(t["static"]))


ENERGY_REGISTRY: Dict[str, EnergyModel] = {
    arch: _model(arch, nm) for arch, nm in ARCH_TECH_NM.items()
}


def energy_model(arch: str) -> EnergyModel:
    """The :class:`EnergyModel` of ``arch`` (default node for unknowns)."""
    got = ENERGY_REGISTRY.get(arch)
    if got is None:
        got = _model(arch, _DEFAULT_NM)
    return got
