"""Per-architecture lowering of layer-graph operators to AIDG programs.

Every architecture in ``repro_torch.core.archs.ARCH_REGISTRY`` gets a lowering
from ``OperatorCall`` (one per-layer operator instance) to a concrete
ACADL instruction stream, reusing the existing ``repro_torch.core.mapping``
builders.  Two regimes:

* **Full-shape lowering** (``tpu_v5e``): the fused-tensor abstraction
  level folds the whole operator's MACs/words into per-instruction latency
  arguments, so one per-layer program models the *exact* layer shape —
  ``tiles = 1``.
* **Representative-tile lowering** (every tiled/scalar machine): the
  per-layer program is one fixed, measured-accurate tile of the operator
  on that machine (e.g. a 32³ Γ̈ GEMM tile, an 8×16×8 systolic residency,
  a 64×64 Eyeriss row-stationary pass) and the layer's cycles are
  ``tile makespan × tiles`` with ``tiles = ceil(layer MACs / tile MACs)``
  — the standard tile-extrapolation performance model.  Because every
  layer of an operator kind shares ONE tile program, a whole network
  compiles a handful of AIDGs per architecture (asserted via the
  scenario-cache hit counters).

Operators an architecture has no natural unit for are lowered through a
documented **proxy** at matched MAC count (attention → GEMM tiles on the
systolic array and OMA, GEMM/attention → row-stationary conv passes on
Eyeriss via the im2col correspondence, everything → map/reduce pipelines
on Plasticine); ``lower_call`` returns ``None`` where no lowering is
defensible (e.g. selective scan on the systolic array), and that network
cell is simply absent from the matrix — same convention as the operator
matrix.

Tile sizes are chosen from measured AIDG-vs-event-simulator error (see
``docs/networks.md``): every tile used here is exact or within 1% of the
oracle, so composed network estimates stay within 1% end-to-end.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..aidg.explorer import Scenario
from ..archs import ARCH_CAPACITY_WORDS
from ..mapping.workload import OperatorCall

__all__ = ["LoweredLayer", "lower_call", "lowerable_ops",
           "ARCH_CAPACITY_WORDS", "ARCH_TILE_TOL"]

# Measured AIDG-vs-event-sim relative error bound of the tile programs
# below (0.0 = cycle-exact; see docs/networks.md for the measurements).
ARCH_TILE_TOL: Dict[str, float] = {
    "oma": 0.0,
    "systolic": 0.008,
    "gamma": 0.0,
    "eyeriss": 0.01,
    "plasticine": 0.0,
    "tpu_v5e": 0.0,
}


@dataclass(frozen=True)
class LoweredLayer:
    """One layer instance lowered onto one architecture.

    ``scenario`` is the (cacheable) tile-program cell; ``tiles`` the
    analytic repeat count extrapolating the tile to the full layer;
    ``weight_words`` the stationary working set one buffered instance
    occupies (the double-buffer capacity gate compares two of these
    against ``ARCH_CAPACITY_WORDS``)."""

    scenario: Scenario
    tiles: float
    weight_words: float


def _scenario(arch: str, op: str, fn: Callable, *args) -> Scenario:
    """Tile-program cell keyed like ``default_scenarios``' S() helper (the
    builder identity participates, so network tiles never alias operator
    cells built from different functions)."""
    params = ((("__builder__", f"{fn.__module__}.{fn.__qualname__}"),)
              + tuple(enumerate(args)))
    return Scenario(arch, op, lambda: fn(*args), params,
                    ARCH_TILE_TOL[arch])


def _stationary_words(call: OperatorCall) -> float:
    """The operand a buffered schedule keeps resident: the weight matrix
    for GEMM, the KV working set for attention, the state for a scan."""
    if call.op == "scan":
        return float(call.k)
    return float(call.k * call.n)


# ---------------------------------------------------------------------------
# tile builders (module-level so their identity keys the AIDG cache)
# ---------------------------------------------------------------------------


def _tile_tpu(op: str, m: int, k: int, n: int):
    from ..archs import ARCH_REGISTRY
    from ..mapping.workload import UMA_REGISTRY
    ag, _ = ARCH_REGISTRY["tpu_v5e"]()
    return ag, UMA_REGISTRY[("tpu_v5e", op)](OperatorCall(op, m, k, n, 1,
                                                          "net"))


def _tile_gamma_gemm(n: int, nu: int):
    from ..aidg.explorer import _gamma_units
    from ..archs import ARCH_REGISTRY
    from ..mapping.gemm import gamma_gemm, init_gemm_memory
    ag, _ = ARCH_REGISTRY["gamma"](n_units=nu)
    A = np.ones((n, n), np.float32)
    init_gemm_memory(ag, A, A, memory="dram0", tile=8)
    return ag, gamma_gemm(n, n, n, tile=8, units=_gamma_units(nu))


def _tile_gamma_attention(seq: int, ctx: int, hd: int, nu: int):
    from ..aidg.explorer import _attn_units
    from ..archs import ARCH_REGISTRY
    from ..mapping.fused import gamma_attention
    ag, _ = ARCH_REGISTRY["gamma"](n_units=nu)
    return ag, gamma_attention(seq, ctx, hd, units=_attn_units(nu))


def _tile_gamma_scan(tokens: int, d_state: int, nu: int):
    from ..aidg.explorer import _attn_units
    from ..archs import ARCH_REGISTRY
    from ..mapping.fused import gamma_scan
    ag, _ = ARCH_REGISTRY["gamma"](n_units=nu)
    return ag, gamma_scan(tokens, d_state, units=_attn_units(nu))


def _tile_systolic_gemm(m: int, k: int, n: int, rows: int, cols: int):
    from ..archs import ARCH_REGISTRY
    from ..mapping.systolic import init_systolic_memory, systolic_gemm_program
    ag, _ = ARCH_REGISTRY["systolic"](rows, cols)
    init_systolic_memory(ag, np.ones((m, k)), np.ones((k, n)))
    return ag, systolic_gemm_program(m, k, n, rows, cols)


def _tile_eyeriss_conv(h: int, w: int, f: int, rows: int, cols: int):
    from ..archs import ARCH_REGISTRY
    from ..mapping.conv import eyeriss_conv2d, init_conv_memory
    ag, _ = ARCH_REGISTRY["eyeriss"](rows=rows, columns=cols)
    init_conv_memory(ag, np.ones((h, w)), np.ones((f, f)))
    return ag, eyeriss_conv2d(h, w, f, f, rows, cols)


def _tile_plasticine_reduce(n: int, npcu: int):
    from ..archs import ARCH_REGISTRY
    from ..mapping.patterns import init_vector_memory, plasticine_map_reduce
    ag, _ = ARCH_REGISTRY["plasticine"](n_pcu=npcu, n_pmu=npcu)
    init_vector_memory(ag, np.ones(n), npcu)
    return ag, plasticine_map_reduce(n, npcu, npcu)


def _tile_oma_gemm(n: int, t: int):
    from ..archs import ARCH_REGISTRY
    from ..mapping.gemm import init_gemm_memory, oma_gemm_unrolled
    ag, _ = ARCH_REGISTRY["oma"]()
    A = np.ones((n, n))
    init_gemm_memory(ag, A, A)
    return ag, oma_gemm_unrolled(n, n, n, t, t, t)


# ---------------------------------------------------------------------------
# the lowering table: (arch, op) -> (tile scenario, tile MACs, tile words)
# ---------------------------------------------------------------------------

# (scenario factory, tile MAC capacity, buffered tile words).  Proxy
# lowerings reuse another op's tile at matched MAC count.
_GAMMA_GEMM = (lambda: _scenario("gamma", "gemm", _tile_gamma_gemm, 32, 2),
               32 * 32 * 32, 32 * 32)
_GAMMA_ATTN = (lambda: _scenario("gamma", "attention",
                                 _tile_gamma_attention, 32, 64, 8, 2),
               32 * 64 * 2 * 8, 64 * 16)
_GAMMA_SCAN = (lambda: _scenario("gamma", "scan", _tile_gamma_scan,
                                 256, 16, 2),
               256 * 16 * 2, 16)
_SYSTOLIC_GEMM = (lambda: _scenario("systolic", "gemm", _tile_systolic_gemm,
                                    8, 16, 8, 4, 4),
                  8 * 16 * 8, 16 * 8)
_EYERISS_CONV = (lambda: _scenario("eyeriss", "conv", _tile_eyeriss_conv,
                                   64, 64, 3, 3, 3),
                 62 * 62 * 3 * 3, 64 * 3)
_PLASTICINE_MR = (lambda: _scenario("plasticine", "reduce",
                                    _tile_plasticine_reduce, 2048, 4),
                  2048, 2048)
_OMA_GEMM = (lambda: _scenario("oma", "gemm", _tile_oma_gemm, 4, 2),
             4 * 4 * 4, 4 * 4)

_TILES: Dict[Tuple[str, str], Tuple[Callable, int, int]] = {
    ("gamma", "gemm"): _GAMMA_GEMM,
    ("gamma", "attention"): _GAMMA_ATTN,
    ("gamma", "scan"): _GAMMA_SCAN,
    ("systolic", "gemm"): _SYSTOLIC_GEMM,
    ("systolic", "attention"): _SYSTOLIC_GEMM,   # QKᵀ/PV as GEMM tiles
    ("eyeriss", "gemm"): _EYERISS_CONV,          # im2col correspondence
    ("eyeriss", "attention"): _EYERISS_CONV,
    ("plasticine", "gemm"): _PLASTICINE_MR,      # dot-product map/reduce
    ("plasticine", "attention"): _PLASTICINE_MR,
    ("plasticine", "scan"): _PLASTICINE_MR,      # scans ARE its pattern
    ("oma", "gemm"): _OMA_GEMM,
    ("oma", "attention"): _OMA_GEMM,             # scalar QKᵀ/PV proxy
}

_TPU_OPS = ("gemm", "attention", "scan")


def lowerable_ops(arch: str) -> Tuple[str, ...]:
    """The operator kinds ``lower_call`` can map onto ``arch``."""
    if arch == "tpu_v5e":
        return _TPU_OPS
    return tuple(sorted(op for (a, op) in _TILES if a == arch))


def lower_call(arch: str, call: OperatorCall) -> Optional[LoweredLayer]:
    """One per-layer operator instance -> its program on ``arch``.

    Returns ``None`` when the architecture has no (even proxy) lowering
    for the operator kind — the caller drops the whole network cell."""
    if arch == "tpu_v5e":
        if call.op not in _TPU_OPS:
            return None
        sc = _scenario("tpu_v5e", call.op, _tile_tpu, call.op, call.m,
                       call.k, call.n)
        return LoweredLayer(sc, 1.0, _stationary_words(call))
    hit = _TILES.get((arch, call.op))
    if hit is None:
        return None
    factory, tile_macs, tile_words = hit
    tiles = float(max(1, math.ceil(call.macs / tile_macs)))
    return LoweredLayer(factory(), tiles, float(tile_words))
