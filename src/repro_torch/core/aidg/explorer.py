"""Batched multi-architecture design-space exploration (DSE), in PyTorch.

The scenario matrix — every architecture in
``repro_torch.core.archs.ARCH_REGISTRY`` x every workload mapped onto it x
thousands of candidate accelerator parameterizations θ — evaluated in
batched sweeps on the device:

* **Scenario** — a named (arch, workload) cell with a builder that returns
  a fresh ``(ArchitectureGraph, program)``; ``default_scenarios()`` yields
  the built-in 10-cell matrix.
* **AIDG cache** — ``compile_scenario`` traces the program, builds the
  AIDG, and derives the ``DSEProblem`` once per scenario.
* **DesignSpace / Knob** — named multiplicative latency factors shared
  across architectures, matched to op classes and storages by regex.
* **Candidate generators** — ``grid_candidates``, ``random_candidates``,
  and ``Explorer.refine`` (coordinate descent around the incumbent, or
  ``method="grad"``: projected Adam over the smooth relaxation,
  ``core.aidg.gradient``).
* **Multi-objective scoring + Pareto frontier** — latency (mean
  baseline-relative cycles) vs. energy vs. an area-cost proxy;
  ``pareto_front`` extracts the deterministic non-dominated set.

The default engine, ``"packed"``, evaluates every cell of the matrix —
the 10 operator cells and, with ``networks=``, the whole-network cells of
``repro_torch.core.network`` — through one ``dse.PackedMatrix``: every
cell chain-condensed, padded into shape buckets, and evaluated for all
cells and all candidates together.  The per-cell engines remain:
``"blocked"`` (max-plus Kleene closures, every ⊗ on the hand-written CUDA
kernel), ``"wavefront"``, ``"condensed"`` and ``"scan"``::

    from repro_torch.core.aidg.explorer import (Explorer, DEFAULT_SPACE,
                                                random_candidates)
    ex = Explorer(networks=True)               # packed, on the CUDA device
    res = ex.explore(random_candidates(DEFAULT_SPACE, 4096))
    print(res.frontier()[:3])
"""

from __future__ import annotations

import re
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...device import resolve_device
from ..acadl.sim import build_trace, simulate
from ..archs.energy import energy_model
from .builder import (AIDG, CompiledAIDG, LevelSchedule, build_aidg,
                      condense_aidg, longest_path_fixed_point)
from .dse import DSEProblem, PackSpec, PackedMatrix, make_problem, sweep
from .energy import fold_dyn_energy
from .maxplus import DEFAULT_ENGINE, ENGINES

# the Explorer's engine knob: every per-cell max-plus relaxation, plus the
# matrix-packed evaluator (the default)
EXPLORER_ENGINES = ENGINES + ("packed",)
DEFAULT_EXPLORER_ENGINE = "packed"

__all__ = [
    "Scenario", "CompiledScenario", "default_scenarios", "compile_scenario",
    "clear_scenario_cache", "scenario_cache_stats", "Knob", "DesignSpace",
    "DEFAULT_SPACE", "EXPLORER_ENGINES", "DEFAULT_EXPLORER_ENGINE",
    "grid_candidates", "random_candidates", "pareto_front", "resolve_cells",
    "Explorer", "ExplorationResult",
]


# ---------------------------------------------------------------------------
# scenarios: the (architecture, workload) matrix
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Scenario:
    """One cell of the matrix: how to build (AG, program) from scratch.

    ``params`` is the hashable identity of the cell (sizes, unit counts);
    together with (arch, workload) it keys the AIDG cache.  ``sim_tol`` is
    the expected relative AIDG-vs-event-simulator error (0.0 = exact)."""

    arch: str
    workload: str
    build: Callable[[], Tuple[object, list]]
    params: Tuple[Tuple[str, object], ...] = ()
    sim_tol: float = 0.0

    @property
    def name(self) -> str:
        """Display name, ``arch/workload``."""
        return f"{self.arch}/{self.workload}"

    @property
    def key(self) -> Tuple:
        """AIDG-cache key: (arch, workload, params, builder identity) — the
        builder participates so two scenarios sharing sizes but built by
        different functions don't silently alias in the cache."""
        return (self.arch, self.workload, self.params,
                getattr(self.build, "__module__", ""),
                getattr(self.build, "__qualname__", ""))


def _gamma_units(nu: int) -> Tuple[Tuple[str, str, str], ...]:
    return tuple((f"lsu{k}", f"matMulFu{k}", f"vrf{k}") for k in range(nu))


def _attn_units(nu: int) -> Tuple[Tuple[str, str, str], ...]:
    return tuple((f"lsu{k}", f"matAddFu{k}", f"vrf{k}") for k in range(nu))


def _build_oma_gemm(n: int):
    from ..archs import ARCH_REGISTRY
    from ..mapping.gemm import init_gemm_memory, oma_gemm_looped
    ag, _ = ARCH_REGISTRY["oma"]()
    A = np.ones((n, n))
    init_gemm_memory(ag, A, A)
    return ag, oma_gemm_looped(n, n, n)


def _build_systolic_gemm(m: int, k: int, l: int, rows: int, cols: int):
    from ..archs import ARCH_REGISTRY
    from ..mapping.systolic import init_systolic_memory, systolic_gemm_program
    ag, _ = ARCH_REGISTRY["systolic"](rows, cols)
    init_systolic_memory(ag, np.ones((m, k)), np.ones((k, l)))
    return ag, systolic_gemm_program(m, k, l, rows, cols)


def _build_gamma_gemm(n: int, nu: int):
    from ..archs import ARCH_REGISTRY
    from ..mapping.gemm import gamma_gemm, init_gemm_memory
    ag, _ = ARCH_REGISTRY["gamma"](n_units=nu)
    A = np.ones((n, n), np.float32)
    init_gemm_memory(ag, A, A, memory="dram0", tile=8)
    return ag, gamma_gemm(n, n, n, tile=8, units=_gamma_units(nu))


def _build_gamma_attention(seq: int, ctx: int, hd: int, nu: int):
    from ..archs import ARCH_REGISTRY
    from ..mapping.fused import gamma_attention
    ag, _ = ARCH_REGISTRY["gamma"](n_units=nu)
    return ag, gamma_attention(seq, ctx, hd, units=_attn_units(nu))


def _build_gamma_scan(tokens: int, d_state: int, nu: int):
    from ..archs import ARCH_REGISTRY
    from ..mapping.fused import gamma_scan
    ag, _ = ARCH_REGISTRY["gamma"](n_units=nu)
    return ag, gamma_scan(tokens, d_state, units=_attn_units(nu))


def _build_eyeriss_conv(ifm_h: int, ifm_w: int, flt: int, rows: int, cols: int):
    from ..archs import ARCH_REGISTRY
    from ..mapping.conv import eyeriss_conv2d, init_conv_memory
    ag, _ = ARCH_REGISTRY["eyeriss"](rows=rows, columns=cols)
    init_conv_memory(ag, np.ones((ifm_h, ifm_w)), np.ones((flt, flt)))
    return ag, eyeriss_conv2d(ifm_h, ifm_w, flt, flt, rows, cols)


def _build_plasticine_reduce(n: int, npcu: int):
    from ..archs import ARCH_REGISTRY
    from ..mapping.patterns import init_vector_memory, plasticine_map_reduce
    ag, _ = ARCH_REGISTRY["plasticine"](n_pcu=npcu, n_pmu=npcu)
    init_vector_memory(ag, np.ones(n), npcu)
    return ag, plasticine_map_reduce(n, npcu, npcu)


def _build_tpu(op: str, m: int, k: int, n: int, count: int):
    from ..archs import ARCH_REGISTRY
    from ..mapping.workload import OperatorCall, UMA_REGISTRY
    ag, _ = ARCH_REGISTRY["tpu_v5e"]()
    fn = UMA_REGISTRY[("tpu_v5e", op)]
    return ag, fn(OperatorCall(op, m, k, n, count, "dse"))


def default_scenarios() -> List[Scenario]:
    """The built-in matrix: 6 architectures x 5 workload kinds, 10 mapped
    cells.  Sizes are chosen so every trace builds in well under a second
    while still exercising multi-unit overlap and storage queueing."""

    def S(arch, wl, fn, *args, tol=0.0, **kw):
        # the wrapped builder's identity goes into params: every lambda
        # minted here shares one __qualname__, so Scenario.key's builder
        # guard alone cannot tell two S(...) cells apart
        params = ((("__builder__", f"{fn.__module__}.{fn.__qualname__}"),)
                  + tuple(enumerate(args)) + tuple(sorted(kw.items())))
        return Scenario(arch, wl, lambda: fn(*args, **kw), params, tol)

    return [
        S("oma", "gemm", _build_oma_gemm, 6),
        S("systolic", "gemm", _build_systolic_gemm, 8, 12, 8, 4, 4, tol=0.04),
        S("gamma", "gemm", _build_gamma_gemm, 32, 2, tol=0.02),
        S("gamma", "attention", _build_gamma_attention, 32, 64, 8, 2),
        S("gamma", "scan", _build_gamma_scan, 256, 16, 2),
        S("eyeriss", "conv", _build_eyeriss_conv, 10, 12, 3, 4, 4, tol=0.08),
        S("plasticine", "reduce", _build_plasticine_reduce, 1024, 4, tol=0.02),
        S("tpu_v5e", "gemm", _build_tpu, "gemm", 256, 256, 256, 8, tol=0.02),
        S("tpu_v5e", "attention", _build_tpu, "attention", 128, 256, 256, 8,
          tol=0.02),
        S("tpu_v5e", "scan", _build_tpu, "scan", 128, 512, 2, 8, tol=0.02),
    ]


# ---------------------------------------------------------------------------
# per-scenario compilation + AIDG cache
# ---------------------------------------------------------------------------


@dataclass
class CompiledScenario:
    """Trace + AIDG + DSEProblem for one cell, built once and re-used by
    every sweep (the graph is *structure*; θ only re-weights it).

    Implements the **cell protocol** the :class:`Explorer` evaluates
    against — ``projection`` / ``evaluate`` / ``accumulate_weights`` /
    ``energy_coeffs`` / ``pack_spec`` / ``simulate`` / ``stats_row`` — so
    operator cells and whole-network cells
    (``repro_torch.core.network.CompiledNetwork``) are interchangeable
    columns of the scenario matrix."""

    scenario: Scenario
    aidg: AIDG
    problem: DSEProblem
    baseline: float            # numpy fixed-point makespan at θ = 1

    @property
    def name(self) -> str:
        """Display name inherited from the scenario (``arch/workload``)."""
        return self.scenario.name

    @property
    def arch(self) -> str:
        """The cell's architecture."""
        return self.scenario.arch

    @property
    def workload(self) -> str:
        """The cell's workload kind."""
        return self.scenario.workload

    @property
    def compiled_aidg(self) -> CompiledAIDG:
        """The build-time compilation artifact shared by every sweep."""
        return self.problem.compiled_aidg

    @property
    def schedule(self) -> LevelSchedule:
        """The build-time level schedule: n_levels sequential wavefront
        steps instead of n."""
        return self.compiled_aidg.schedule

    def projection(self, space: "DesignSpace"):
        """The (op -> knob, storage -> knob) gather maps for ``space``."""
        return space.projection(self.problem)

    def evaluate(self, space: "DesignSpace", knob_thetas: np.ndarray,
                 proj=None, n_iters: int = 2, chunk: Optional[int] = None,
                 engine: str = DEFAULT_ENGINE, device=None) -> np.ndarray:
        """(B, n_knobs) shared candidates -> (B,) estimated cycles via the
        cached sweep for this cell's problem on ``device``."""
        to, ts = space.theta_for(self.problem, knob_thetas, proj)
        return sweep(self.problem, to, ts, n_iters=n_iters, chunk=chunk,
                     engine=engine, device=device)

    def accumulate_weights(self, space: "DesignSpace", proj,
                           w: np.ndarray) -> None:
        """Add this cell's parameter volume per knob into ``w`` (in place):
        summed instruction op_scale for op knobs, summed mem_words for
        storage knobs."""
        op_idx, st_idx = proj
        aidg = self.aidg
        node_knob = op_idx[aidg.op_class]
        for ki in range(space.n):
            w[ki] += float(aidg.op_scale[node_knob == ki].sum())
        for st_name, cid in self.problem.node_storage.items():
            ki = st_idx[cid]
            if ki < space.n:
                nodes = aidg.storage_nodes[st_name]
                w[ki] += float(aidg.mem_words[nodes].sum())

    def grad_fn(self, proj, n_iters: int = 2, device=None) -> Callable:
        """Cached value-and-gradient from shared knob space on ``device``:
        ``fn(knobs (B, K), tau) -> (soft cycles (B,), gradient (B, K))``
        tensors (``dse.grad_sweep``)."""
        from .dse import grad_sweep
        op_idx, st_idx = proj
        return grad_sweep(self.problem, op_idx, st_idx, n_iters=n_iters,
                          device=device)

    def energy_coeffs(self, space: "DesignSpace", proj
                      ) -> Tuple[np.ndarray, float]:
        """This cell's folded energy coefficients: ``((n_knobs + 1,)``
        dynamic pJ per knob at θ = 1, static leakage pJ per cycle)."""
        model = energy_model(self.arch)
        return (fold_dyn_energy(self.problem, proj, space.n, model),
                model.static_pj)

    def pack_spec(self, proj, n_knobs: Optional[int] = None) -> PackSpec:
        """This cell's :class:`repro_torch.core.aidg.dse.PackSpec` — a
        single problem, one run of one repetition, no overlap gates.  With
        ``n_knobs`` the spec carries the folded energy coefficients;
        without, energy is omitted (reported as 0)."""
        if n_knobs is None:
            return PackSpec.operator(self.problem, proj)
        model = energy_model(self.arch)
        return PackSpec.operator(
            self.problem, proj,
            edyn=fold_dyn_energy(self.problem, proj, n_knobs, model),
            static_pj=model.static_pj)

    def simulate(self) -> int:
        """Cycle-accurate oracle: rebuild the AG from scratch (the builder's
        functional pre-execution mutates memory) and run the event
        simulator.  Slow — test/check use only."""
        ag, prog = self.scenario.build()
        return simulate(ag, prog).cycles

    def stats_row(self) -> Dict[str, float]:
        """Level-schedule statistics: node count vs critical depth, plus
        the chain-condensed depth the packed engine loops over."""
        s = self.schedule
        c = condense_aidg(self.aidg).stats
        return {"name": self.name, "n": s.n, "levels": s.n_levels,
                "max_width": s.width,
                "parallelism": round(s.parallelism, 2),
                "kept": c["n_kept"],
                "levels_condensed": c["levels_condensed"]}


_AIDG_CACHE: Dict[Tuple, CompiledScenario] = {}
_CACHE_STATS = {"hits": 0, "misses": 0}


def compile_scenario(sc: Scenario, use_cache: bool = True) -> CompiledScenario:
    """(arch, workload) -> CompiledScenario, cached process-wide on
    ``Scenario.key``; the cache counts hits and misses
    (``scenario_cache_stats``) — a layer shape repeated across a network,
    or across networks, compiles once."""
    if use_cache and sc.key in _AIDG_CACHE:
        _CACHE_STATS["hits"] += 1
        return _AIDG_CACHE[sc.key]
    if use_cache:
        _CACHE_STATS["misses"] += 1
    ag, prog = sc.build()
    trace = build_trace(ag, prog)
    aidg = build_aidg(ag, trace)
    prob = make_problem(aidg)
    baseline = float(longest_path_fixed_point(aidg).max())
    cs = CompiledScenario(sc, aidg, prob, baseline)
    if use_cache:
        _AIDG_CACHE[sc.key] = cs
    return cs


def scenario_cache_stats() -> Dict[str, int]:
    """Process-wide AIDG-cache counters: ``{"hits": ..., "misses": ...}``
    (uncached builds count neither)."""
    return dict(_CACHE_STATS)


def clear_scenario_cache() -> None:
    """Drop every cached CompiledScenario and zero the hit/miss counters."""
    _AIDG_CACHE.clear()
    _CACHE_STATS["hits"] = 0
    _CACHE_STATS["misses"] = 0


# ---------------------------------------------------------------------------
# shared design space: named knobs -> per-scenario θ columns
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Knob:
    """One shared multiplicative latency factor.

    ``ops`` / ``storages`` are regexes matched (``re.search``) against the
    DSEProblem's op-class names (e.g. ``gemm@matMulFu#``) and storage names
    (e.g. ``dram0``).  θ < 1 = faster/more expensive hardware."""

    name: str
    lo: float = 0.25
    hi: float = 4.0
    ops: str = ""
    storages: str = ""


@dataclass(frozen=True)
class DesignSpace:
    knobs: Tuple[Knob, ...]

    @property
    def n(self) -> int:
        """Number of shared knobs = columns of a candidate row."""
        return len(self.knobs)

    @property
    def names(self) -> List[str]:
        """Knob names, in candidate-column order."""
        return [k.name for k in self.knobs]

    def _match(self, patterns: List[str], name: str) -> int:
        """Index of the first knob whose pattern matches, else ``self.n``
        (the identity column — that class is not under DSE control)."""
        for ki, pat in enumerate(patterns):
            if pat and re.search(pat, name):
                return ki
        return self.n

    def projection(self, prob: DSEProblem) -> Tuple[np.ndarray, np.ndarray]:
        """Per-problem gather maps (op_class -> knob, storage -> knob)."""
        op_pats = [k.ops for k in self.knobs]
        st_pats = [k.storages for k in self.knobs]
        op_idx = np.asarray([self._match(op_pats, nm) for nm in prob.op_names],
                            dtype=np.int64)
        st_idx = np.asarray([self._match(st_pats, nm)
                             for nm in prob.storage_names], dtype=np.int64)
        return op_idx, st_idx

    def theta_for(self, prob: DSEProblem, knob_thetas: np.ndarray,
                  projection: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, n_knobs) shared candidates -> (B, n_op), (B, n_st) θ for one
        scenario's problem; unmatched classes get the identity 1.0."""
        kt = np.asarray(knob_thetas, np.float32)
        if kt.ndim == 1:
            kt = kt[None, :]
        if kt.shape[1] != self.n:
            raise ValueError(f"candidates have {kt.shape[1]} knobs, "
                             f"space has {self.n}")
        op_idx, st_idx = projection or self.projection(prob)
        padded = np.concatenate(
            [kt, np.ones((kt.shape[0], 1), np.float32)], axis=1)
        return padded[:, op_idx], padded[:, st_idx]

    def clip(self, knob_thetas: np.ndarray) -> np.ndarray:
        """Project candidates into the per-knob [lo, hi] box."""
        lo = np.asarray([k.lo for k in self.knobs], np.float32)
        hi = np.asarray([k.hi for k in self.knobs], np.float32)
        return np.clip(np.asarray(knob_thetas, np.float32), lo, hi)


DEFAULT_SPACE = DesignSpace((
    # compute: matrix-shaped units (MXU / MAC array / conv PE) vs.
    # vector/elementwise units (VPU, matAddFu, map/reduce pipelines)
    Knob("matrix", ops=r"gemm@|^mac|row_conv@"),
    Knob("vector", ops=r"attn@|scan@|matadd@|map@|reduce@|psum_add"),
    Knob("loadstore", ops=r"t_load@|t_store@|^load@|^store@|drain@"),
    # memory hierarchy: on-chip SRAM-class storage vs. external DRAM/HBM
    Knob("onchip", storages=r"spm|glb|pmu|vmem|sram|imem|cache"),
    Knob("dram", storages=r"dram|hbm"),
))


# ---------------------------------------------------------------------------
# candidate generators
# ---------------------------------------------------------------------------


def random_candidates(space: DesignSpace, n: int, seed: int = 0,
                      include_baseline: bool = True) -> np.ndarray:
    """(n, n_knobs) log-uniform samples of the knob box (row 0 = θ = 1 when
    ``include_baseline``, so every batch carries the reference machine)."""
    rng = np.random.default_rng(seed)
    cols = [np.exp(rng.uniform(np.log(k.lo), np.log(k.hi), n))
            for k in space.knobs]
    out = np.stack(cols, axis=1).astype(np.float32)
    if include_baseline and n > 0:
        out[0] = 1.0
    return out


def grid_candidates(space: DesignSpace, points: int = 4) -> np.ndarray:
    """Full factorial grid, ``points`` log-spaced levels per knob ->
    (points ** n_knobs, n_knobs) candidates in deterministic C order."""
    axes = [np.geomspace(k.lo, k.hi, points) for k in space.knobs]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# multi-objective scoring + Pareto frontier
# ---------------------------------------------------------------------------


def pareto_front(objectives: np.ndarray) -> np.ndarray:
    """Indices of the non-dominated rows of a (B, M >= 2) minimization
    problem, sorted by the first objective.  Deterministic: ties broken by
    original row order (stable lexsort); exact duplicates keep the first
    row only.

    Rows with NaN/inf objectives are ignored with a warning: NaN breaks the
    lexsort's ordering contract and an inf-latency row could otherwise be
    "non-dominated" purely by having the smallest cost — a diverged sweep
    (θ outside the evaluator's stable range) must not corrupt the frontier.

    The sweep visits rows in lexicographic order (first objective primary),
    keeping a row unless some earlier sorted row weakly dominates it (<= in
    every objective) — equivalent to checking kept rows only (<= is
    transitive: whatever dominates a dominated row also dominates its
    victims), which turns the scan into one vectorized (B, B) dominance
    mask instead of a Python pairwise loop (the serving tier ranks every
    answer through here, so this is a hot path); on 2-objective input it
    reduces to the classic best-so-far scan bit-for-bit.
    """
    objs = np.asarray(objectives, np.float64)
    assert objs.ndim == 2 and objs.shape[1] >= 2
    finite = np.isfinite(objs).all(axis=1)
    if not finite.all():
        warnings.warn(
            f"pareto_front: ignoring {int((~finite).sum())} candidate(s) "
            f"with non-finite objectives", RuntimeWarning, stacklevel=2)
        if not finite.any():
            return np.zeros(0, dtype=np.int64)
    rows = np.nonzero(finite)[0]
    sub = objs[rows]
    m = sub.shape[1]
    order = np.lexsort(tuple(sub[:, j] for j in range(m - 1, -1, -1)))
    ss = sub[order]
    # dom[i, j] = sorted row j weakly dominates sorted row i; only j < i
    # can apply (lexsorted), so mask the upper triangle + diagonal
    dom = (ss[None, :, :] <= ss[:, None, :]).all(axis=2)
    dom &= np.tri(len(ss), k=-1, dtype=bool)
    return np.asarray(rows[order[~dom.any(axis=1)]], dtype=np.int64)


def resolve_cells(compiled: Sequence, workload: Optional[str] = None,
                  archs: Optional[Sequence[str]] = None) -> List[int]:
    """Query resolution over the cell protocol: matrix column indices of
    the cells matching a (workload, architecture-subset) question.

    ``workload`` matches each cell's ``workload`` property exactly — an
    operator kind (``"gemm"``) for operator cells, a network name
    (``"whisper_small"``) for network cells; ``None`` matches every
    workload.  ``archs`` restricts to those architectures (``None`` = no
    restriction).  Raises ``KeyError`` listing what IS served when
    nothing matches — a typo'd query must fail loudly, not answer over an
    empty subset."""
    if isinstance(archs, str):
        archs = (archs,)
    wanted = None if archs is None else set(archs)
    idx = [i for i, cs in enumerate(compiled)
           if (workload is None or cs.workload == workload)
           and (wanted is None or cs.arch in wanted)]
    if not idx:
        served = sorted({cs.workload for cs in compiled})
        on = sorted({cs.arch for cs in compiled})
        raise KeyError(
            f"no cell matches workload={workload!r} archs={archs!r}; "
            f"served workloads: {served} on architectures: {on}")
    return idx


@dataclass
class ExplorationResult:
    """One batched sweep over the matrix: per-candidate cycles per scenario
    plus the three scalar objectives (latency, energy, area cost) and
    their Pareto-optimal subset."""

    space: DesignSpace
    scenario_names: List[str]
    candidates: np.ndarray      # (B, n_knobs)
    cycles: np.ndarray          # (B, S)
    latency: np.ndarray         # (B,)  mean baseline-relative cycles
    energy: np.ndarray          # (B,)  mean baseline-relative energy
    cost: np.ndarray            # (B,)  area proxy
    pareto: np.ndarray          # indices into candidates, sorted by latency

    def frontier(self) -> List[Dict[str, float]]:
        """The Pareto-optimal designs as dict rows (index, objectives, and
        per-knob θ), sorted by latency."""
        rows = []
        for i in self.pareto:
            row = {"index": int(i), "latency": float(self.latency[i]),
                   "energy": float(self.energy[i]),
                   "cost": float(self.cost[i])}
            row.update({f"theta[{n}]": float(self.candidates[i, j])
                        for j, n in enumerate(self.space.names)})
            rows.append(row)
        return rows

    @property
    def best(self) -> int:
        """Candidate minimizing latency * cost (a scalar compromise)."""
        return int(np.argmin(self.latency * self.cost))


class Explorer:
    """The batched multi-architecture DSE engine on one device.

    Compiles every scenario once (AIDG cache + level schedule), projects
    shared knob vectors to per-scenario θ, and evaluates candidate batches.

    ``engine``: ``"packed"`` (the default) runs the whole matrix through
    one :class:`repro_torch.core.aidg.dse.PackedMatrix` — every cell
    chain-condensed, padded into shape buckets, all cells x all candidates
    together; the per-cell engines evaluate one batched sweep per cell:
    ``"blocked"`` (max-plus Kleene-closure blocks, every ⊗ on the
    hand-written kernel), ``"wavefront"``, ``"condensed"`` or ``"scan"``.

    ``networks=True`` appends the whole-network matrix
    (``repro_torch.core.network.default_network_scenarios``); a model name
    or a list of names appends just those networks.  Each added cell is a
    full DNN lowered layer by layer onto one architecture and scored by
    end-to-end latency.  ``device``: ``cuda`` unless the caller names
    another; without a card and without ``device`` it raises."""

    def __init__(self, scenarios: Optional[Sequence[Scenario]] = None,
                 space: DesignSpace = DEFAULT_SPACE, n_iters: int = 2,
                 use_cache: bool = True,
                 engine: str = DEFAULT_EXPLORER_ENGINE, networks=False,
                 device=None):
        if engine not in EXPLORER_ENGINES:
            raise ValueError(f"unknown engine {engine!r}; "
                             f"choose from {EXPLORER_ENGINES}")
        self.device = resolve_device(device)
        self.space = space
        self.n_iters = n_iters
        self.engine = engine
        self._packed: Optional[PackedMatrix] = None
        cells = list(default_scenarios() if scenarios is None else scenarios)
        if networks:
            from ..network import default_network_scenarios
            # True -> the full default network matrix; names -> just those
            # networks (still every mapping arch); a bare string would
            # iterate its characters, so wrap it
            if isinstance(networks, str):
                networks = [networks]
            cells += default_network_scenarios(
                networks=None if networks is True else networks)
        self.compiled: List[CompiledScenario] = [
            s.compile(use_cache) if hasattr(s, "compile")
            else compile_scenario(s, use_cache) for s in cells]
        self._projections = [cs.projection(space) for cs in self.compiled]
        self._weights: Optional[np.ndarray] = None
        self._energy_arrays_cache = None
        # normalization denominators from the SAME evaluator the sweeps use,
        # so the baseline candidate's latency and energy are exactly 1.0
        bl, ebl = self.evaluate_full(np.ones((1, space.n), np.float32))
        self._baselines = bl[0]
        self._energy_baselines = np.maximum(ebl[0], 1e-30)

    @property
    def scenario_names(self) -> List[str]:
        """Cell names, in matrix-column order."""
        return [cs.name for cs in self.compiled]

    @property
    def baselines(self) -> np.ndarray:
        """(S,) per-cell cycles at θ = 1 from the sweep evaluator."""
        return self._baselines

    @property
    def energy_baselines(self) -> np.ndarray:
        """(S,) per-cell energy (pJ) at θ = 1 from the same evaluator."""
        return self._energy_baselines

    # -- cost/area proxy ----------------------------------------------------

    def knob_weights(self) -> np.ndarray:
        """Area weight per knob ∝ the parameter volume it governs, across
        the whole matrix, normalized to mean 1."""
        if self._weights is not None:
            return self._weights
        w = np.zeros(self.space.n, dtype=np.float64)
        for cs, proj in zip(self.compiled, self._projections):
            cs.accumulate_weights(self.space, proj, w)
        total = w.sum()
        if total <= 0:
            w[:] = 1.0
        else:
            w = w / total * self.space.n
        self._weights = w
        return w

    def cost_proxy(self, knob_thetas: np.ndarray) -> np.ndarray:
        """Silicon-area proxy: Σ_k w_k / θ_k."""
        kt = np.asarray(knob_thetas, np.float64)
        if kt.ndim == 1:
            kt = kt[None, :]
        return (self.knob_weights()[None, :] / kt).sum(axis=1)

    # -- batched evaluation -------------------------------------------------

    def packed_matrix(self) -> PackedMatrix:
        """The matrix-packed evaluator over all cells on this explorer's
        device (built lazily from every cell's ``pack_spec``, energy
        coefficients folded in; cached)."""
        if self._packed is None:
            specs = [cs.pack_spec(proj, n_knobs=self.space.n) for cs, proj
                     in zip(self.compiled, self._projections)]
            self._packed = PackedMatrix.build(specs, self.space.n,
                                              n_iters=self.n_iters,
                                              device=self.device)
        return self._packed

    def _energy_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-cell folded energy coefficients ``((S, n_knobs + 1) dynamic
        pJ per knob, (S,) static pJ per cycle)`` — the closed form the
        per-cell engines apply (the packed engine folds the same)."""
        if self._energy_arrays_cache is None:
            coeffs = [cs.energy_coeffs(self.space, proj) for cs, proj
                      in zip(self.compiled, self._projections)]
            self._energy_arrays_cache = (
                np.stack([c[0] for c in coeffs]).astype(np.float64),
                np.asarray([c[1] for c in coeffs], np.float64))
        return self._energy_arrays_cache

    def evaluate(self, knob_thetas: np.ndarray,
                 chunk: Optional[int] = None, sharded: bool = False,
                 n_devices: Optional[int] = None) -> np.ndarray:
        """(B, n_knobs) candidates -> (B, S) estimated cycles: the packed
        matrix, or one batched sweep per cell for the per-cell engines.
        ``sharded`` splits the candidate axis over the local devices
        (packed engine only; bit for bit the unsharded result)."""
        kt = np.asarray(knob_thetas, np.float32)
        if kt.ndim == 1:
            kt = kt[None, :]
        if self.engine == "packed":
            return self.packed_matrix().evaluate(kt, chunk=chunk,
                                                 sharded=sharded,
                                                 n_devices=n_devices)
        if sharded:
            raise ValueError("sharded evaluation requires engine='packed' "
                             f"(this explorer uses {self.engine!r})")
        cols = [cs.evaluate(self.space, kt, proj, n_iters=self.n_iters,
                            chunk=chunk, engine=self.engine,
                            device=self.device)
                for cs, proj in zip(self.compiled, self._projections)]
        return np.stack(cols, axis=1)

    def evaluate_full(self, knob_thetas: np.ndarray,
                      chunk: Optional[int] = None, sharded: bool = False,
                      n_devices: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, n_knobs) candidates -> ``((B, S) cycles, (B, S) energy
        pJ)``.  The packed engine computes both in one evaluation; the
        per-cell engines apply the closed form ``edyn @ (1/θ) + P_static ·
        cycles`` to their cycles."""
        kt = np.asarray(knob_thetas, np.float32)
        if kt.ndim == 1:
            kt = kt[None, :]
        if self.engine == "packed":
            return self.packed_matrix().evaluate_full(
                kt, chunk=chunk, sharded=sharded, n_devices=n_devices)
        cycles = self.evaluate(kt, chunk=chunk, sharded=sharded,
                               n_devices=n_devices)
        edyn, pstat = self._energy_arrays()
        inv = 1.0 / np.concatenate(
            [kt.astype(np.float64), np.ones((kt.shape[0], 1))], axis=1)
        energy = inv @ edyn.T + pstat[None, :] * cycles.astype(np.float64)
        return cycles, energy.astype(np.float32)

    def explore(self, knob_thetas: np.ndarray,
                chunk: Optional[int] = None) -> ExplorationResult:
        """Evaluate + score + Pareto-extract one candidate batch (three
        objectives: latency, energy, area cost)."""
        kt = np.asarray(knob_thetas, np.float32)
        if kt.ndim == 1:
            kt = kt[None, :]
        cycles, energy_pj = self.evaluate_full(kt, chunk=chunk)
        latency = (cycles / self.baselines[None, :]).mean(axis=1)
        energy = (energy_pj / self.energy_baselines[None, :]).mean(axis=1)
        cost = self.cost_proxy(kt)
        front = pareto_front(np.stack([latency, energy, cost], axis=1))
        return ExplorationResult(self.space, self.scenario_names, kt, cycles,
                                 latency, energy, cost, front)

    # -- refinement: coordinate descent or gradient descent -----------------

    def refine(self, start: Optional[np.ndarray] = None,
               rounds: Optional[int] = None, points: Optional[int] = None,
               objective: str = "product", method: str = "coord",
               **grad_kwargs) -> np.ndarray:
        """Refine the incumbent design.

        ``method="coord"`` (default): deterministic coordinate descent —
        sweep one knob at a time over ``points`` (default 9) log-spaced
        levels (others fixed), keep the argmin, cycle ``rounds`` (default
        2) times; evaluates ``(points + 1) x n_knobs x rounds`` candidates
        through the explorer's engine (the packed matrix by default).

        ``method="grad"``: batched multi-start projected Adam over the
        smooth max-plus relaxation (``core.aidg.gradient``); ``grad_kwargs``
        (``starts``, ``steps``, ``lr``, ``tau0``, ``tau_min``, ``seed``) pass
        through to ``GradientExplorer.refine``.

        Arguments that belong to the *other* method are rejected, not
        silently ignored (``rounds``/``points`` are coordinate-descent
        knobs; the gradient budget is ``starts``/``steps``).

        ``objective``: 'product' minimizes latency * cost; 'latency'
        ignores cost; 'energy' minimizes normalized energy; 'edp' minimizes
        latency * energy."""
        if objective not in ("product", "latency", "energy", "edp"):
            raise ValueError(
                f"objective must be one of 'product', 'latency', 'energy' "
                f"or 'edp', got {objective!r}")
        if method == "grad":
            if rounds is not None or points is not None:
                raise TypeError(
                    "rounds/points configure coordinate descent; for "
                    "method='grad' size the search with starts/steps")
            from .gradient import GradientExplorer
            ge = GradientExplorer(self, objective=objective)
            return ge.refine(start=start, **grad_kwargs).theta
        if method != "coord":
            raise ValueError(f"method must be 'coord' or 'grad', "
                             f"got {method!r}")
        if grad_kwargs:
            raise TypeError(f"unexpected arguments for method='coord': "
                            f"{sorted(grad_kwargs)}")
        rounds = 2 if rounds is None else rounds
        points = 9 if points is None else points
        cur = (np.ones(self.space.n, np.float32) if start is None
               else self.space.clip(start).copy())
        for _ in range(rounds):
            for ki, knob in enumerate(self.space.knobs):
                # the incumbent value is always a candidate level, so a
                # coordinate step can never regress from an off-grid start
                levels = np.append(np.geomspace(knob.lo, knob.hi, points),
                                   cur[ki]).astype(np.float32)
                cand = np.repeat(cur[None, :], len(levels), axis=0)
                cand[:, ki] = levels
                res = self.explore(cand)
                score = {"latency": res.latency,
                         "energy": res.energy,
                         "edp": res.latency * res.energy,
                         "product": res.latency * res.cost}[objective]
                cur = cand[int(np.argmin(score))]
        return cur
