"""Whole-network cells: lower a DNN onto an architecture, compose in
max-plus, and plug into the DSE stack.

``NetworkScenario`` is the network-level counterpart of
``explorer.Scenario``: one (architecture, network) cell.  ``compile``
drives the full pipeline

    config -> layer graph -> per-layer lowering -> per-layer CompiledAIDG
           -> LayerStack (max-plus composition structure)

with every per-layer program compiled through the process-wide scenario
cache (``explorer.compile_scenario``), so a layer shape repeated inside a
network — or shared between networks — builds its AIDG exactly once.

``CompiledNetwork`` implements the Explorer's cell protocol
(``projection`` / ``evaluate`` / ``accumulate_weights`` / ``grad_fn`` /
``energy_coeffs`` / ``pack_spec`` / ``simulate`` / ``stats_row``): a
network cell sits in the scenario matrix next to single-operator cells,
is swept by the same shared knob vectors, and reports *end-to-end*
latency — `Explorer(networks=True)` is the
paper's DNN-to-accelerator performance model in the co-design loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...configs import get_config
from ..aidg.dse import (LayerStack, NETWORK_MODES, PackSpec,
                        compiled_network_sweep, grad_network_sweep)
from ..aidg.explorer import (CompiledScenario, DesignSpace,
                             compile_scenario)
from ..aidg.maxplus import DEFAULT_ENGINE
from ...models.config import ShapeConfig
from .graph import NETWORK_SHAPE, LayerGraph, extract_layer_graph
from .lowering import (ARCH_CAPACITY_WORDS, ARCH_TILE_TOL, lower_call,
                       lowerable_ops)

__all__ = ["NetworkScenario", "CompiledNetwork", "default_network_scenarios",
           "NETWORKS", "NETWORK_ARCHS"]

# the default whole-network matrix: the four assigned models the ROADMAP
# names, across every architecture that lowers all of their operators
NETWORKS = ("whisper_small", "olmo_1b", "olmoe_1b_7b", "falcon_mamba_7b")
NETWORK_ARCHS = ("oma", "systolic", "gamma", "eyeriss", "plasticine",
                 "tpu_v5e")

# operation classes counted as pure data movement for the prologue prefix
_MEM_OPS = frozenset({"t_load", "t_store", "load", "store"})


@dataclass(frozen=True)
class NetworkScenario:
    """One (architecture, whole network) cell of the scenario matrix.

    ``mode`` selects the max-plus composition: ``"sequential"`` (layers
    back-to-back — the oracle-matching default) or ``"pipelined"``
    (double-buffered inter-layer overlap bounded by on-chip capacity).
    ``sim_tol`` is the cell's expected AIDG-vs-oracle relative error,
    inherited from its architecture's tile accuracy."""

    arch: str
    network: str
    shape: ShapeConfig = NETWORK_SHAPE
    mode: str = "sequential"

    def __post_init__(self):
        if self.mode not in NETWORK_MODES:
            raise ValueError(f"mode must be one of {NETWORK_MODES}, "
                             f"got {self.mode!r}")

    @property
    def name(self) -> str:
        """Display name, ``arch/network`` (one matrix cell)."""
        return f"{self.arch}/{self.network}"

    @property
    def sim_tol(self) -> float:
        """Expected AIDG-vs-oracle relative error, from the architecture's
        measured tile accuracy (0.0 = cycle-exact tiles)."""
        return ARCH_TILE_TOL[self.arch]

    def layer_graph(self) -> LayerGraph:
        """The network's expanded per-layer operator sequence."""
        return extract_layer_graph(get_config(self.network), self.shape)

    def compile(self, use_cache: bool = True) -> "CompiledNetwork":
        """Lower every layer, compile unique tile programs (shared AIDG
        cache), and assemble the composition stack."""
        lg = self.layer_graph()
        lowered = []
        for call in lg.unique:
            low = lower_call(self.arch, call)
            if low is None:
                raise ValueError(
                    f"{self.name}: operator {call.op!r} has no lowering on "
                    f"{self.arch} (lowerable: {lowerable_ops(self.arch)})")
            lowered.append(low)

        # unique TILE programs (several layers usually share one)
        cells: List[CompiledScenario] = []
        tile_of_unique: List[int] = []
        by_key: Dict[Tuple, int] = {}
        for low in lowered:
            key = low.scenario.key
            if key not in by_key:
                by_key[key] = len(cells)
                cells.append(compile_scenario(low.scenario, use_cache))
            tile_of_unique.append(by_key[key])

        # run-length composition over tile programs; per-run reps fold the
        # per-instance tile extrapolation
        run_layer: List[int] = []
        run_reps: List[float] = []
        run_words: List[float] = []
        for uid, n_inst in lg.runs:
            t = tile_of_unique[uid]
            reps = n_inst * lowered[uid].tiles
            if run_layer and run_layer[-1] == t:
                run_reps[-1] += reps
            else:
                run_layer.append(t)
                run_reps.append(reps)
                run_words.append(lowered[uid].weight_words)

        cap = float(ARCH_CAPACITY_WORDS[self.arch])
        ww = np.asarray(run_words, np.float64)
        fits_within = (2.0 * ww <= cap).astype(np.float32)
        fits_between = ((ww[:-1] + ww[1:]) <= cap).astype(np.float32)

        stack = LayerStack(
            problems=[c.problem for c in cells],
            prologue_len=np.asarray([_prologue_len(c) for c in cells],
                                    np.int64),
            run_layer=np.asarray(run_layer, np.int64),
            run_reps=np.asarray(run_reps, np.float32),
            fits_within=fits_within,
            fits_between=fits_between,
        )
        return CompiledNetwork(self, lg, cells, stack)


def _prologue_len(cs: CompiledScenario) -> int:
    """Length of the load-only instruction prefix of the tile program: the
    part of a layer a double-buffered pipeline can overlap with the
    previous layer's tail (no compute op has consumed its inputs yet)."""
    op_is_mem = np.asarray(
        [nm.split("@")[0] in _MEM_OPS for nm in cs.problem.op_names])
    mem_node = op_is_mem[cs.aidg.op_class]
    k = 0
    while k < cs.aidg.n and mem_node[k]:
        k += 1
    return k


@dataclass
class CompiledNetwork:
    """A compiled whole-network cell: unique tile cells + LayerStack.

    Implements the Explorer cell protocol; every evaluation computes the
    per-unique-layer fixed points and the max-plus composition for the
    whole candidate batch on one device."""

    scenario: NetworkScenario
    layer_graph: LayerGraph
    cells: List[CompiledScenario]       # unique tile programs
    stack: LayerStack
    _sim_cache: Optional[float] = field(default=None, repr=False)

    @property
    def name(self) -> str:
        """Display name inherited from the scenario (``arch/network``)."""
        return self.scenario.name

    @property
    def arch(self) -> str:
        """The cell's architecture (query-resolution protocol)."""
        return self.scenario.arch

    @property
    def workload(self) -> str:
        """The cell's workload kind (query-resolution protocol): the
        network name, so a served query for e.g. ``"whisper_small"``
        resolves to this cell on every mapped architecture."""
        return self.scenario.network

    @property
    def n_layers(self) -> int:
        """Unique per-layer programs (the compile unit)."""
        return len(self.cells)

    @property
    def reps_per_layer(self) -> np.ndarray:
        """(L,) total composed instances per unique tile program."""
        out = np.zeros(len(self.cells), np.float64)
        for t, r in zip(self.stack.run_layer, self.stack.run_reps):
            out[int(t)] += float(r)
        return out

    # -- the cell protocol --------------------------------------------------

    def projection(self, space: DesignSpace) -> List[Tuple]:
        """Per-unique-layer (op -> knob, storage -> knob) gather maps."""
        return [space.projection(p) for p in self.stack.problems]

    def _thetas(self, space: DesignSpace, kt: np.ndarray, proj):
        proj = proj or self.projection(space)
        tos, tss = [], []
        for prob, pr in zip(self.stack.problems, proj):
            to, ts = space.theta_for(prob, kt, pr)
            tos.append(to)
            tss.append(ts)
        return tuple(tos), tuple(tss)

    def evaluate(self, space: DesignSpace, knob_thetas: np.ndarray,
                 proj=None, n_iters: int = 2, chunk: Optional[int] = None,
                 engine: str = DEFAULT_ENGINE, device=None) -> np.ndarray:
        """(B, n_knobs) shared candidates -> (B,) end-to-end network cycles
        through the cached stacked sweep on ``device``."""
        kt = np.asarray(knob_thetas, np.float32)
        if kt.ndim == 1:
            kt = kt[None, :]
        fn = compiled_network_sweep(self.stack, n_iters=n_iters,
                                    engine=engine, mode=self.scenario.mode,
                                    device=device)
        tos, tss = self._thetas(space, kt, proj)
        B = kt.shape[0]
        step = B if chunk is None else chunk
        run = lambda s, e: fn(tuple(x[s:e] for x in tos),
                              tuple(x[s:e] for x in tss)).cpu().numpy()
        return np.concatenate([run(s, min(s + step, B))
                               for s in range(0, B, step)])

    def accumulate_weights(self, space: DesignSpace, proj,
                           w: np.ndarray) -> None:
        """Parameter-volume weights, per unique layer scaled by its total
        composed instances (a block repeated 16x governs 16x the area)."""
        proj = proj or self.projection(space)
        reps = self.reps_per_layer
        for cs, pr, r in zip(self.cells, proj, reps):
            wc = np.zeros_like(w)
            cs.accumulate_weights(space, pr, wc)
            w += wc * r

    def grad_fn(self, proj, n_iters: int = 2, device=None):
        """Cached value-and-gradient of end-to-end soft latency on
        ``device``: ``fn(knobs (B, K), tau) -> (soft cycles (B,), gradient
        (B, K))`` tensors (``dse.grad_network_sweep``)."""
        return grad_network_sweep(self.stack, proj, n_iters=n_iters,
                                  mode=self.scenario.mode, device=device)

    def energy_coeffs(self, space: DesignSpace, proj
                      ) -> Tuple[np.ndarray, float]:
        """Folded energy coefficients of the whole network: per-unique-
        layer dynamic pJ per knob scaled by composed instance counts
        (energy is work — pipelined overlap shortens the makespan, not
        the joules), plus the architecture's static pJ per cycle."""
        from ..archs.energy import energy_model
        from ..aidg.energy import fold_dyn_energy
        model = energy_model(self.arch)
        proj = proj or self.projection(space)
        edyn = np.zeros(space.n + 1, np.float64)
        for prob, pr, r in zip(self.stack.problems, proj,
                               self.reps_per_layer):
            edyn += float(r) * fold_dyn_energy(prob, pr, space.n, model)
        return edyn, model.static_pj

    def pack_spec(self, proj, n_knobs: Optional[int] = None) -> PackSpec:
        """This cell's :class:`repro_torch.core.aidg.dse.PackSpec`: the
        stack's unique tile problems plus its run-length composition arrays.
        Sequential cells zero the overlap gates (one composition formula
        serves both modes); pipelined cells keep them, and the prologue
        boundary is passed through so condensation force-keeps the last
        chain node of every load-only prefix.  With ``n_knobs`` the spec
        carries per-unique-layer folded energy coefficients (the packed
        3-objective dispatch scales them by the run repetitions)."""
        seq = self.scenario.mode == "sequential"
        st = self.stack
        nr = len(st.run_layer)
        edyn: Tuple[np.ndarray, ...] = ()
        static_pj = 0.0
        if n_knobs is not None:
            from ..archs.energy import energy_model
            from ..aidg.energy import fold_dyn_energy
            model = energy_model(self.arch)
            edyn = tuple(fold_dyn_energy(prob, pr, n_knobs, model)
                         for prob, pr in zip(st.problems, proj))
            static_pj = model.static_pj
        return PackSpec(
            problems=tuple(st.problems),
            projections=tuple(tuple(p) for p in proj),
            prologue_len=np.asarray(st.prologue_len, np.int64),
            run_layer=np.asarray(st.run_layer, np.int64),
            run_reps=np.asarray(st.run_reps, np.float32),
            fits_within=(np.zeros(nr, np.float32) if seq
                         else np.asarray(st.fits_within, np.float32)),
            fits_between=(np.zeros(max(0, nr - 1), np.float32) if seq
                          else np.asarray(st.fits_between, np.float32)),
            edyn=edyn, static_pj=static_pj)

    def simulate(self) -> float:
        """Event-simulator oracle, composed the same way the estimate is:
        simulate each unique tile program once, then apply the sequential
        composition Σ reps·sim (memoized — the tiles are immutable)."""
        if self._sim_cache is None:
            sims = np.asarray([c.simulate() for c in self.cells], np.float64)
            self._sim_cache = float((self.reps_per_layer * sims).sum())
        return self._sim_cache

    def stats_row(self) -> Dict[str, float]:
        """Aggregate level-schedule statistics over unique tile programs
        (including the chain-condensed depths the packed engine scans)."""
        n = sum(c.schedule.n for c in self.cells)
        levels = sum(c.schedule.n_levels for c in self.cells)
        rows = [c.stats_row() for c in self.cells]
        return {"name": self.name, "n": n, "levels": levels,
                "max_width": max(c.schedule.width for c in self.cells),
                "parallelism": round(n / max(1, levels), 2),
                "kept": sum(r["kept"] for r in rows),
                "levels_condensed": sum(r["levels_condensed"]
                                        for r in rows)}


def default_network_scenarios(networks: Optional[Sequence[str]] = None,
                              archs: Optional[Sequence[str]] = None,
                              shape: ShapeConfig = NETWORK_SHAPE,
                              mode: str = "sequential"
                              ) -> List[NetworkScenario]:
    """The whole-network matrix: every requested network on every
    architecture that lowers all of its operators (cells that don't map
    are absent, like the operator matrix)."""
    out: List[NetworkScenario] = []
    for net in (NETWORKS if networks is None else networks):
        lg = extract_layer_graph(get_config(net), shape)
        for arch in (NETWORK_ARCHS if archs is None else archs):
            if all(op in lowerable_ops(arch) for op in lg.ops):
                out.append(NetworkScenario(arch, net, shape, mode))
    return out
