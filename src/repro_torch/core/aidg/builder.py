"""AIDG — Architectural Instruction Dependency Graph (paper §6, [16]).

The event-driven simulator (``repro.core.acadl.sim``) is the cycle-accurate
oracle; the AIDG is the paper's fast path: instruction completion times
satisfy the max-plus recurrence

    t_i = w_i + max(base_i, max_{j -> i} (t_j + d_ji))

over a DAG whose forward edges encode

* **data dependencies** — RAW/WAW from the program-order last-writer map
  (paper Fig. 11),
* **structural hazards** — serialization of instructions through the same
  FunctionalUnit / ExecuteStage (Fig. 10),
* **branch bubbles** — the fetch group after a pc-writer waits for the
  branch to resolve plus a fetch + route refill (Fig. 9),
* **issue-buffer backpressure** — instruction i cannot be in flight before
  instruction i - issue_buffer_size left the buffer,

with ``base_i`` the static fetch-visibility time of i's fetch group.

**DataStorage request slots** (Figs. 12/13) are *not* program-order
serializable: the hardware services requests in arrival order across all
MemoryAccessUnits.  They are handled by the queueing fixed point of
``longest_path_fixed_point``: relax the DAG, replay each storage's accesses
in estimated-arrival order against its request slots, fold the resulting
delays back into the node bases, and iterate — the paper's "fixed point
analysis of consecutive loop iterations" ([16]) in max-plus form.

All DAG edges point forward in trace order, so each relaxation is one O(E)
pass — ``numpy`` here; ``repro.core.aidg.maxplus`` evaluates the same
relaxation as blocked max-plus linear algebra (JAX / Pallas), and
``repro.core.aidg.dse`` vmaps it over accelerator latency parameters for
design-space exploration (the paper's NAS/co-design loop).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..acadl.graph import ArchitectureGraph
from ..acadl.sim import TraceEntry, build_trace
from ..acadl.units import FunctionalUnit

__all__ = ["AIDG", "LevelSchedule", "CompiledAIDG", "CondensedAIDG",
           "build_aidg", "compile_aidg", "compute_level_schedule",
           "condense_aidg", "longest_path", "longest_path_fixed_point",
           "estimate_cycles"]

MAX_PREDS = 12  # minimum padded predecessor slots per node (jnp/Pallas path);
#                 build_aidg widens the padding when a node has more — edges
#                 are never dropped

NEG = -1e18     # max-plus -inf sentinel — THE definition; maxplus/dse
#                 re-import it (condensation writes it into coupling
#                 tables the evaluators compare against)


@dataclass
class AIDG:
    """Padded-CSR forward DAG with per-node work and base offsets."""

    n: int
    work: np.ndarray          # (n,) float32 — w_i = max(1, fu_lat + mem_lat)
    fu_lat: np.ndarray        # (n,) float32 — functional-unit latency
    mem_lat: np.ndarray       # (n,) float32 — total storage latency
    base: np.ndarray          # (n,) float32 — fetch visibility + route latency
    preds: np.ndarray         # (n, MAX_PREDS) int32 — predecessor ids, -1 pad
    pred_extra: np.ndarray    # (n, MAX_PREDS) float32 — extra edge delay
    #                           (t_i >= t_j + pred_extra + w_i)
    # --- storage request-slot queueing (arrival-ordered fixed point) ---
    storage_nodes: Dict[str, np.ndarray] = field(default_factory=dict)
    storage_lat: Dict[str, np.ndarray] = field(default_factory=dict)
    storage_slots: Dict[str, int] = field(default_factory=dict)
    # --- metadata for parameterized re-weighting (DSE) ---
    op_class: np.ndarray = field(                 # (n,) int32
        default_factory=lambda: np.zeros(0, dtype=np.int32))
    op_scale: np.ndarray = field(                 # (n,) float32 — macs/words
        default_factory=lambda: np.zeros(0, dtype=np.float32))
    mem_words: np.ndarray = field(                # (n,) float32
        default_factory=lambda: np.zeros(0, dtype=np.float32))
    classes: Dict[str, int] = field(default_factory=dict)
    stats: Dict[str, Any] = field(default_factory=dict)
    # lazily-built compilation artifact (level schedule + padded gathers),
    # memoized here because the DAG structure is immutable per scenario
    _compiled: Optional["CompiledAIDG"] = field(default=None, repr=False)
    # boundary -> CondensedAIDG, memoized per chain-condensation boundary
    _condensed: Dict[Optional[int], "CondensedAIDG"] = field(
        default_factory=dict, repr=False)

    @property
    def edges(self) -> int:
        """Number of real (non-padding) dependency edges in the DAG."""
        return int((self.preds >= 0).sum())


def _fetch_schedule(ag: ArchitectureGraph, trace: Sequence[TraceEntry]
                    ) -> Tuple[np.ndarray, List[List[int]], int]:
    """Static visibility time of each instruction's fetch group (Fig. 9),
    ignoring dynamic stalls (branch bubbles become AIDG edges)."""
    fetch = ag.fetch_stages[0]
    imau = fetch.imau
    imem = imau.instruction_memory
    port_width = max(1, imem.port_width)
    imem_read_lat = imem.access_latency("read", 0)
    fetch_cost = max(1, imem_read_lat + imau.latency.resolve())

    groups: List[List[int]] = []
    cur: List[int] = []
    for e in trace:
        cur.append(e.idx)
        if len(cur) >= port_width or e.is_pc_writer:
            groups.append(cur)
            cur = []
    if cur:
        groups.append(cur)

    visible = np.zeros(len(trace), dtype=np.float32)
    t = 0
    for g in groups:
        t += fetch_cost
        for idx in g:
            visible[idx] = t
    return visible, groups, fetch_cost


def build_aidg(ag: ArchitectureGraph, trace: Sequence[TraceEntry],
               include_buffer_edges: bool = True) -> AIDG:
    """Trace -> AIDG: derive per-node work/base and the forward dependency
    edges (data, structural, branch-bubble, issue-buffer — see the module
    docstring), pad predecessors to CSR form, record the storage queueing
    and DSE metadata, and run the build-time compile pipeline."""
    n = len(trace)
    work = np.ones(n, dtype=np.float32)
    fu_lat_arr = np.zeros(n, dtype=np.float32)
    mem_lat_arr = np.zeros(n, dtype=np.float32)
    base = np.zeros(n, dtype=np.float32)
    route_lat_arr = np.zeros(n, dtype=np.float32)
    preds: List[List[Tuple[int, float]]] = [[] for _ in range(n)]

    op_class = np.zeros(n, dtype=np.int32)
    op_scale = np.ones(n, dtype=np.float32)
    mem_words = np.zeros(n, dtype=np.float32)
    classes: Dict[str, int] = {}

    visible, groups, fetch_cost = _fetch_schedule(ag, trace)
    fetch = ag.fetch_stages[0]
    ibs = max(1, fetch.issue_buffer_size)

    last_on_unit: Dict[str, int] = {}
    last_on_stage: Dict[str, int] = {}
    storage_nodes: Dict[str, List[int]] = {}
    storage_lat: Dict[str, List[float]] = {}
    storage_slots: Dict[str, int] = {}

    for e in trace:
        i = e.idx
        instr = e.instr

        # ---- work = fu latency + memory latency (>= 1 cycle occupancy) ----
        fl = 0.0
        if e.fu_name is not None:
            fu: FunctionalUnit = ag.by_name[e.fu_name]
            tags = instr.tags
            fl = float(fu.latency.resolve(
                operation=instr.operation,
                words=int(tags.get("words", 1)),
                macs=int(tags.get("macs", tags.get("words", 1)))))
        ml = float(e.mem_latency)
        fu_lat_arr[i] = fl
        mem_lat_arr[i] = ml
        work[i] = max(1.0, fl + ml)

        # ---- base = fetch visibility + route buffer latencies ----
        route_lat = 0.0
        for sname in e.route[:-1]:
            stage = ag.by_name[sname]
            route_lat += float(stage.latency.resolve())
        route_lat_arr[i] = route_lat
        base[i] = visible[i] + route_lat

        # ---- data dependencies ----
        for j in e.deps:
            preds[i].append((j, 0.0))

        # ---- structural: same FunctionalUnit / terminal stage serialize ----
        if e.fu_name is not None:
            j = last_on_unit.get(e.fu_name)
            if j is not None:
                preds[i].append((j, 0.0))
            last_on_unit[e.fu_name] = i
        if e.route:
            stage_name = e.route[-1]
            j = last_on_stage.get(stage_name)
            if j is not None and all(p != j for p, _ in preds[i]):
                preds[i].append((j, 0.0))
            last_on_stage[stage_name] = i

        # ---- storage request-slot queueing records ----
        for st_name, lat in e.mem_parts:
            st = ag.by_name[st_name]
            storage_nodes.setdefault(st_name, []).append(i)
            storage_lat.setdefault(st_name, []).append(float(lat))
            storage_slots[st_name] = max(1, st.max_concurrent_requests)
            mem_words[i] = float(instr.tags.get("words", 1))

        # ---- issue-buffer backpressure (approximation) ----
        if include_buffer_edges and i - ibs >= 0:
            preds[i].append((i - ibs, 0.0))

        # ---- DSE metadata ----
        key = (instr.operation if e.fu_name is None
               else f"{instr.operation}@{_unit_class(e.fu_name)}")
        op_class[i] = classes.setdefault(key, len(classes))
        tags = instr.tags
        op_scale[i] = float(tags.get("macs", tags.get("words", 1)))

    # branch bubbles: every instruction of group g+1 waits for the pc-writer
    # closing group g to resolve, then a fetch + route refill
    for gi in range(len(groups) - 1):
        tail = groups[gi][-1]
        if trace[tail].is_pc_writer:
            for idx in groups[gi + 1]:
                preds[idx].append((tail, fetch_cost + route_lat_arr[idx]))

    # pad to (n, width).  width is normally MAX_PREDS but grows to the true
    # maximum in-degree when a node has more predecessors — truncation here
    # would silently under-estimate the critical path (an edge is a timing
    # constraint; dropping one can only make t_i smaller).
    dedups: List[Dict[int, float]] = []
    overflow = 0
    width = MAX_PREDS
    for ps in preds:
        dedup: Dict[int, float] = {}
        for j, d in ps:
            dedup[j] = max(dedup.get(j, -1.0), d)
        if len(dedup) > MAX_PREDS:
            overflow += 1
            width = max(width, len(dedup))
        dedups.append(dedup)
    if overflow:
        warnings.warn(
            f"build_aidg: {overflow} node(s) exceed MAX_PREDS={MAX_PREDS} "
            f"predecessors; widening padded slots to {width} (no edges "
            f"dropped, but evaluator gathers get proportionally wider)",
            RuntimeWarning, stacklevel=2)
    pred_arr = np.full((n, width), -1, dtype=np.int32)
    pred_extra = np.zeros((n, width), dtype=np.float32)
    for i, dedup in enumerate(dedups):
        # latest predecessors first (they bind tightest; order is cosmetic
        # now that every edge is kept)
        for k, (j, d) in enumerate(sorted(dedup.items(), key=lambda kv: -kv[0])):
            pred_arr[i, k] = j
            pred_extra[i, k] = d

    aidg = AIDG(n=n, work=work, fu_lat=fu_lat_arr, mem_lat=mem_lat_arr,
                base=base, preds=pred_arr, pred_extra=pred_extra,
                storage_nodes={k: np.asarray(v, dtype=np.int64)
                               for k, v in storage_nodes.items()},
                storage_lat={k: np.asarray(v, dtype=np.float32)
                             for k, v in storage_lat.items()},
                storage_slots=storage_slots,
                op_class=op_class, op_scale=op_scale, mem_words=mem_words,
                classes=classes,
                stats={"groups": len(groups), "pred_overflow": overflow,
                       "pred_width": width, "fetch_cost": fetch_cost})
    compile_aidg(aidg)  # level schedule is build-time, structure is static
    return aidg


def _unit_class(fu_name: str) -> str:
    """Collapse template-replicated units (fu[0][1], lsu3) to a class name
    so DSE parameters are shared across identical units."""
    import re

    return re.sub(r"\d+", "#", fu_name)


# ---------------------------------------------------------------------------
# build-time compilation: trace -> AIDG -> LevelSchedule -> CompiledAIDG
# ---------------------------------------------------------------------------


@dataclass
class LevelSchedule:
    """Topological wavefront schedule of the AIDG, in level-major layout.

    ``depth[i]`` is node i's longest-path depth (0 for source nodes, else
    1 + max over predecessors), so every predecessor of a node sits at a
    strictly smaller depth.  Nodes are renumbered level-major (``order``:
    permuted position -> original id; ``rank``: original id -> permuted
    position) so each level occupies the contiguous permuted slots
    ``[starts[d], starts[d] + counts[d])``.  The wavefront evaluator scans
    over ``starts`` with a fixed window of ``width`` slots per step —
    contiguous dynamic slices in, one dynamic-update-slice out — for
    O(n_levels) sequential device steps instead of O(n).  A window wider
    than its level spills into the next level's slots; those lanes compute
    garbage from not-yet-final inputs and are deterministically overwritten
    when their own level runs (windows never reach *earlier* slots).

    ``level_nodes[d]`` lists the original ids at depth d (pad ``n``) — the
    gather-form view kept for inspection and stats.
    """

    n: int
    depth: np.ndarray          # (n,) int32
    level_nodes: np.ndarray    # (n_levels, width) int32, pad = n
    order: np.ndarray          # (n,) int32 — permuted position -> original id
    rank: np.ndarray           # (n,) int32 — original id -> permuted position
    starts: np.ndarray         # (n_levels,) int32 — level start, permuted

    @property
    def n_levels(self) -> int:
        """Critical depth of the DAG = sequential wavefront steps."""
        return int(self.level_nodes.shape[0])

    @property
    def width(self) -> int:
        """Widest level = the wavefront evaluator's window size."""
        return int(self.level_nodes.shape[1])

    @property
    def parallelism(self) -> float:
        """Mean nodes per level = the sequential-depth compression the
        wavefront evaluator gets over the per-node scan."""
        return self.n / max(1, self.n_levels)


def compute_level_schedule(preds: np.ndarray, n: int) -> LevelSchedule:
    """Longest-path depths + level-major renumbering for a padded-CSR
    forward DAG (all predecessor ids < node id)."""
    depth = np.zeros(n, dtype=np.int32)
    for i in range(n):
        row = preds[i]
        js = row[row >= 0]
        if js.size:
            depth[i] = int(depth[js].max()) + 1
    if n == 0:
        z = np.zeros(0, dtype=np.int32)
        return LevelSchedule(0, depth, np.zeros((0, 0), dtype=np.int32),
                             z, z, z)
    n_levels = int(depth.max()) + 1
    counts = np.bincount(depth, minlength=n_levels)
    order = np.argsort(depth, kind="stable")   # trace order within a level
    rank = np.empty(n, dtype=np.int32)
    rank[order] = np.arange(n, dtype=np.int32)
    starts = np.zeros(n_levels, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    level_nodes = np.full((n_levels, int(counts.max())), n, dtype=np.int32)
    cols = np.arange(n) - starts[depth[order]]
    level_nodes[depth[order], cols] = order
    return LevelSchedule(n, depth, level_nodes, order.astype(np.int32), rank,
                         starts.astype(np.int32))


@dataclass
class CompiledAIDG:
    """Build-time compilation artifact: the AIDG plus everything the device
    evaluators need that depends only on *structure* (never on θ): the
    level schedule, the predecessor gather arrays rewritten into the
    schedule's level-major numbering (so each wavefront step reads a
    contiguous window), and per-storage scatter indices in a deterministic
    order.  Built once per scenario by ``compile_aidg`` and shared by every
    sweep over the same graph."""

    aidg: AIDG
    schedule: LevelSchedule
    # (n + width, p_used): predecessor *permuted positions* / extra edge
    # delays, rows in level-major order, -1 pad; the slot axis is trimmed
    # from the AIDG's fixed MAX_PREDS padding to the true maximum in-degree
    # (typically 2-4x narrower — pad slots are pure wasted compute on the
    # device), and the trailing ``width`` rows absorb the last wavefront
    # window's spill
    preds_lv: np.ndarray
    extra_lv: np.ndarray
    storage_order: Tuple[str, ...]
    storage_scatter: Dict[str, np.ndarray]   # name -> (k,) int32 node ids
    # per-block-size banded edge matrices for the blocked engine, built on
    # first use (structure only — runtime work/base are folded at eval)
    _block_cache: Dict[int, Tuple] = field(default_factory=dict, repr=False)

    @property
    def n(self) -> int:
        """Node (instruction) count of the underlying AIDG."""
        return self.aidg.n


def compile_aidg(aidg: AIDG) -> CompiledAIDG:
    """AIDG -> CompiledAIDG, memoized on the AIDG instance (the DAG is
    immutable per scenario; only work/base/storage latencies vary)."""
    if aidg._compiled is not None:
        return aidg._compiled
    sched = compute_level_schedule(aidg.preds, aidg.n)
    # slots are packed left by build_aidg, so trimming to the true maximum
    # in-degree drops only pad columns
    deg = (aidg.preds >= 0).sum(axis=1)
    p = max(1, int(deg.max())) if aidg.n else 1
    w = sched.width
    perm_preds = aidg.preds[sched.order][:, :p]   # (n, p_used), original ids
    mapped = np.where(perm_preds >= 0,
                      sched.rank[np.maximum(perm_preds, 0)], -1)
    preds_lv = np.concatenate(
        [mapped, np.full((w, p), -1, dtype=np.int32)], axis=0)
    extra_lv = np.concatenate(
        [aidg.pred_extra[sched.order][:, :p],
         np.zeros((w, p), dtype=np.float32)], axis=0)
    order = tuple(sorted(aidg.storage_nodes))
    scatter = {s: np.asarray(aidg.storage_nodes[s], dtype=np.int32)
               for s in order}
    ca = CompiledAIDG(aidg=aidg, schedule=sched,
                      preds_lv=preds_lv.astype(np.int32), extra_lv=extra_lv,
                      storage_order=order, storage_scatter=scatter)
    aidg.stats["n_levels"] = sched.n_levels
    aidg.stats["max_level_width"] = sched.width
    aidg._compiled = ca
    return ca


# ---------------------------------------------------------------------------
# θ-parametric chain condensation: CompiledAIDG -> CondensedAIDG
# ---------------------------------------------------------------------------


@dataclass
class CondensedAIDG:
    """Chain-condensed evaluation artifact (structure only, exact for every
    θ with per-node work ≥ 1 — the floor every shipped evaluator enforces).

    A maximal run of consecutive *single-node levels* is a chain: each
    member's only timing-relevant input is the member one level up.  A
    member is **absorbed** when (a) it touches no storage request slots
    (the queueing fixed point needs materialized arrival times and base
    fold-backs), (b) every non-direct predecessor edge is dominated by the
    direct chain edge for all θ (``extra ≤ direct_extra + gap``, each chain
    step contributing work ≥ 1), (c) its static ``base`` is dominated the
    same way, and (d) it has at least one successor (so the makespan
    survives on kept nodes).  An absorbed member's completion time is then
    *exactly* ``t_anchor + Σ (edge extra + w_i(θ))`` over the absorbed
    prefix — a dot product between the segment's 0/1 prefix-membership
    vector and the θ-reweighted per-node work vector, evaluated inside the
    trace as one ``cumsum`` (``op_class_counts`` exposes the aggregated
    per-op-class count form of the same super-edges).  Everything a kept
    node reads from an absorbed one is rewritten as a super-edge from the
    segment anchor carrying (constant extra, prefix index).

    Kept nodes keep the exact wavefront recurrence; the level schedule is
    recomputed over the condensed DAG, so the sequential scan length drops
    from the original critical depth to the condensed one (≥ 3x on
    chain-dominated cells — see ``stats``).

    ``boundary`` (optional): the last chain member with original id <
    ``boundary`` is force-kept, so a max over kept nodes with id < boundary
    equals the max over *all* nodes with id < boundary (the network
    frontend's prologue reduction needs this).
    """

    aidg: AIDG
    boundary: Optional[int]
    n_kept: int
    kept: np.ndarray           # (n_kept,) original ids, ascending
    kept_rank: np.ndarray      # (n,) original id -> kept index, -1 = absorbed
    absorbed: np.ndarray       # (n_ab,) original ids, segment-major order
    ab_anchor: np.ndarray      # (n_ab,) kept index of the segment anchor
    ab_const: np.ndarray       # (n_ab,) f32 — direct-step edge extra into it
    ab_segstart: np.ndarray    # (n_ab,) int32 — segment's first position
    # UNIT-level wavefront schedule: a unit is either one kept node or a
    # maximal *affine chain* of kept nodes (single-node condensed levels
    # whose only live input is the previous chain member — storage
    # accessors included, their base still binds).  One scan step per unit
    # level; each chain inside a window evaluates closed-form by the
    # associative max-plus affine scan, so sequential depth is the number
    # of unit levels, not chain length.
    schedule: LevelSchedule    # over kept indices, unit-major renumbering
    # level-major condensed predecessor slots (rows: permuted kept position
    # + trailing width spill, like CompiledAIDG.preds_lv): source permuted
    # position, constant extra, and the absorbed-prefix index (-1 = the
    # source is kept, edge weight is just the constant).  Chain-coupled
    # nodes carry NO slots — their single live input is the in-window
    # affine coupling (v_const_lv / v_pidx_lv; the coupling weight at θ is
    # const + prefix + own work).
    preds_lv: np.ndarray       # (n_kept + W, P) int32
    const_lv: np.ndarray       # (n_kept + W, P) f32
    pidx_lv: np.ndarray        # (n_kept + W, P) int32
    v_const_lv: np.ndarray     # (n_kept + W,) f32 — NEG = not coupled
    v_pidx_lv: np.ndarray      # (n_kept + W,) int32 — -1 = no prefix
    kept_perm: np.ndarray      # (n_kept,) original ids in permuted order
    ab_anchor_perm: np.ndarray  # (n_ab,) permuted position of the anchor
    stats: Dict[str, Any] = field(default_factory=dict)

    @property
    def n(self) -> int:
        """Original node count (the condensed evaluator still consumes and
        reconstructs full-length work/base/t vectors)."""
        return self.aidg.n

    @property
    def n_absorbed(self) -> int:
        """Nodes folded into super-edges (``n - n_kept``)."""
        return int(self.absorbed.shape[0])

    def storage_scatter_kept(self, name: str) -> np.ndarray:
        """Kept-index positions of one storage's access nodes (storage
        accessors are never absorbed, so this is total)."""
        return self.kept_rank[self.aidg.storage_nodes[name]].astype(np.int32)

    def storage_static_order(self, name: str) -> bool:
        """True when this storage's accesses are PROVABLY served in access
        order for every θ: each access is a DAG ancestor of the next, so
        ``arrival_{k+1} = t_{k+1} - w_{k+1} ≥ t_k + w_{k+1} - w_{k+1} =
        arrival_k`` (work ≥ 1, extras ≥ 0 — holds on the hard and soft
        paths alike).  A stable argsort of a statically-sorted key vector
        is the identity, so the evaluator skips the per-candidate sort —
        bit-identical results, no sort kernels."""
        return bool(self.stats.get("static_order", {}).get(name, False))

    def op_class_counts(self) -> np.ndarray:
        """(n_segments, n_op_classes) per-op-class count vectors of the
        condensed super-edges: row s counts, per op class, the absorbed
        nodes of segment s — the ``counts ⋅ work(θ)`` view of the prefix
        weights (the evaluator uses the per-node prefix cumsum, which is
        the same dot product at per-node granularity)."""
        if not self.absorbed.size:
            return np.zeros((0, max(1, len(self.aidg.classes))), np.int64)
        seg_id = np.cumsum(np.arange(len(self.absorbed))
                           == self.ab_segstart)  # 1-based per segment
        n_seg = int(seg_id[-1])
        n_cls = max(1, len(self.aidg.classes))
        out = np.zeros((n_seg, n_cls), np.int64)
        np.add.at(out, (seg_id - 1, self.aidg.op_class[self.absorbed]), 1)
        return out


def _chain_absorb_flags(aidg: AIDG, sched: LevelSchedule,
                        boundary: Optional[int]
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-node absorb decision plus the direct chain step (prev, extra).

    Returns (absorb bool (n,), chain_prev int (n,), chain_extra f32 (n,)):
    ``chain_prev[i]``/``chain_extra[i]`` are the single dominating direct
    edge of an absorbed node (undefined elsewhere)."""
    n = aidg.n
    absorb = np.zeros(n, dtype=bool)
    chain_prev = np.full(n, -1, dtype=np.int64)
    chain_extra = np.zeros(n, dtype=np.float32)
    if n == 0:
        return absorb, chain_prev, chain_extra
    depth = sched.depth
    n_levels = sched.n_levels
    counts = np.bincount(depth, minlength=n_levels)
    first_at_level = sched.order[sched.starts]          # (n_levels,)
    single = counts == 1
    outdeg = np.zeros(n, dtype=np.int64)
    real = aidg.preds >= 0
    np.add.at(outdeg, aidg.preds[real], 1)
    storage = np.zeros(n, dtype=bool)
    for nodes in aidg.storage_nodes.values():
        storage[nodes] = True
    preds, extra = aidg.preds, aidg.pred_extra

    d = 0
    while d < n_levels:
        if not single[d]:
            d += 1
            continue
        d1 = d
        while d1 + 1 < n_levels and single[d1 + 1]:
            d1 += 1
        # chain run over levels [d, d1]; the entry stays kept
        for lv in range(d + 1, d1 + 1):
            i = int(first_at_level[lv])
            prev = int(first_at_level[lv - 1])
            if storage[i] or outdeg[i] == 0:
                continue
            e_direct = None
            ok = True
            row, ex = preds[i], extra[i]
            for k in range(row.shape[0]):
                j = int(row[k])
                if j < 0:
                    break
                if j == prev:
                    e_direct = float(ex[k])
            if e_direct is None:        # defensive: depth says it exists
                continue
            for k in range(row.shape[0]):
                j = int(row[k])
                if j < 0:
                    break
                if j == prev:
                    continue
                dj = int(depth[j])
                # a side edge is dominated by the direct chain edge when its
                # source is a shallower member of the SAME run and its extra
                # cannot outrun the ≥ 1-cycle-per-step chain (work floor)
                if not (d <= dj <= lv - 2) or int(first_at_level[dj]) != j:
                    ok = False
                    break
                gap = (lv - 1) - dj
                if float(ex[k]) > e_direct + gap + 1e-6:
                    ok = False
                    break
            if ok and float(aidg.base[i]) > (float(aidg.base[prev]) + 1.0
                                             + e_direct + 1e-6):
                ok = False              # the static base could bind
            if ok:
                absorb[i] = True
                chain_prev[i] = prev
                chain_extra[i] = e_direct
        # boundary: keep the deepest run member with original id < boundary
        # so a prefix max over kept ids < boundary stays exact (prologue)
        if boundary is not None:
            q = -1
            for lv in range(d, d1 + 1):
                m = int(first_at_level[lv])
                if m < boundary:
                    q = m
            if q >= 0:
                absorb[q] = False
        d = d1 + 1
    return absorb, chain_prev, chain_extra


def _storage_static_orders(aidg: AIDG) -> Dict[str, bool]:
    """Per storage: is the arrival order provably static (each access a DAG
    ancestor of the next)?  Ancestor sets via one bitset DP over the
    forward CSR; cached on the AIDG (boundary-independent)."""
    hit = aidg.stats.get("storage_static_order")
    if hit is not None:
        return hit
    out: Dict[str, bool] = {}
    if aidg.storage_nodes:
        n = aidg.n
        words = (n + 63) // 64
        anc = np.zeros((n, words), np.uint64)
        preds = aidg.preds
        for i in range(n):
            acc = anc[i]
            for k in range(preds.shape[1]):
                j = int(preds[i, k])
                if j < 0:
                    break
                np.bitwise_or(acc, anc[j], out=acc)
                acc[j >> 6] |= np.uint64(1 << (j & 63))
        for st, nodes in aidg.storage_nodes.items():
            ok = True
            for k in range(len(nodes) - 1):
                a, b = int(nodes[k]), int(nodes[k + 1])
                if not (int(anc[b, a >> 6]) >> (a & 63)) & 1:
                    ok = False
                    break
            out[st] = ok
    aidg.stats["storage_static_order"] = out
    return out


def condense_aidg(aidg: AIDG, boundary: Optional[int] = None
                  ) -> CondensedAIDG:
    """AIDG -> CondensedAIDG (memoized per ``boundary`` on the AIDG):
    collapse provably-linear chain interiors into θ-parametric super-edges
    and recompute the level schedule over the kept nodes.  Exact on the
    hard max-plus path for every θ (work floor ≥ 1); on the smooth τ path
    absorbed steps use their exact sums, giving a *tighter* upper bound of
    the hard result than the uncondensed soft wavefront."""
    hit = aidg._condensed.get(boundary)
    if hit is not None:
        return hit
    ca = compile_aidg(aidg)
    sched0 = ca.schedule
    n = aidg.n
    absorb, chain_prev, chain_extra = _chain_absorb_flags(aidg, sched0,
                                                          boundary)

    kept = np.nonzero(~absorb)[0].astype(np.int64)
    kept_rank = np.full(n, -1, dtype=np.int64)
    kept_rank[kept] = np.arange(len(kept))

    # absorbed nodes in segment-major order (each segment = a maximal
    # absorbed stretch hanging off one kept anchor), with prefix bookkeeping
    ab_list: List[int] = []
    ab_anchor: List[int] = []
    ab_const: List[float] = []
    ab_segstart: List[int] = []
    ab_pos = np.full(n, -1, dtype=np.int64)
    order_by_depth = sched0.order  # absorbed nodes sit on single-node levels
    for i in order_by_depth:
        i = int(i)
        if not absorb[i]:
            continue
        p = int(chain_prev[i])
        pos = len(ab_list)
        if absorb[p]:
            anchor = ab_anchor[ab_pos[p]]
            seg = ab_segstart[ab_pos[p]]
        else:
            anchor = int(kept_rank[p])
            seg = pos
        ab_list.append(i)
        ab_anchor.append(anchor)
        ab_const.append(float(chain_extra[i]))
        ab_segstart.append(seg)
        ab_pos[i] = pos

    # condensed predecessor slots over kept nodes: edges from absorbed
    # sources are rewritten to their segment anchor + prefix index
    nk = len(kept)
    deg = (aidg.preds[kept] >= 0).sum(axis=1) if nk else np.zeros(0, int)
    p_used = max(1, int(deg.max())) if nk else 1
    cpreds = np.full((nk, p_used), -1, dtype=np.int64)
    cconst = np.zeros((nk, p_used), dtype=np.float32)
    cpidx = np.full((nk, p_used), -1, dtype=np.int64)
    for ki, i in enumerate(kept):
        row, ex = aidg.preds[i], aidg.pred_extra[i]
        slot = 0
        for k in range(row.shape[0]):
            j = int(row[k])
            if j < 0:
                break
            if absorb[j]:
                cpreds[ki, slot] = ab_anchor[ab_pos[j]]
                cpidx[ki, slot] = ab_pos[j]
            else:
                cpreds[ki, slot] = kept_rank[j]
            cconst[ki, slot] = float(ex[k])
            slot += 1

    ab_seg_arr = np.asarray(ab_segstart, dtype=np.int64)

    # --- affine-chain coupling over the condensed DAG --------------------
    # A kept node is *coupled* to one predecessor p when every one of its
    # other live edges is provably dominated by the (i, p) edge for all θ:
    # ``extra_k ≤ lb(direct) + D(src_k → p)`` with D the longest path in
    # edges (each edge gains ≥ 1 cycle — work floor), or the side edge is
    # a sub-prefix of the direct super-edge's own segment.  Unlike
    # absorption, the node stays materialized (its base — and any storage
    # fold-back into it — still binds), so storage accessors couple too;
    # each maximal chain then evaluates closed-form by the associative
    # affine scan — this is what collapses lane-parallel graphs (one chain
    # per PE/unit), not just scalar in-order ones.
    coupled = np.zeros(nk, dtype=bool)
    v_const = np.full(nk, NEG, dtype=np.float32)
    v_pidx = np.full(nk, -1, dtype=np.int64)
    chain_prev_k = np.full(nk, -1, dtype=np.int64)
    if nk:
        # all-pairs longest path in edges over the condensed DAG (int16,
        # -1 = unreachable); row i indexed by source
        D = np.full((nk, nk), -1, dtype=np.int16)
        for ki in range(nk):
            acc = D[ki]
            row = cpreds[ki]
            for s in range(p_used):
                j = int(row[s])
                if j < 0:
                    break
                dj = D[j]
                np.maximum(acc, dj + 1, out=acc, where=dj >= 0)
                if acc[j] < 1:
                    acc[j] = 1

        def _seg_count(p):
            return int(p - ab_seg_arr[p] + 1)

        taken = np.zeros(nk, dtype=bool)   # p already continues a chain
        for ki in range(nk):
            slots = [(int(cpreds[ki, s]), float(cconst[ki, s]),
                      int(cpidx[ki, s]))
                     for s in range(p_used) if cpreds[ki, s] >= 0]
            if not slots:
                continue
            # try direct candidates by descending static lower bound
            cands = sorted(
                ((cst + (_seg_count(px) if px >= 0 else 0), src, cst, px)
                 for src, cst, px in slots if not taken[src]),
                key=lambda c: -c[0])
            for lb_d, p, const_d, p_d in cands:
                ok = True
                used_direct = False
                for src, cst, px in slots:
                    if (not used_direct and (src, cst, px)
                            == (p, const_d, p_d)):
                        used_direct = True
                        continue
                    if px < 0:
                        gap = 0 if src == p else int(D[p][src])
                        if (src != p and gap < 0) or cst > lb_d + gap + 1e-6:
                            ok = False
                            break
                    elif (src == p and p_d >= 0
                          and ab_seg_arr[px] == ab_seg_arr[p_d]
                          and px <= p_d):
                        # same-segment sub-prefix: the direct super-edge
                        # walks through every step the side edge counts
                        if cst > const_d + (p_d - px) + 1e-6:
                            ok = False
                            break
                    else:
                        ok = False
                        break
                if ok:
                    coupled[ki] = True
                    v_const[ki] = const_d
                    v_pidx[ki] = p_d
                    chain_prev_k[ki] = p
                    taken[p] = True
                    break
        del D

    # keep the chains only where they pay: the affine associative scan
    # adds per-step kernels, so marginal level reductions (a systolic
    # array's 87 -> 83) cost more than they save, while chain-dominated
    # graphs (2683 -> 1) win enormously.  Rough per-step cost model with a
    # fixed overhead term, measured on the CPU backend.
    if nk and coupled.any():
        unit_of_t = np.full(nk, -1, dtype=np.int64)
        n_units_t = 0
        for ki in range(nk):
            if coupled[ki]:
                unit_of_t[ki] = unit_of_t[chain_prev_k[ki]]
            else:
                unit_of_t[ki] = n_units_t
                n_units_t += 1
        udepth_t = np.zeros(n_units_t, dtype=np.int64)
        for ki in range(nk):
            if coupled[ki]:
                continue
            dmax = -1
            for s in range(p_used):
                j = int(cpreds[ki, s])
                if j >= 0:
                    dmax = max(dmax, int(udepth_t[unit_of_t[j]]))
            udepth_t[unit_of_t[ki]] = dmax + 1
        node_lv = udepth_t[unit_of_t]
        wc = int(np.bincount(node_lv).max())
        n_ulv_c = int(udepth_t.max()) + 1
        deg_live = ((cpreds >= 0) & ~coupled[:, None]).sum(axis=1)
        p_live = max(1, int(deg_live.max()))
        pre = compute_level_schedule(cpreds.astype(np.int32), nk)
        cost_chain = n_ulv_c * (512.0 + wc * (p_live + 3
                                              + 2 * np.log2(max(2, wc))))
        cost_plain = pre.n_levels * (256.0 + pre.width * (p_used + 3))
        if cost_chain >= cost_plain:
            coupled[:] = False
            chain_prev_k[:] = -1
            v_const[:] = NEG
            v_pidx[:] = -1

    # coupled nodes keep no slots — their one live input is the coupling
    live = ~coupled[:, None] & (cpreds >= 0)
    cpreds = np.where(live, cpreds, -1)
    cconst = np.where(live, cconst, 0.0).astype(np.float32)
    cpidx = np.where(live, cpidx, -1)
    # repack slots left so trimming stays tight
    if nk:
        key = np.where(cpreds >= 0, 0, 1)
        slot_order = np.argsort(key, axis=1, kind="stable")
        rows_idx = np.arange(nk)[:, None]
        cpreds = cpreds[rows_idx, slot_order]
        cconst = cconst[rows_idx, slot_order]
        cpidx = cpidx[rows_idx, slot_order]
        deg_live = (cpreds >= 0).sum(axis=1)
        p_used = max(1, int(deg_live.max()))
        cpreds, cconst, cpidx = (cpreds[:, :p_used], cconst[:, :p_used],
                                 cpidx[:, :p_used])

    # --- unit DAG: chains as super-nodes, one scan step per unit level ---
    # kept-index order is topological AND walks every chain head-to-tail
    # (links ascend), so members land in chain order within their unit
    unit_of = np.full(nk, -1, dtype=np.int64)
    unit_members: List[List[int]] = []
    for ki in range(nk):
        if coupled[ki]:
            unit_of[ki] = unit_of[chain_prev_k[ki]]
            unit_members[unit_of[ki]].append(ki)
        else:
            unit_of[ki] = len(unit_members)
            unit_members.append([ki])
    udepth = np.zeros(len(unit_members), dtype=np.int64)
    for u, members in enumerate(unit_members):   # entry pre-depth order
        dmax = -1
        for ki in members:
            for s in range(p_used):
                j = int(cpreds[ki, s])
                if j >= 0:
                    dmax = max(dmax, int(udepth[unit_of[j]]))
        udepth[u] = dmax + 1

    # level-major node ordering: units by (level, entry), members in chain
    # order; windows therefore cover whole chains and the in-window affine
    # coupling never crosses a window boundary
    n_ulv = int(udepth.max()) + 1 if nk else 0
    uorder = sorted(range(len(unit_members)),
                    key=lambda u: (int(udepth[u]), unit_members[u][0]))
    order = np.asarray([ki for u in uorder for ki in unit_members[u]],
                       dtype=np.int64)
    depth_nodes = np.asarray([int(udepth[unit_of[ki]]) for ki in order],
                             dtype=np.int32)
    rank = np.empty(nk, dtype=np.int32)
    rank[order] = np.arange(nk, dtype=np.int32)
    lv_counts = np.bincount(depth_nodes, minlength=max(1, n_ulv))
    starts = np.zeros(max(1, n_ulv), dtype=np.int64)
    np.cumsum(lv_counts[:-1], out=starts[1:])
    width = int(lv_counts.max()) if nk else 0
    level_nodes = np.full((n_ulv, max(1, width)), nk, dtype=np.int32)
    if nk:
        cols = np.arange(nk) - starts[depth_nodes]
        level_nodes[depth_nodes, cols] = order
    depth_full = np.zeros(nk, dtype=np.int32)
    depth_full[order] = depth_nodes
    csched = LevelSchedule(nk, depth_full, level_nodes,
                           order.astype(np.int32), rank,
                           starts[:n_ulv].astype(np.int32))

    w = csched.width
    perm_preds = cpreds[order] if nk else cpreds
    mapped = np.where(perm_preds >= 0,
                      rank[np.maximum(perm_preds, 0)], -1)
    preds_lv = np.concatenate(
        [mapped, np.full((w, p_used), -1, dtype=np.int64)],
        axis=0).astype(np.int32)
    const_lv = np.concatenate(
        [cconst[order] if nk else cconst,
         np.zeros((w, p_used), dtype=np.float32)], axis=0)
    pidx_lv = np.concatenate(
        [cpidx[order] if nk else cpidx,
         np.full((w, p_used), -1, dtype=np.int64)],
        axis=0).astype(np.int32)
    v_const_lv = np.concatenate(
        [v_const[order] if nk else v_const,
         np.full((w,), NEG, dtype=np.float32)])
    v_pidx_lv = np.concatenate(
        [v_pidx[order] if nk else v_pidx,
         np.full((w,), -1, dtype=np.int64)]).astype(np.int32)

    ab_anchor_arr = np.asarray(ab_anchor, dtype=np.int64)
    cond = CondensedAIDG(
        aidg=aidg, boundary=boundary, n_kept=nk, kept=kept,
        kept_rank=kept_rank,
        absorbed=np.asarray(ab_list, dtype=np.int64),
        ab_anchor=ab_anchor_arr,
        ab_const=np.asarray(ab_const, dtype=np.float32),
        ab_segstart=ab_seg_arr,
        schedule=csched, preds_lv=preds_lv, const_lv=const_lv,
        pidx_lv=pidx_lv, v_const_lv=v_const_lv, v_pidx_lv=v_pidx_lv,
        kept_perm=kept[order] if nk else kept,
        ab_anchor_perm=(rank[ab_anchor_arr].astype(np.int64)
                        if len(ab_list) else ab_anchor_arr),
        stats={"n": n, "n_kept": nk, "n_absorbed": len(ab_list),
               "n_coupled": int(coupled.sum()),
               "units": len(unit_members),
               "levels": sched0.n_levels, "levels_condensed": csched.n_levels,
               "level_reduction": sched0.n_levels / max(1, csched.n_levels),
               "static_order": _storage_static_orders(aidg)})
    aidg._condensed[boundary] = cond
    return cond


def longest_path(aidg: AIDG, work: Optional[np.ndarray] = None,
                 base: Optional[np.ndarray] = None) -> np.ndarray:
    """Exact O(E) forward relaxation over the forward DAG (no storage
    queueing): t_i = w_i + max(base_i, max_j (t_j + d_ji))."""
    w = aidg.work if work is None else work
    b = aidg.base if base is None else base
    t = np.zeros(aidg.n, dtype=np.float64)
    preds = aidg.preds
    extra = aidg.pred_extra
    for i in range(aidg.n):
        m = b[i]
        row = preds[i]
        for k in range(row.shape[0]):
            j = row[k]
            if j < 0:
                break
            v = t[j] + extra[i, k]
            if v > m:
                m = v
        t[i] = m + w[i]
    return t


def longest_path_fixed_point(aidg: AIDG, n_iters: int = 3,
                             work: Optional[np.ndarray] = None,
                             base: Optional[np.ndarray] = None,
                             storage_lat: Optional[Dict[str, np.ndarray]] = None,
                             ) -> np.ndarray:
    """Forward relaxation + arrival-ordered request-slot queueing, iterated
    to a fixed point (paper [16]).

    Each outer iteration: (1) exact longest path over the forward DAG with
    the current per-node base offsets; (2) replay every storage's accesses in
    estimated-arrival order against its ``max_concurrent_requests`` slots;
    (3) fold each access's service-completion (+ its unit latency) back into
    the node's base.  Stops early when the makespan is stable.
    """
    import heapq

    w = aidg.work if work is None else work
    b0 = aidg.base if base is None else base
    slat = aidg.storage_lat if storage_lat is None else storage_lat
    b = b0.astype(np.float64).copy()
    t = longest_path(aidg, work=w, base=b)
    if not aidg.storage_nodes:
        return t
    prev_makespan = t.max() if aidg.n else 0.0
    for _ in range(n_iters):
        b = b0.astype(np.float64).copy()
        for st_name, nodes in aidg.storage_nodes.items():
            lats = slat[st_name]
            slots = aidg.storage_slots[st_name]
            # arrival = when the unit would issue the transaction
            arrival = t[nodes] - w[nodes]
            order = np.argsort(arrival, kind="stable")
            heap = [0.0] * slots
            heapq.heapify(heap)
            for k in order:
                i = int(nodes[k])
                begin = max(float(arrival[k]), heapq.heappop(heap))
                done = begin + float(lats[k])
                heapq.heappush(heap, done)
                # t_i >= done + fu_lat_i  ->  base_i >= done + fu - w
                need = done + aidg.fu_lat[i] - w[i]
                if need > b[i]:
                    b[i] = need
        t = longest_path(aidg, work=w, base=b)
        makespan = t.max()
        if abs(makespan - prev_makespan) < 0.5:
            break
        prev_makespan = makespan
    return t


def estimate_cycles(ag: ArchitectureGraph, program: Sequence[Any],
                    entry: int = 0, n_iters: int = 3) -> Tuple[float, AIDG]:
    """Trace + AIDG + fixed-point longest path -> estimated cycles (the
    paper's fast performance estimation)."""
    trace = build_trace(ag, program, entry)
    aidg = build_aidg(ag, trace)
    t = longest_path_fixed_point(aidg, n_iters=n_iters)
    return (float(t.max()) if aidg.n else 0.0), aidg
