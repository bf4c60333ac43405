"""Design-space exploration over ACADL accelerator parameters, in PyTorch.

The AIDG separates *structure* (the dependency DAG, built once per
workload) from *weights* (per-instruction latencies).  Latencies are
re-parameterized as multiplicative factors over the baseline:

    fu_lat_i(θ)  = θ_op[op_class_i]    · fu_lat_i
    mem_lat_i(θ) = θ_st[storage(i)]    · mem_lat_i

so θ = 1 reproduces the modeled accelerator exactly.  ``sweep`` evaluates
a batch of candidate accelerators with an explicit batch dimension over θ;
the trace and graph are never rebuilt, and the structure tensors are moved
to the device once per (problem, n_iters, engine, device).

Whole networks: ``LayerStack`` holds a network's unique per-layer problems
and its run-length max-plus composition (sequential or pipelined);
``compiled_network_sweep`` evaluates it for a candidate batch.

The whole matrix at once: ``PackedMatrix`` packs every unique
(chain-condensed) per-layer problem of every cell into shape buckets and
evaluates all cells x all candidates together — rows and candidates are
explicit batch dimensions, and each bucket's condensed levels and
multi-slot queue steps are Python loops.  It is the Explorer's default
engine.  ``evaluate(sharded=True)`` splits the candidate axis over the
local devices, each holding its own copy of the matrix's arrays.

Not ported yet: the soft family and gradients (``grad_fn``/``grad3_fn``,
ROADMAP.md queue A7).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import resolve_device
from .builder import (AIDG, CompiledAIDG, CondensedAIDG, compile_aidg,
                      condense_aidg)
from .maxplus import (DEFAULT_ENGINE, NEG, Solver, _fixed_point_core,
                      affine_scan)

__all__ = ["DSEProblem", "make_problem", "evaluate_theta", "compiled_sweep",
           "sweep", "LayerStack", "NETWORK_MODES", "compiled_network_sweep",
           "PackSpec", "PackedMatrix"]

GRAD_TODO = ("the soft family and gradients are not ported yet (ROADMAP.md, "
             "queue A7)")


@dataclass
class DSEProblem:
    """One workload's parameterized timing model: the immutable AIDG plus
    the gather maps that turn a θ vector (one factor per op class / storage
    class) into per-node latency scalings, and the per-problem cache of
    device-bound evaluators.  Built once per (architecture, workload) cell
    by ``make_problem``; every sweep re-weights this structure."""

    aidg: AIDG
    op_names: List[str]          # op-class index -> name
    storage_names: List[str]     # storage-class index -> name
    node_op: np.ndarray          # (n,) int32
    node_storage: Dict[str, int] = field(default_factory=dict)  # name -> id
    caidg: Optional[CompiledAIDG] = None
    # (n_iters, engine, device) -> evaluator holding the structure tensors
    _compiled: Dict[Tuple, Callable] = field(default_factory=dict, repr=False)

    @property
    def n_op(self) -> int:
        """Number of op classes = columns of a θ_op candidate row."""
        return len(self.op_names)

    @property
    def n_st(self) -> int:
        """Number of storage classes = columns of a θ_st candidate row."""
        return len(self.storage_names)

    @property
    def compiled_aidg(self) -> CompiledAIDG:
        """The build-time compile artifact (level schedule + gathers)."""
        if self.caidg is None:  # hand-built problems compile lazily
            self.caidg = compile_aidg(self.aidg)
        return self.caidg


def make_problem(aidg: AIDG) -> DSEProblem:
    """AIDG -> DSEProblem: name the op/storage classes, build the per-node
    gather indices, and run the build-time compile pipeline."""
    op_names = [None] * len(aidg.classes)
    for name, idx in aidg.classes.items():
        op_names[idx] = name
    st_names = sorted(aidg.storage_nodes.keys())
    return DSEProblem(aidg=aidg, op_names=op_names, storage_names=st_names,
                      node_op=aidg.op_class,
                      node_storage={s: i for i, s in enumerate(st_names)},
                      caidg=compile_aidg(aidg))


class _Reweight:
    """The θ-independent tensors of ``_reweight`` on one device."""

    def __init__(self, prob: DSEProblem, device: torch.device):
        a = prob.aidg
        T = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x),
                                                         dtype=dt,
                                                         device=device)
        self.fu_lat = T(a.fu_lat)
        self.mem_lat = T(a.mem_lat)
        self.node_op = T(prob.node_op, torch.long)
        self.storages = [(st, cid, T(a.storage_nodes[st], torch.long),
                          T(a.storage_lat[st]))
                         for st, cid in prob.node_storage.items()]


def _reweight(prob: DSEProblem, theta_op: torch.Tensor,
              theta_st: torch.Tensor, arrays: Optional[_Reweight] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """θ (B, n_op), (B, n_st) -> ((B, n) per-node work, {storage: (B, k)}
    scaled storage latencies, (B, n) scaled fu latencies), with the
    1-cycle occupancy floor ``max(1, fu + mem)``."""
    A = arrays or _Reweight(prob, theta_op.device)
    B = theta_op.shape[0]
    fu = A.fu_lat * theta_op[:, A.node_op]
    mem_scale = torch.ones((B, prob.aidg.n), dtype=torch.float32,
                           device=theta_op.device)
    st_lat: Dict[str, torch.Tensor] = {}
    for st, cid, nodes, lat in A.storages:
        th = theta_st[:, cid:cid + 1]
        st_lat[st] = lat * th
        mem_scale[:, nodes] = th
    mem = A.mem_lat * mem_scale
    work = torch.clamp_min(fu + mem, 1.0)
    return work, st_lat, fu


class _Sweep:
    """The cached evaluator of ``compiled_sweep``: the structure tensors of
    one problem on one device, for one (n_iters, engine)."""

    def __init__(self, prob: DSEProblem, n_iters: int, engine: str,
                 device: torch.device):
        self.prob, self.n_iters = prob, n_iters
        self.device = device
        self.arrays = _Reweight(prob, device)
        self.solver = Solver(prob.compiled_aidg, engine, device)
        self.base = torch.as_tensor(prob.aidg.base, dtype=torch.float32,
                                    device=device)

    def tensor(self, x) -> torch.Tensor:
        """``x`` as a float32 tensor on this evaluator's device."""
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def times(self, to: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
        """θ (B, n_op), (B, n_st) -> (B, n) completion times."""
        work, st_lat, _ = _reweight(self.prob, to, ts, self.arrays)
        # the fixed point reads the unscaled fu_lat for the queueing
        # fold-back; the scaled fu enters through `work`
        base = self.base.expand(work.shape[0], -1).contiguous()
        return _fixed_point_core(self.solver, work, base, st_lat,
                                 self.n_iters)

    def __call__(self, theta_op, theta_st) -> torch.Tensor:
        return self.times(self.tensor(theta_op),
                          self.tensor(theta_st)).amax(dim=1)


def compiled_sweep(prob: DSEProblem, n_iters: int = 2,
                   engine: str = DEFAULT_ENGINE, device=None) -> Callable:
    """Cached evaluator for ``prob``: (B, n_op), (B, n_st) -> (B,) cycles
    tensor on ``device``.  The structure tensors are built on the first
    call per (problem, n_iters, engine, device) and reused by every later
    sweep over the same AIDG."""
    dev = resolve_device(device)
    key = (n_iters, engine, str(dev))
    fn = prob._compiled.get(key)
    if fn is None:
        fn = _Sweep(prob, n_iters, engine, dev)
        prob._compiled[key] = fn
    return fn


def evaluate_theta(prob: DSEProblem, theta_op, theta_st, n_iters: int = 2,
                   engine: str = DEFAULT_ENGINE, device=None) -> torch.Tensor:
    """Estimated cycles for one parameter point ((n_op,), (n_st,) -> a
    scalar) or a batch of them ((B, n_op), (B, n_st) -> (B,))."""
    to = torch.as_tensor(theta_op, dtype=torch.float32)
    ts = torch.as_tensor(theta_st, dtype=torch.float32)
    one = to.dim() == 1
    out = compiled_sweep(prob, n_iters, engine, device)(
        to[None] if one else to, ts[None] if one else ts)
    return out[0] if one else out


def sweep(prob: DSEProblem, thetas_op: np.ndarray, thetas_st: np.ndarray,
          n_iters: int = 2, chunk: Optional[int] = None,
          engine: str = DEFAULT_ENGINE, device=None) -> np.ndarray:
    """Evaluate a batch of candidate accelerators.

    ``thetas_op``: (B, n_op), ``thetas_st``: (B, n_st) -> (B,) cycles.

    ``chunk``: split very large batches into fixed-size batches to bound
    peak device memory (the tail chunk is padded with θ = 1 rows to
    ``chunk``, as the reference does, so every batch has the same shape).

    ``engine``: the DAG relaxation inside the fixed point — ``"wavefront"``
    (default, level-scheduled), ``"scan"`` (per-node), or ``"blocked"``
    (max-plus closure blocks, every ⊗ on the hand-written kernel)."""
    if chunk is not None and chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    fn = compiled_sweep(prob, n_iters, engine, device)
    to = np.asarray(thetas_op, np.float32)
    ts = np.asarray(thetas_st, np.float32)
    B = to.shape[0]
    run = lambda a, b: fn(a, b).cpu().numpy()
    if chunk is None or B <= chunk:
        return run(to, ts)
    out = np.empty(B, dtype=np.float32)
    for s in range(0, B, chunk):
        e = min(s + chunk, B)
        if e - s < chunk:  # pad the tail to the chunk shape
            pad = chunk - (e - s)
            co = np.concatenate([to[s:e], np.ones((pad, to.shape[1]),
                                                  np.float32)])
            cs = np.concatenate([ts[s:e], np.ones((pad, ts.shape[1]),
                                                  np.float32)])
            out[s:e] = run(co, cs)[: e - s]
        else:
            out[s:e] = run(to[s:e], ts[s:e])
    return out


# ---------------------------------------------------------------------------
# stacked per-layer programs: whole-network end-to-end latency
# ---------------------------------------------------------------------------

NETWORK_MODES = ("sequential", "pipelined")


@dataclass
class LayerStack:
    """A whole network as a *stack* of per-layer DSE problems plus the
    max-plus composition structure (built by ``repro_torch.core.network``).

    ``problems[u]`` is the AIDG of one **unique** layer program; the
    network's execution order is a sequence of *runs* — maximal stretches
    of ``run_reps[r]`` consecutive instances of unique layer
    ``run_layer[r]`` (a transformer's 16 identical blocks are one run of
    16, a tiled operator's ``tiles`` repeats fold in multiplicatively).

    ``prologue_len[u]`` is the static length of the layer's load-only
    instruction prefix: its completion time is the part of the layer a
    *double-buffered* pipeline can overlap with the previous layer's tail.
    ``fits_within[r]`` / ``fits_between[r]`` are 0/1 capacity gates —
    overlap is only credited when the two layers' stationary working sets
    fit the architecture's on-chip buffer together.

    Composition (per candidate):

    * ``sequential``: Σ_r reps_r · m_{l(r)} — every instance back-to-back;
    * ``pipelined``: the sequential total minus the credited overlaps
      min(p_next, m_prev) — never below any single layer, never above the
      sequential total.
    """

    problems: List[DSEProblem]
    prologue_len: np.ndarray        # (L,) int   — load-only prefix length
    run_layer: np.ndarray           # (R,) int   — unique-layer id per run
    run_reps: np.ndarray            # (R,) float — instances per run
    fits_within: np.ndarray         # (R,) float — 0/1 double-buffer gate
    fits_between: np.ndarray        # (R-1,) float — 0/1 gate to next run
    _compiled: Dict[Tuple, Callable] = field(default_factory=dict, repr=False)

    @property
    def n_layers(self) -> int:
        """Unique per-layer programs in the stack (the compile unit)."""
        return len(self.problems)

    @property
    def instances(self) -> float:
        """Total layer instances composed end-to-end (Σ run reps)."""
        return float(np.asarray(self.run_reps, np.float64).sum())


def _layer_times(sw: "_Sweep", theta_op: torch.Tensor,
                 theta_st: torch.Tensor, k_prologue: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's (makespan, prologue completion), each (B,), at θ — the
    prologue is the hard max over the first ``k_prologue`` (load-only)
    instructions."""
    t = sw.times(theta_op, theta_st)
    p = (t[:, :k_prologue].amax(dim=1) if k_prologue > 0
         else torch.zeros_like(t[:, 0]))
    return t.amax(dim=1), p


def _compose(stack: LayerStack, m: torch.Tensor, p: torch.Tensor,
             mode: str) -> torch.Tensor:
    """(B, L) per-unique-layer makespans/prologues -> (B,) end-to-end
    cycles (overlap can't exceed the previous layer's makespan or the next
    layer's prologue)."""
    dev = m.device
    rl = torch.as_tensor(stack.run_layer, dtype=torch.long, device=dev)
    reps = torch.as_tensor(stack.run_reps, dtype=torch.float32, device=dev)
    mr, pr = m[:, rl], p[:, rl]
    total = (reps * mr).sum(dim=1)
    if mode == "sequential":
        return total
    fw = torch.as_tensor(stack.fits_within, dtype=torch.float32, device=dev)
    within = ((reps - 1.0) * torch.minimum(pr, mr) * fw).sum(dim=1)
    if stack.run_layer.shape[0] > 1:
        fb = torch.as_tensor(stack.fits_between, dtype=torch.float32,
                             device=dev)
        between = (torch.minimum(pr[:, 1:], mr[:, :-1]) * fb).sum(dim=1)
    else:
        between = torch.zeros_like(total)
    return total - within - between


class _NetworkSweep:
    """The cached evaluator of ``compiled_network_sweep``: one ``_Sweep``
    per unique layer problem, then the composition."""

    def __init__(self, stack: LayerStack, n_iters: int, engine: str,
                 mode: str, device: torch.device):
        self.stack, self.mode, self.device = stack, mode, device
        self.sweeps = [compiled_sweep(prob, n_iters, engine, device)
                       for prob in stack.problems]
        self.ks = [int(k) for k in stack.prologue_len]

    def __call__(self, tos: Sequence, tss: Sequence) -> torch.Tensor:
        times = [_layer_times(sw, sw.tensor(to), sw.tensor(ts), k)
                 for sw, k, to, ts in zip(self.sweeps, self.ks, tos, tss)]
        m = torch.stack([t[0] for t in times], dim=1)
        p = torch.stack([t[1] for t in times], dim=1)
        return _compose(self.stack, m, p, self.mode)


def compiled_network_sweep(stack: LayerStack, n_iters: int = 2,
                           engine: str = DEFAULT_ENGINE,
                           mode: str = "sequential", device=None) -> Callable:
    """Cached end-to-end evaluator for a layer stack on ``device``:
    ``fn(tuple of (B, n_op_l), tuple of (B, n_st_l)) -> (B,)`` cycles
    tensor.  Repeated layers are evaluated once per unique program, not
    once per instance."""
    if mode not in NETWORK_MODES:
        raise ValueError(f"mode must be one of {NETWORK_MODES}, got {mode!r}")
    dev = resolve_device(device)
    key = (n_iters, engine, mode, str(dev))
    fn = stack._compiled.get(key)
    if fn is None:
        fn = _NetworkSweep(stack, n_iters, engine, mode, dev)
        stack._compiled[key] = fn
    return fn


# ---------------------------------------------------------------------------
# matrix packing: ALL cells x ALL candidates together
# ---------------------------------------------------------------------------

_BIG = 1e18


@dataclass(frozen=True)
class PackSpec:
    """One cell's contribution to a :class:`PackedMatrix`: its (unique)
    per-layer problems + projections and the max-plus composition arrays.
    An operator cell is the trivial spec — one problem, one run of one
    repetition, no overlap gates; a network cell mirrors its
    :class:`LayerStack` (``fits_*`` all-zero encodes sequential mode, so
    one composition formula serves both modes)."""

    problems: Tuple[DSEProblem, ...]
    projections: Tuple[Tuple[np.ndarray, np.ndarray], ...]
    prologue_len: np.ndarray     # (L,) int — per-problem load-only prefix
    run_layer: np.ndarray        # (R,) int — local problem index per run
    run_reps: np.ndarray         # (R,) float
    fits_within: np.ndarray      # (R,) float 0/1 (0 = no overlap credited)
    fits_between: np.ndarray     # (R-1,) float 0/1
    # energy objective (optional — zero when absent): per-problem folded
    # dynamic pJ per knob (``energy.fold_dyn_energy``, each (n_knobs + 1,))
    # and the cell's static leakage pJ per cycle
    edyn: Tuple[np.ndarray, ...] = ()
    static_pj: float = 0.0

    @staticmethod
    def operator(problem: DSEProblem, projection, edyn=None,
                 static_pj: float = 0.0) -> "PackSpec":
        """The single-problem spec of an operator cell."""
        return PackSpec((problem,), (tuple(projection),),
                        np.zeros(1, np.int64), np.zeros(1, np.int64),
                        np.ones(1, np.float32), np.zeros(1, np.float32),
                        np.zeros(0, np.float32),
                        () if edyn is None else (np.asarray(edyn),),
                        float(static_pj))


@dataclass
class _PackedRow:
    """Per-unique-problem numpy staging arrays (permuted kept space)."""

    problem: DSEProblem
    cond: CondensedAIDG
    fu: np.ndarray               # (nk,) raw FU latency, permuted kept order
    mem: np.ndarray              # (nk,) raw memory latency
    base: np.ndarray             # (nk,) static base
    opk: np.ndarray              # (nk,) knob id scaling fu (K = identity)
    stk: np.ndarray              # (nk,) knob id scaling mem
    prol: np.ndarray             # (nk,) bool — original id < prologue_len
    ab_fu: np.ndarray            # (n_ab,) absorbed-node raw FU latency
    ab_opk: np.ndarray           # (n_ab,) knob id scaling it
    # storages as (perm positions, lats, knob, slots, ordered) — slots == 1
    # solves closed-form, > 1 runs the slot-vector loop; ``ordered`` means
    # the arrival order is PROVABLY static (each access an ancestor of the
    # next), so the per-candidate argsort is the identity and is skipped
    queues: List[Tuple[np.ndarray, np.ndarray, int, int, bool]]


def _stage_row(prob: DSEProblem, proj, k_prologue: int) -> _PackedRow:
    """Condense one problem (prologue boundary force-kept) and gather its
    θ-independent arrays into the permuted kept layout."""
    a = prob.aidg
    cond = condense_aidg(a, boundary=int(k_prologue) if k_prologue else None)
    op_idx, st_idx = (np.asarray(proj[0], np.int64),
                      np.asarray(proj[1], np.int64))
    kop = cond.kept_perm                          # original ids, permuted
    stk_full = np.full(a.n, -1, dtype=np.int64)   # -1 -> identity (patched)
    for st, cid in prob.node_storage.items():
        stk_full[a.storage_nodes[st]] = st_idx[cid]
    queues: List[Tuple[np.ndarray, np.ndarray, int, int, bool]] = []
    ca = prob.compiled_aidg
    for name in ca.storage_order:
        perm_pos = cond.schedule.rank[
            cond.kept_rank[a.storage_nodes[name]]].astype(np.int64)
        lat = np.asarray(a.storage_lat[name], np.float32)
        knob = int(st_idx[prob.node_storage[name]])
        slots = int(a.storage_slots[name])
        queues.append((perm_pos, lat, knob, slots,
                       cond.storage_static_order(name)))
    return _PackedRow(
        problem=prob, cond=cond,
        fu=a.fu_lat[kop].astype(np.float32),
        mem=a.mem_lat[kop].astype(np.float32),
        base=a.base[kop].astype(np.float32),
        opk=op_idx[a.op_class[kop]],
        stk=stk_full[kop],
        prol=(kop < k_prologue),
        ab_fu=a.fu_lat[cond.absorbed].astype(np.float32),
        ab_opk=op_idx[a.op_class[cond.absorbed]],
        queues=queues)


def _cumsum_ordered(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum`` along ``dim`` that adds strictly in order, so a
    candidate's sums do not depend on the batch it rides in.  CUDA scans
    a tensor's last axis (and a tensor of one column) by trees whose shape
    it picks from the number of rows; along a leading axis of several
    columns it adds in order, one thread a column.  (On the CPU every
    scan adds in order.)"""
    y = x.movedim(dim, 0)
    if y.numel() == y.shape[0]:          # one column: give it a second
        return torch.cumsum(torch.stack([y, y], dim=-1),
                            dim=0)[..., 0].movedim(0, dim)
    return torch.cumsum(y, dim=0).movedim(0, dim)


def _sum_ordered(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis in order (see ``_cumsum_ordered``):
    CUDA's reductions pick their thread layout from the number of outputs
    when the axis is longer than a warp, so ``sum`` could change a
    candidate's result with its batch."""
    return _cumsum_ordered(x, x.dim() - 1)[..., -1]


def _device_key(device) -> torch.device:
    """``device`` with its index filled in (``cuda`` -> ``cuda:<current>``),
    so that one device has one cache entry."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _take(x: torch.Tensor, flat_idx: torch.Tensor, shape) -> torch.Tensor:
    """Gather along the flattened trailing axes of a (B, ...) tensor."""
    return x.reshape(x.shape[0], -1).index_select(1, flat_idx).view(
        (x.shape[0],) + tuple(shape))


class _Bucket:
    """One shape bucket's stacked arrays on the device, with the level
    windows and queue gathers pre-flattened, and its fixed point.

    Rows (R) and candidates (B) are explicit batch dimensions: state is
    (B, R, NK + W); a window step gathers every row's window at once with
    flat indices ``r * (NK + W) + position``."""

    def __init__(self, arrays: dict, n_iters: int, device: torch.device):
        A = arrays
        self.NK, self.W, self.P, self.LV = A["NK"], A["W"], A["P"], A["LV"]
        self.R = A["fu"].shape[0]
        self.n_iters = n_iters
        self.has_chains = A["has_chains"]
        NK, W, P, R, LV = self.NK, self.W, self.P, self.R, self.LV
        NT = NK + W
        T = lambda x, dt=None: torch.as_tensor(np.asarray(x), dtype=dt,
                                               device=device)
        L, F = torch.long, torch.float32
        for k in ("fu", "mem", "base", "ab_fu", "ab_const"):
            setattr(self, k, T(A[k], F))
        for k in ("opk", "stk", "ab_opk", "ab_seg"):
            setattr(self, k, T(A[k], L))
        self.nmask, self.prol = T(A["nmask"]), T(A["prol"])
        self.has_prol = T(A["has_prol"], F)
        self.has_absorbed = bool((A["pidx"] >= 0).any()
                                 or (A["vp"] >= 0).any())
        self.const = T(A["const"], F)
        self.pidx = T(A["pidx"], L)
        self.vc, self.vp = T(A["vc"], F), T(A["vp"], L)
        # level windows: window slots of row r at level l are starts[r, l]
        # + arange(W); flat offsets into (R, NT) and (R, NT, P)
        win = (A["starts"].astype(np.int64)[:, :, None]
               + np.arange(W)[None, None, :]).transpose(1, 0, 2)  # (LV,R,W)
        roff = (np.arange(R) * NT)[None, :, None]
        self.win = T((win + roff).reshape(LV, R * W), L)
        preds = A["preds"].astype(np.int64)                      # (R, NT, P)
        pw = preds[np.arange(R)[None, :, None], win]             # (LV,R,W,P)
        self.valid = T(pw >= 0)
        self.src = T((np.maximum(pw, 0) + roff[..., None])
                     .reshape(LV, R * W * P), L)
        self.exw = T(((win + roff)[..., None] * P + np.arange(P))
                     .reshape(LV, R * W * P), L)
        # storage queues, four families: (single | multi slot) x (ordered
        # | dynamic); only the families present
        self.queues = []
        for key, g in A["queues"].items():
            if not g["present"]:
                continue
            nd = g["nd"]                                   # (R, NS, SA)
            msk = nd >= 0
            ndc = np.maximum(nd, 0)
            self.queues.append(dict(
                single=key.startswith("s1"), ordered=key.endswith("o"),
                SL=g["SL"], shape=nd.shape, msk=T(msk),
                nd_flat=T((ndc + (np.arange(R) * NK)[:, None, None])
                          .reshape(-1), L),
                scatter=T(np.where(msk, nd, NK).reshape(R, -1), L),
                fu=T(A["fu"][np.arange(R)[:, None, None], ndc], F),
                lat=T(g["lat"], F), kn=T(g["kn"], L),
                free0=T(np.where(np.arange(g["SL"])[None, None, :]
                                 < g["sl"][:, :, None], 0.0, _BIG), F)))

    def _relax(self, b, w, extra, v_lv):
        """The condensed wavefront of every row and candidate: (B, R, NK)
        bases -> (B, R, NK) completion times."""
        B = w.shape[0]
        NK, W, P, R = self.NK, self.W, self.P, self.R
        pad = lambda x, v: torch.cat(
            [x, x.new_full((B, R, W), v)], dim=2)
        work_pad, base_pad = pad(w, 0.0), pad(b, NEG)
        t = torch.zeros((B, R, NK + W), dtype=torch.float32, device=w.device)
        tf = t.view(B, -1)
        for lv in range(self.LV):
            wi = self.win[lv]
            r = _take(base_pad, wi, (R, W))
            if P:
                vals = torch.where(self.valid[lv],
                                   _take(t, self.src[lv], (R, W, P))
                                   + _take(extra, self.exw[lv], (R, W, P)),
                                   NEG)
                r = torch.maximum(r, vals.amax(dim=3))
            h = r + _take(work_pad, wi, (R, W))
            if self.has_chains:
                _, h = affine_scan(_take(v_lv, wi, (R, W)), h)
            tf.index_copy_(1, wi, h.reshape(B, R * W))
        return t[:, :, :NK].contiguous()

    def _queue(self, q, kn, t, w):
        """One queue family for every row, storage and candidate: (scatter
        positions (B, R, NS * SA), service needs)."""
        B = t.shape[0]
        R, NS, SA = q["shape"]
        msk = q["msk"]
        t_nd = _take(t, q["nd_flat"], (R, NS, SA))
        w_nd = _take(w, q["nd_flat"], (R, NS, SA))
        lat = q["lat"] * kn[:, q["kn"]][..., None]
        arr = torch.where(msk, t_nd - w_nd, _BIG)
        if q["ordered"]:          # provably static order: argsort = id
            arr_s, lat_s = arr, lat
        else:
            o = torch.argsort(arr, dim=3, stable=True)
            arr_s, lat_s = arr.gather(3, o), lat.gather(3, o)
        if q["single"]:
            S = _cumsum_ordered(lat_s, 3)
            done_s = S + torch.cummax(arr_s - S + lat_s, dim=3).values
        else:
            free = q["free0"].expand(B, -1, -1, -1).clone()
            done_s = torch.empty_like(arr_s)
            for k in range(SA):
                j = free.argmin(dim=3, keepdim=True)   # earliest-free slot
                d = torch.maximum(arr_s[..., k:k + 1], free.gather(3, j)) \
                    + lat_s[..., k:k + 1]
                free.scatter_(3, j, d)
                done_s[..., k:k + 1] = d
        if q["ordered"]:
            done = done_s
        else:     # inverse permutation by scatter, not a second sort
            inv = torch.empty_like(o).scatter_(
                3, o, torch.arange(SA, device=o.device).expand_as(o))
            done = done_s.gather(3, inv)
        need = torch.where(msk, done + q["fu"] - w_nd, NEG)
        return need.reshape(B, R, NS * SA)

    def __call__(self, kn: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, K + 1) knobs with the identity column -> per-row (makespan,
        prologue completion), each (B, R)."""
        B = kn.shape[0]
        NK, W, R = self.NK, self.W, self.R
        w = torch.clamp_min(self.fu * kn[:, self.opk]
                            + self.mem * kn[:, self.stk], 1.0)
        w_pad = torch.cat([w, w.new_zeros((B, R, W))], dim=2)
        coupled = self.vc > NEG / 2
        if self.has_absorbed:
            aw = torch.clamp_min(self.ab_fu * kn[:, self.ab_opk], 1.0) \
                + self.ab_const
            tot0 = torch.cat([aw.new_zeros((B, R, 1)),
                              _cumsum_ordered(aw, 2)], dim=2)
            prefix = tot0[:, :, 1:] - tot0.gather(
                2, self.ab_seg.expand(B, -1, -1))
            gat = lambda ix: prefix.gather(
                2, ix.clamp(min=0).reshape(R, -1).expand(B, -1, -1)
            ).view((B,) + tuple(ix.shape))
            extra = self.const + torch.where(self.pidx >= 0, gat(self.pidx),
                                             0.0)
            v_lv = torch.where(coupled, self.vc + torch.where(
                self.vp >= 0, gat(self.vp), 0.0) + w_pad, NEG)
        else:
            extra = self.const[None]      # one copy for every candidate
            v_lv = torch.where(coupled, self.vc + w_pad, NEG)
        t = self._relax(self.base.expand(B, -1, -1), w, extra, v_lv)
        for _ in range(self.n_iters if self.queues else 0):
            need_full = torch.full((B, R, NK + 1), NEG, dtype=torch.float32,
                                   device=kn.device)
            for q in self.queues:
                need_full.scatter_reduce_(
                    2, q["scatter"].expand(B, -1, -1),
                    self._queue(q, kn, t, w), "amax", include_self=True)
            t = self._relax(torch.maximum(self.base, need_full[:, :, :NK]),
                            w, extra, v_lv)
        m = torch.where(self.nmask, t, NEG).amax(dim=2)
        p = torch.where(self.prol, t, NEG).amax(dim=2)
        return m, torch.where(self.has_prol > 0, p, 0.0)


class PackedMatrix:
    """The whole scenario/network matrix as ONE evaluator.

    Every unique (condensed) per-layer problem across all cells becomes one
    *row*: its level windows, predecessor slots, absorbed-prefix tables,
    and storage queues are padded to shared shapes and evaluated for all
    rows and all candidates together, with masking keeping padded
    rows/slots/accesses inert.  Rows are grouped into *shape buckets*
    (``_bucketize``) so a width-1 chain cell never pays a wide systolic
    cell's window.  Cells then compose their rows' makespans (and prologue
    times, for pipelined network cells) with the same run-length max-plus
    formula as :class:`LayerStack` — a tile program shared by several
    networks is evaluated once per candidate, not once per cell.

    Built by :meth:`build` from cell :class:`PackSpec`s on one device;
    ``repro_torch.core.aidg.explorer.Explorer`` (``engine="packed"``, the
    default) routes ``evaluate`` and coordinate descent through it.
    """

    def __init__(self, rows: List[_PackedRow], specs: List[PackSpec],
                 row_of: List[List[int]], n_knobs: int, n_iters: int,
                 device: torch.device):
        self.rows = rows
        self.specs = specs
        self.row_of = row_of          # per cell: global row id per problem
        self.n_knobs = n_knobs
        self.n_iters = n_iters
        self.device = device
        self._arrays: Dict[torch.device, dict] = {}   # device -> arrays
        self._buckets: Optional[List[List[int]]] = None

    # -- construction -------------------------------------------------------

    @staticmethod
    def build(specs: Sequence[PackSpec], n_knobs: int, n_iters: int = 2,
              device=None) -> "PackedMatrix":
        """Dedup problems across cells (by object identity — the scenario
        cache already shares repeated tile programs), condense each exactly
        once with its prologue boundary, and stage the packed arrays."""
        dev = resolve_device(device)
        by_id: Dict[int, int] = {}
        staged: List[List] = []
        row_of: List[List[int]] = []
        for spec in specs:
            ids = []
            for prob, proj, k in zip(spec.problems, spec.projections,
                                     spec.prologue_len):
                rid = by_id.get(id(prob))
                if rid is None:
                    rid = len(staged)
                    by_id[id(prob)] = rid
                    staged.append([prob, proj, int(k)])
                else:
                    staged[rid][2] = max(staged[rid][2], int(k))
                ids.append(rid)
            row_of.append(ids)
        rows = [_stage_row(prob, proj, k) for prob, proj, k in staged]
        return PackedMatrix(rows, list(specs), row_of, n_knobs, n_iters, dev)

    @property
    def n_rows(self) -> int:
        """Unique packed problems."""
        return len(self.rows)

    @property
    def n_cells(self) -> int:
        """Matrix cells composed from the packed rows."""
        return len(self.specs)

    def stats(self) -> Dict[str, float]:
        """Aggregate packing/condensation statistics: total vs kept nodes,
        original vs condensed level totals, shape-bucket count, and the
        padded sequential loop total (one loop per bucket)."""
        conds = [r.cond for r in self.rows]
        lv0 = sum(c.stats["levels"] for c in conds)
        lv1 = sum(c.stats["levels_condensed"] for c in conds)
        buckets = self._bucketize()
        scan = sum(max(conds[i].schedule.n_levels for i in b)
                   for b in buckets)
        return {"rows": self.n_rows, "cells": self.n_cells,
                "nodes": sum(c.n for c in conds),
                "kept": sum(c.n_kept for c in conds),
                "levels": lv0, "levels_condensed": lv1,
                "level_reduction": lv0 / max(1, lv1),
                "buckets": len(buckets), "scan_len": scan}

    # -- packed constant arrays --------------------------------------------

    def _bucketize(self) -> List[List[int]]:
        """Group rows into shape buckets so padding waste stays bounded:
        every bucket member is padded to the bucket's (levels, width,
        preds) maxima, so a single global bucket would make every small
        cell pay the largest cell's scan.  Greedy assignment in descending
        per-row cost, joining a bucket only when the added padded work
        stays within 1.5x the row's own work.  Memoized — ``stats`` and
        ``_build_arrays`` share one assignment."""
        if self._buckets is not None:
            return self._buckets
        rows = self.rows

        def qlen(i):   # sequential multi-slot queue steps (per iteration)
            return max((len(nd) for nd, _, _, sl, _ in rows[i].queues
                        if sl > 1), default=0)

        def rcost(i):
            c = rows[i].cond
            return (max(1, c.schedule.n_levels) * max(1, c.schedule.width)
                    * max(1, c.preds_lv.shape[1])
                    + self.n_iters * qlen(i) * 8)

        def bcost(members):
            lv = max(rows[i].cond.schedule.n_levels for i in members)
            w = max(rows[i].cond.schedule.width for i in members)
            p = max(rows[i].cond.preds_lv.shape[1] for i in members)
            q = self.n_iters * max(qlen(i) for i in members)
            return (len(members)
                    * (max(1, lv) * max(1, w) * max(1, p) + q * 8))

        order = sorted(range(len(rows)), key=lambda i: (-rcost(i), i))
        buckets: List[List[int]] = []
        # rows with affine chains never share a bucket with chain-free rows
        # (the in-window affine scan is a per-bucket constant, and it costs
        # real per-step kernels)
        chainy = [rows[i].cond.stats["n_coupled"] > 0
                  for i in range(len(rows))]
        for i in order:
            best, best_delta = None, None
            for b in buckets:
                if chainy[b[0]] != chainy[i]:
                    continue
                delta = bcost(b + [i]) - bcost(b)
                if best_delta is None or delta < best_delta:
                    best, best_delta = b, delta
            if best is not None and best_delta <= 1.5 * rcost(i):
                best.append(i)
            else:
                buckets.append([i])
        self._buckets = buckets
        return buckets

    def _bucket_arrays(self, members: List[int]) -> dict:
        """Stage one bucket's stacked numpy arrays (dims = bucket maxima)."""
        rows = [self.rows[i] for i in members]
        K = self.n_knobs
        NK = max(r.cond.n_kept for r in rows)
        W = max(r.cond.schedule.width for r in rows)
        P = max(r.cond.preds_lv.shape[1] for r in rows)
        LV = max(r.cond.schedule.n_levels for r in rows)
        AB = max(1, max(r.cond.n_absorbed for r in rows))
        R = len(rows)

        fu = np.zeros((R, NK), np.float32)
        mem = np.zeros((R, NK), np.float32)
        base = np.full((R, NK), NEG, np.float32)
        opk = np.full((R, NK), K, np.int64)
        stk = np.full((R, NK), K, np.int64)
        nmask = np.zeros((R, NK), bool)
        prol = np.zeros((R, NK), bool)
        has_prol = np.zeros((R,), np.float32)
        preds = np.full((R, NK + W, P), -1, np.int32)
        const = np.zeros((R, NK + W, P), np.float32)
        pidx = np.full((R, NK + W, P), -1, np.int32)
        vc = np.full((R, NK + W), NEG, np.float32)
        vp = np.full((R, NK + W), -1, np.int32)
        starts = np.full((R, LV), NK, np.int32)
        ab_fu = np.zeros((R, AB), np.float32)
        ab_opk = np.full((R, AB), K, np.int64)
        ab_const = np.zeros((R, AB), np.float32)
        ab_seg = np.tile(np.arange(AB, dtype=np.int64), (R, 1))

        for i, r in enumerate(rows):
            c = r.cond
            nk, w, p = c.n_kept, c.schedule.width, c.preds_lv.shape[1]
            fu[i, :nk] = r.fu
            mem[i, :nk] = r.mem
            base[i, :nk] = r.base
            opk[i, :nk] = r.opk
            stk[i, :nk] = np.where(r.stk >= 0, r.stk, K)
            nmask[i, :nk] = True
            prol[i, :nk] = r.prol
            has_prol[i] = float(r.prol.any())
            preds[i, : nk + w, :p] = c.preds_lv
            const[i, : nk + w, :p] = c.const_lv
            pidx[i, : nk + w, :p] = c.pidx_lv
            vc[i, : nk + w] = c.v_const_lv
            vp[i, : nk + w] = c.v_pidx_lv
            starts[i, : c.schedule.n_levels] = c.schedule.starts
            na = c.n_absorbed
            if na:
                ab_fu[i, :na] = r.ab_fu
                ab_opk[i, :na] = r.ab_opk
                ab_const[i, :na] = c.ab_const
                ab_seg[i, :na] = c.ab_segstart

        # storage queues in four families — (single-slot | multi-slot) x
        # (statically-ordered | dynamic) — padded over (row, storage,
        # access); ordered families skip the per-candidate argsort
        def select(r, single, ordered):
            return [(nd, lat, kn, sl) for nd, lat, kn, sl, o in r.queues
                    if (sl == 1) == single and o == ordered]

        groups = {}
        for key, single, ordered in (("s1o", True, True),
                                     ("s1d", True, False),
                                     ("smo", False, True),
                                     ("smd", False, False)):
            sel = [select(r, single, ordered) for r in rows]
            NS = max(1, max(len(s) for s in sel))
            SA = max(1, max((len(nd) for s in sel for nd, _, _, _ in s),
                            default=1))
            SL = max(1, max((sl for s in sel for _, _, _, sl in s),
                            default=1))
            g_nd = np.full((R, NS, SA), -1, np.int64)
            g_lat = np.zeros((R, NS, SA), np.float32)
            g_kn = np.full((R, NS), K, np.int64)
            g_sl = np.ones((R, NS), np.int32)
            present = False
            for i, s in enumerate(sel):
                for si, (nd, lat, kn, sl) in enumerate(s):
                    g_nd[i, si, : len(nd)] = nd
                    g_lat[i, si, : len(nd)] = lat
                    g_kn[i, si] = kn
                    g_sl[i, si] = sl
                    present = True
            groups[key] = dict(nd=g_nd, lat=g_lat, kn=g_kn, sl=g_sl, SL=SL,
                               present=present)

        return dict(
            NK=NK, W=W, P=P, LV=LV, AB=AB,
            has_chains=any(r.cond.stats["n_coupled"] > 0 for r in rows),
            fu=fu, mem=mem, base=base, opk=opk, stk=stk, nmask=nmask,
            prol=prol, has_prol=has_prol, preds=preds, const=const,
            pidx=pidx, vc=vc, vp=vp, starts=starts, ab_fu=ab_fu,
            ab_opk=ab_opk, ab_const=ab_const, ab_seg=ab_seg, queues=groups)

    def _build_arrays(self, device: Optional[torch.device] = None) -> dict:
        """The buckets on ``device`` (default: the matrix's), the
        bucket-to-global row order, and the per-cell composition and energy
        arrays; built once per device and cached."""
        dev = _device_key(self.device if device is None else device)
        hit = self._arrays.get(dev)
        if hit is not None:
            return hit
        buckets = self._bucketize()
        bucket_fns = [_Bucket(self._bucket_arrays(b), self.n_iters, dev)
                      for b in buckets]
        # inverse permutation: concatenated bucket outputs -> global row ids
        flat = [i for b in buckets for i in b]
        inv = np.empty(len(flat), np.int64)
        inv[flat] = np.arange(len(flat))

        # composition arrays over cells (global row ids)
        CL = len(self.specs)
        RU = max(1, max(len(s.run_layer) for s in self.specs))
        runs = np.zeros((CL, RU), np.int64)
        reps = np.zeros((CL, RU), np.float32)
        fw = np.zeros((CL, RU), np.float32)
        fb = np.zeros((CL, max(1, RU - 1)), np.float32)
        # per-cell dynamic-energy knob vectors: Σ_runs reps · edyn[layer]
        # (energy is work — overlap shortens the makespan, not the joules)
        edyn_c = np.zeros((CL, self.n_knobs + 1), np.float64)
        pstat = np.zeros((CL,), np.float64)
        for ci, spec in enumerate(self.specs):
            nr = len(spec.run_layer)
            runs[ci, :nr] = np.asarray(self.row_of[ci])[spec.run_layer]
            reps[ci, :nr] = spec.run_reps
            fw[ci, :nr] = spec.fits_within
            if nr > 1:
                fb[ci, : nr - 1] = spec.fits_between
            if spec.edyn:
                for li, r in zip(spec.run_layer, spec.run_reps):
                    edyn_c[ci] += float(r) * np.asarray(spec.edyn[int(li)],
                                                        np.float64)
            pstat[ci] = spec.static_pj

        T = lambda x, dt: torch.as_tensor(x, dtype=dt, device=dev)
        F = torch.float32
        self._arrays[dev] = dict(
            buckets=bucket_fns, inv=T(inv, torch.long), RU=RU,
            runs=T(runs, torch.long), reps=T(reps, F), fw=T(fw, F),
            fb=T(fb, F), edyn=T(edyn_c.astype(np.float32), F),
            pstat=T(pstat.astype(np.float32), F))
        return self._arrays[dev]

    # -- the evaluator ------------------------------------------------------

    def _matrix(self, knobs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, K) knobs -> per-cell ``(cycles (B, S), energy (B, S))`` on
        the knobs' device: every bucket's fixed point, bucket outputs
        re-ordered to global rows, then the run-length composition per
        cell.  Energy rides the same evaluation: the pre-folded
        ``(1/θ) @ edyn`` plus the static term ``P_static · cycles``."""
        A = self._build_arrays(knobs.device)
        B = knobs.shape[0]
        kn = torch.cat([knobs, knobs.new_ones((B, 1))], dim=1)
        outs = [bucket(kn) for bucket in A["buckets"]]
        m = torch.cat([o[0] for o in outs], dim=1)[:, A["inv"]]
        p = torch.cat([o[1] for o in outs], dim=1)[:, A["inv"]]
        runs, reps = A["runs"], A["reps"]
        mr, pr = m[:, runs], p[:, runs]                 # (B, S, RU)
        # sums in order, so a candidate's row does not depend on the batch
        total = _sum_ordered(reps * mr)
        within = _sum_ordered((reps - 1.0) * torch.minimum(pr, mr) * A["fw"])
        if A["RU"] > 1:
            between = _sum_ordered(torch.minimum(pr[:, :, 1:], mr[:, :, :-1])
                                   * A["fb"])
        else:
            between = torch.zeros_like(total)
        cycles = total - within - between
        # DVFS-style dynamic term (faster units burn more pJ per op) plus
        # leakage over the makespan (an elementwise sum, not a matmul, so
        # no TF32 setting can touch it)
        energy = _sum_ordered((1.0 / kn)[:, None, :] * A["edyn"]) \
            + A["pstat"] * cycles
        return cycles, energy

    def evaluate_fn(self) -> Callable:
        """The cycles-only evaluator: ``fn(knobs (B, K) tensor on the
        matrix's device) -> (B, S)`` cycles tensor."""
        return lambda kt: self._matrix(kt)[0]

    def n_shards(self, n_devices: Optional[int] = None) -> int:
        """Devices the sharded evaluator spreads the candidate axis over:
        ``n_devices`` capped by what the matrix's device type offers
        (``torch.cuda.device_count()`` for a matrix on ``cuda``, 1 on the
        CPU), all of them when ``None``."""
        avail = (torch.cuda.device_count() if self.device.type == "cuda"
                 else 1)
        if n_devices is None:
            return avail
        if not (1 <= n_devices <= avail):
            raise ValueError(f"n_devices must be in [1, {avail}], "
                             f"got {n_devices}")
        return int(n_devices)

    def _shard_devices(self, n: int) -> List[torch.device]:
        """The first ``n`` devices of the matrix's device type."""
        if self.device.type == "cuda":
            return [torch.device("cuda", i) for i in range(n)]
        return [self.device] * n

    def sharded_fn(self, n_devices: Optional[int] = None) -> Callable:
        """The device-sharded evaluator: ``fn(knobs (B, K) tensor) ->
        ((B, S) cycles, (B, S) energy)`` on the matrix's device, with the
        CANDIDATE axis cut into ``n_shards`` equal slices, one per device.
        Each device evaluates its slice with its own copy of the matrix's
        arrays; rows are independent, so the result is bit for bit the
        unsharded one.  B must be a multiple of the device count —
        ``evaluate(sharded=True)`` pads for you."""
        devices = self._shard_devices(self.n_shards(n_devices))
        return lambda kt: self._split_matrix(kt, devices)

    def _split_matrix(self, kt: torch.Tensor, devices: Sequence
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cut ``kt`` (B, K) into ``len(devices)`` equal slices, evaluate
        slice i on ``devices[i]`` and gather the slices in order onto the
        matrix's device.  The device list is explicit so that one device
        can stand in for several (the same device may appear many times):
        that checks the split, not the devices."""
        D = len(devices)
        B = kt.shape[0]
        if B % D:
            raise ValueError(f"batch {B} is not a multiple of the "
                             f"{D} devices")
        home = self.device
        outs = [self._matrix(part.to(dev))
                for part, dev in zip(torch.split(kt, B // D), devices)]
        return (torch.cat([c.to(home) for c, _ in outs]),
                torch.cat([e.to(home) for _, e in outs]))

    def evaluate(self, knob_thetas: np.ndarray,
                 chunk: Optional[int] = None, sharded: bool = False,
                 n_devices: Optional[int] = None) -> np.ndarray:
        """(B, n_knobs) candidates -> (B, S) estimated cycles.  ``chunk``
        bounds peak memory (each candidate's row is independent of the
        others, so chunks need no padding).  ``sharded`` splits the
        candidate axis over ``n_devices`` devices (``sharded_fn``) with
        bit-for-bit the same result; the batch is padded with θ = 1 rows
        up to a device multiple and sliced back."""
        return self.evaluate_full(knob_thetas, chunk=chunk, sharded=sharded,
                                  n_devices=n_devices)[0]

    def evaluate_full(self, knob_thetas: np.ndarray,
                      chunk: Optional[int] = None, sharded: bool = False,
                      n_devices: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, n_knobs) candidates -> ``((B, S) cycles, (B, S) energy
        pJ)``, both from the same evaluation; cells built without energy
        coefficients report 0.  Options as :meth:`evaluate`."""
        devices = (self._shard_devices(self.n_shards(n_devices)) if sharded
                   else None)
        return self._evaluate_split(knob_thetas, chunk, devices)

    def _evaluate_split(self, knob_thetas: np.ndarray, chunk: Optional[int],
                        devices: Optional[Sequence]
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """``evaluate_full`` over ``chunk``-row blocks.  With an explicit
        ``devices`` list (``[cpu] * 3`` in the tests, ``[cuda:0] * 4`` on
        one card) each block is padded with θ = 1 rows to a multiple of
        its length, split over them (``_split_matrix``) and the padding
        sliced off; ``None`` evaluates each block whole on the matrix's
        device."""
        kt = torch.as_tensor(np.atleast_2d(np.asarray(knob_thetas,
                                                      np.float32)),
                             device=self.device)
        B = kt.shape[0]
        mult = 1 if devices is None else len(devices)
        up = lambda n: -(-n // mult) * mult   # round up to a device multiple
        step = B if chunk is None else up(max(1, int(chunk)))
        cyc, en = [], []
        with torch.inference_mode():
            for s in range(0, B, step):
                block = kt[s:s + step]
                n = block.shape[0]
                if devices is None:
                    c, e = self._matrix(block)
                else:
                    pad = block.new_ones((up(n) - n, kt.shape[1]))
                    c, e = self._split_matrix(torch.cat([block, pad]),
                                              devices)
                cyc.append(c[:n].cpu().numpy())
                en.append(e[:n].cpu().numpy())
        return np.concatenate(cyc), np.concatenate(en)

    def export_training_table(self, knob_thetas: np.ndarray,
                              chunk: Optional[int] = None
                              ) -> Dict[str, np.ndarray]:
        """Sweep-output export for surrogate training: evaluate
        ``(N, n_knobs)`` candidates plus the θ = 1 reference in ONE chunked
        pass and return ``{"theta" (N, K), "cycles" (N, S), "energy" (N,
        S), "cycles_base" (S,), "energy_base" (S,)}`` — baselines from the
        same evaluation, so ratios are exactly the quantities the packed
        engine normalizes by."""
        kt = np.atleast_2d(np.asarray(knob_thetas, np.float32))
        stacked = np.concatenate(
            [np.ones((1, kt.shape[1]), np.float32), kt], axis=0)
        cycles, energy = self.evaluate_full(stacked, chunk=chunk)
        return {"theta": kt,
                "cycles": cycles[1:], "energy": energy[1:],
                "cycles_base": np.asarray(cycles[0], np.float64),
                "energy_base": np.asarray(energy[0], np.float64)}

    def grad_fn(self, baselines: np.ndarray) -> Callable:
        """Not ported yet (ROADMAP.md, queue A7)."""
        raise NotImplementedError(GRAD_TODO)

    def grad3_fn(self, baselines: np.ndarray,
                 energy_baselines: np.ndarray) -> Callable:
        """Not ported yet (ROADMAP.md, queue A7)."""
        raise NotImplementedError(GRAD_TODO)
