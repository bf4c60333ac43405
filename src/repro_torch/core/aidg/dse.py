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

Not ported yet: the soft family and gradients, ``LayerStack`` and
``PackedMatrix`` (ROADMAP.md, queue A).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from .builder import AIDG, CompiledAIDG, compile_aidg
from .maxplus import DEFAULT_ENGINE, Solver, _fixed_point_core

__all__ = ["DSEProblem", "make_problem", "evaluate_theta", "compiled_sweep",
           "sweep"]


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

    def __call__(self, theta_op, theta_st) -> torch.Tensor:
        to = torch.as_tensor(theta_op, dtype=torch.float32,
                             device=self.device)
        ts = torch.as_tensor(theta_st, dtype=torch.float32,
                             device=self.device)
        work, st_lat, _ = _reweight(self.prob, to, ts, self.arrays)
        # the fixed point reads the unscaled fu_lat for the queueing
        # fold-back; the scaled fu enters through `work`
        base = self.base.expand(work.shape[0], -1).contiguous()
        t = _fixed_point_core(self.solver, work, base, st_lat, self.n_iters)
        return t.amax(dim=1)


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
