"""DSE-as-a-service: a persistent, micro-batching, cache-backed query
engine over the matrix-packed evaluator.

The ROADMAP's millions-of-users story: many concurrent clients ask
"which accelerator + config for my model?" and share ONE compiled engine.
:class:`DSEService` wires three layers together:

* **one packed matrix** — a :class:`repro_torch.core.aidg.explorer.Explorer`
  (``engine="packed"`` by default) whose :class:`PackedMatrix` evaluates
  every cell x every candidate in one evaluation on the explorer's device,
  optionally split over the candidate axis across devices
  (``PackedMatrix.evaluate(sharded=True)``);
* **a bounded micro-batch window** — concurrent queries coalesce into
  shared packed dispatches (:class:`repro_torch.serve.batcher.MicroBatcher`):
  queries arriving within ``window_s`` of each other (up to ``max_batch``)
  ride one device launch, their candidate blocks stacked along the batch
  axis;
* **an answer cache** — canonical query keys (:attr:`Query.key`) memoize
  fully-ranked answers, with hit/miss counters mirroring the scenario
  cache's (``explorer.scenario_cache_stats``); repeated questions never
  touch the device again.

**Determinism.**  Every answer is a pure function of (candidate pool,
query): the pool is fixed at construction, per-candidate evaluation is
row-independent and bitwise deterministic, and ranking is the
deterministic ``pareto_front``.  So the served answer is byte-equal to a
direct Explorer sweep of the same candidates, identical regardless of
arrival order, batching, cache state, or sharding — asserted by
``tests/test_torch_serve.py``.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.aidg.explorer import (Explorer, pareto_front, random_candidates,
                                  resolve_cells, scenario_cache_stats)
from .batcher import MicroBatcher, plan_batches
from .errors import (DeadlineExceeded, OracleUnavailable, PoisonedDispatch,
                     TransientDispatchError)
from .faults import ENV_FAULT_PLAN, FaultInjector, FaultPlan, WorkerKill
from .policy import CircuitBreaker, RetryPolicy
from .query import Answer, Design, Query

__all__ = ["DSEService", "DEGRADED_WIDEN"]

# degraded answers stamp their bound wider than the surrogate's calibrated
# one: while the breaker is open the service also serves cells whose
# bounds would normally fail the routing threshold, so the stated
# contract carries an explicit extra safety factor
DEGRADED_WIDEN = 2.0


@dataclass(frozen=True)
class _Submission:
    """One enqueued query plus its submit-time metadata.  The deadline is
    deliberately NOT part of the query: two clients asking the same
    question with different deadlines must still coalesce onto one
    computation and one cache entry."""

    query: Query
    deadline: Optional[float] = None     # absolute time.monotonic seconds


class DSEService:
    """The persistent query service (see module docstring).

    ``explorer``: a pre-built Explorer to serve; when ``None``, one is
    constructed from ``scenarios`` / ``networks`` (the Explorer defaults)
    on ``device`` (``cuda`` unless the caller names another; ignored when
    ``explorer`` is given — the service runs on the explorer's device).
    ``pool`` / ``seed`` / ``candidates``: the shared candidate pool —
    either an explicit ``(B, n_knobs)`` array or ``pool`` log-uniform
    samples (row 0 = θ = 1, so the reference machine is always ranked).
    ``max_batch`` / ``window_s``: the micro-batch window (at most
    ``max_batch`` queries per dispatch, closed ``window_s`` seconds after
    the first arrival).
    ``sharded`` / ``n_devices``: shard every dispatch's candidate axis
    across devices (bitwise-identical results, see
    ``PackedMatrix.evaluate``).
    ``chunk``: bound per-dispatch device batch rows (memory cap).
    ``surrogate`` / ``surrogate_max_err``: arm the staged oracle
    hierarchy — a trained :class:`repro_torch.surrogate.SurrogateBundle` (or
    ``True`` to train one here from the fixed default seed).  A fresh
    query is answered by the surrogate tier when EVERY resolved cell's
    calibrated confidence bound is at or under ``surrogate_max_err``,
    and falls back to the exact packed dispatch otherwise; per-tier
    answer counts, per-tier latency, and the fallback rate are reported
    by :meth:`stats`.
    ``retry`` / ``breaker``: the failure policy over the packed dispatch
    (:mod:`repro_torch.serve.policy`) — transient dispatch failures retry
    with jittered exponential backoff, and ``open_after`` consecutive
    exhausted dispatches open the circuit breaker; while it is open,
    queries with calibrated surrogate coverage (every resolved cell's
    bound at or under ``degraded_max_err``) are answered
    ``tier="surrogate-degraded"`` with a :data:`DEGRADED_WIDEN`-widened
    bound stamped on the answer, and the rest fail fast with
    :class:`~repro_torch.serve.errors.OracleUnavailable` instead of queuing
    behind a dead oracle.  Degraded and failed outcomes are never
    cached, so recovery restores exact ``tier="packed"`` answers.
    ``fault_plan``: a :class:`repro_torch.serve.faults.FaultPlan` (or spec
    string) injecting deterministic dispatch faults for tests/chaos runs;
    defaults to the ``SERVE_FAULT_PLAN`` environment variable.
    """

    def __init__(self, explorer: Optional[Explorer] = None, *,
                 scenarios=None, networks=False,
                 pool: int = 64, seed: int = 0,
                 candidates: Optional[np.ndarray] = None,
                 max_batch: int = 8, window_s: float = 0.002,
                 sharded: bool = False, n_devices: Optional[int] = None,
                 chunk: Optional[int] = None,
                 surrogate=None, surrogate_max_err: float = 0.02,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 fault_plan: Union[FaultPlan, str, None] = None,
                 degraded_max_err: float = float("inf"), device=None):
        if explorer is None:
            explorer = Explorer(scenarios=scenarios, networks=networks,
                                device=device)
        self.explorer = explorer
        self.space = explorer.space
        if candidates is None:
            candidates = random_candidates(self.space, pool, seed=seed)
        self.pool = np.asarray(candidates, np.float32)
        if self.pool.ndim != 2 or self.pool.shape[1] != self.space.n:
            raise ValueError(f"candidate pool must be (B, {self.space.n}), "
                             f"got {self.pool.shape}")
        self.sharded = bool(sharded)
        self.n_devices = n_devices
        self.chunk = chunk
        self.surrogate = self._check_surrogate(surrogate)
        self.surrogate_max_err = float(surrogate_max_err)
        self.degraded_max_err = float(degraded_max_err)
        self.retry = retry if retry is not None else RetryPolicy(seed=seed)
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        if fault_plan is None:
            fault_plan = os.environ.get(ENV_FAULT_PLAN) or None
        if isinstance(fault_plan, str):
            fault_plan = FaultPlan.parse(fault_plan)
        self.fault_plan = fault_plan
        self.faults = None if fault_plan is None else FaultInjector(fault_plan)
        self._lock = threading.Lock()
        self._cache: Dict[Tuple, Answer] = {}
        self.cache_stats = {"hits": 0, "misses": 0, "coalesced": 0}
        self._resolved: Dict[Tuple, Tuple[Tuple[str, ...], np.ndarray]] = {}
        self._sur_ok: Dict[Tuple, bool] = {}
        self.dispatched_candidates = 0
        self.tier_counts = {"surrogate": 0, "packed": 0,
                            "surrogate-degraded": 0, "failed": 0}
        self.tier_time_s = {"surrogate": 0.0, "packed": 0.0,
                            "surrogate-degraded": 0.0}
        self.timeouts = 0               # query() timeouts (leak-accounted)
        self.deadline_misses = 0        # submissions expired pre-evaluation
        self.retries = 0                # packed attempts beyond the first
        # every window that reached _dispatch (threaded OR replay), as
        # query keys; and the deduped keys each DEVICE dispatch evaluated
        self.window_log: List[List[Tuple]] = []
        self.evaluated_log: List[List[Tuple]] = []
        self.batcher = MicroBatcher(self._dispatch, max_batch=max_batch,
                                    window_s=window_s)

    def _check_surrogate(self, surrogate):
        """Resolve/validate the surrogate tier: ``True`` trains a bundle
        for this explorer from the fixed default seed; a provided bundle
        must have been trained on exactly this matrix and design space
        (cell-by-cell alignment — a mismatched bundle would silently
        predict the wrong cells)."""
        if surrogate is None:
            return None
        if surrogate is True:
            from ..surrogate import train_surrogate
            surrogate = train_surrogate(self.explorer)
        names = tuple(cs.name for cs in self.explorer.compiled)
        if tuple(surrogate.cell_names) != names:
            raise ValueError(
                f"surrogate bundle cells {surrogate.cell_names} do not "
                f"match the served matrix {names}")
        if tuple(surrogate.knob_names) != tuple(self.space.names):
            raise ValueError(
                f"surrogate bundle knobs {surrogate.knob_names} do not "
                f"match the design space {self.space.names}")
        return surrogate

    # -- client surface -----------------------------------------------------

    def submit(self, query: Optional[Query] = None,
               deadline_s: Optional[float] = None, **kwargs):
        """Enqueue one query into the current micro-batch window; returns
        a future resolving to its :class:`Answer`.  Accepts either a
        :class:`Query` or ``Query.make`` keyword arguments.  Resolution
        and override validation happen HERE, in the caller — a malformed
        query fails fast and can never poison its window's batchmates.

        ``deadline_s`` (relative seconds) propagates into the micro-batch
        window: the query's window closes no later than HALF its budget
        (closing at the deadline itself would leave the evaluation no
        time at all — shortening the window early only costs batching
        efficiency, never correctness), and a query still unanswered when
        its deadline passes fails with
        :class:`~repro_torch.serve.errors.DeadlineExceeded` instead of being
        evaluated for nobody."""
        q = self._canonical(query, kwargs)
        self._resolve(q)               # validates workload/arch subset
        self._override_columns(q)      # validates knob names + bounds
        now = time.monotonic()
        deadline = None if deadline_s is None else now + float(deadline_s)
        window_close = (None if deadline_s is None
                        else now + float(deadline_s) / 2.0)
        return self.batcher.submit(_Submission(q, deadline),
                                   deadline=window_close)

    def query(self, query: Optional[Query] = None, timeout: float = 120.0,
              deadline_s: Optional[float] = None, **kwargs) -> Answer:
        """Blocking ``submit``: one answer, through the shared window.

        A timeout no longer leaks the enqueued future: the future is
        cancelled (the batcher drops cancelled items before dispatch) or,
        when already past cancellation, its eventual outcome is consumed
        so nothing dangles — either way the ``timeouts`` counter in
        :meth:`stats` accounts for it, and the raised error is the
        structured :class:`~repro_torch.serve.errors.DeadlineExceeded` (a
        ``TimeoutError`` subclass, so existing callers keep working)."""
        if deadline_s is not None:
            timeout = min(timeout, float(deadline_s))
        fut = self.submit(query, deadline_s=deadline_s, **kwargs)
        try:
            return fut.result(timeout=timeout)
        except _FutureTimeout:
            with self._lock:
                self.timeouts += 1
            if not fut.cancel():
                # already running/done: consume the eventual outcome so
                # the dropped result is accounted, not silently leaked
                fut.add_done_callback(
                    lambda f: f.cancelled() or f.exception())
            raise DeadlineExceeded(
                f"no answer within {timeout:g}s", timeout_s=timeout) from None

    def query_many(self, queries: Sequence[Query],
                   return_exceptions: bool = False) -> List[Answer]:
        """Sequential replay oracle: the same queries through the same
        dispatch path, coalesced by the same FIFO plan the worker thread
        uses (``plan_batches``) but synchronously in the caller — the
        reference answers the concurrency/determinism tests compare the
        threaded path against.  With ``return_exceptions`` (the replay
        mode fault tests use), per-query structured errors come back in
        place of answers instead of raising on the first one."""
        subs = [_Submission(self._canonical(q, {})) for q in queries]
        out: List[Answer] = []
        for s, e in plan_batches(len(subs), self.batcher.max_batch):
            out.extend(self._dispatch(subs[s:e]))
        if not return_exceptions:
            for o in out:
                if isinstance(o, BaseException):
                    raise o
        return out

    def close(self) -> None:
        """Flush pending windows and stop the worker thread."""
        self.batcher.close()

    def __enter__(self) -> "DSEService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> Dict[str, object]:
        """Service counters: answer-cache hits/misses/coalesced, dispatch
        count and mean batch size, total device-evaluated candidates, the
        ranking objectives and per-cell energy baselines (pJ at θ = 1),
        the process-wide scenario-cache counters the answer cache
        mirrors, and the staged-oracle tier accounting — per-tier answer
        counts (``tiers``, cache hits included), per-tier cumulative and
        per-query latency (``tier_time_s`` / ``tier_us_per_query``), and
        the ``fallback_rate`` (fraction of fresh queries the surrogate
        tier had to hand to the exact packed dispatch; 1.0 when no
        surrogate is armed) — plus the failure-semantics counters: the
        circuit ``breaker`` snapshot, ``retries``, ``timeouts``,
        ``deadline_misses``, and the batcher's ``cancelled`` /
        ``worker_restarts``."""
        with self._lock:
            cs = dict(self.cache_stats)
            cand = self.dispatched_candidates
            windows = len(self.window_log)
            n_queries = sum(len(b) for b in self.window_log)
            device = len(self.evaluated_log)
            tiers = dict(self.tier_counts)
            tier_time = dict(self.tier_time_s)
            timeouts = self.timeouts
            deadline_misses = self.deadline_misses
            retries = self.retries
        fresh = tiers["surrogate"] + tiers["packed"]
        return {
            "cache": cs,
            "hit_ratio": (cs["hits"] + cs["coalesced"])
            / max(1, cs["hits"] + cs["coalesced"] + cs["misses"]),
            "windows": windows,
            "device_dispatches": device,
            "dispatched_queries": n_queries,
            "mean_batch": n_queries / max(1, windows),
            "dispatched_candidates": cand,
            "pool": int(self.pool.shape[0]),
            "cells": len(self.explorer.compiled),
            "objectives": ("latency", "energy", "cost"),
            "energy_baseline_pj": {
                cs.name: float(b) for cs, b in zip(
                    self.explorer.compiled, self.explorer.energy_baselines)},
            "sharded": self.sharded,
            "scenario_cache": scenario_cache_stats(),
            "surrogate_armed": self.surrogate is not None,
            "surrogate_max_err": self.surrogate_max_err,
            "tiers": {"cache": cs["hits"], **tiers},
            "tier_time_s": tier_time,
            "tier_us_per_query": {
                t: tier_time[t] / tiers[t] * 1e6 if tiers.get(t) else 0.0
                for t in tier_time},
            "fallback_rate": tiers["packed"] / fresh if fresh else 0.0,
            "breaker": self.breaker.snapshot(),
            "retries": retries,
            "timeouts": timeouts,
            "deadline_misses": deadline_misses,
            "cancelled": self.batcher.cancelled,
            "worker_restarts": self.batcher.worker_restarts,
            "fault_plan": (self.fault_plan.to_spec()
                           if self.fault_plan is not None else None),
        }

    # -- resolution ---------------------------------------------------------

    def _canonical(self, query: Optional[Query], kwargs) -> Query:
        if query is None:
            return Query.make(**kwargs)
        if kwargs:
            raise TypeError("pass a Query OR Query.make kwargs, not both")
        # re-canonicalize hand-built dataclasses (sorts archs/overrides)
        return Query.make(query.workload, query.archs, query.override_map,
                          query.top_k)

    def _resolve(self, q: Query) -> Tuple[Tuple[str, ...], np.ndarray]:
        """Query -> (cell names, matrix column indices), memoized."""
        key = (q.workload, q.archs)
        hit = self._resolved.get(key)
        if hit is None:
            idx = resolve_cells(self.explorer.compiled, workload=q.workload,
                                archs=q.archs)
            names = tuple(self.explorer.compiled[i].name for i in idx)
            hit = (names, np.asarray(idx, np.int64))
            self._resolved[key] = hit
        return hit

    def _override_columns(self, q: Query) -> List[Tuple[int, float]]:
        """Validated (knob column, pinned θ) pairs for a query."""
        cols = []
        for name, val in q.overrides:
            if name not in self.space.names:
                raise KeyError(f"unknown knob {name!r}; space has "
                               f"{self.space.names}")
            ki = self.space.names.index(name)
            knob = self.space.knobs[ki]
            if not (knob.lo <= val <= knob.hi):
                raise ValueError(f"override {name}={val} outside "
                                 f"[{knob.lo}, {knob.hi}]")
            cols.append((ki, float(val)))
        return cols

    def _candidates_for(self, q: Query) -> np.ndarray:
        """The query's effective candidate block: the shared pool with the
        overridden knob columns pinned (a pure function of the query, so
        identical queries always evaluate identical candidates)."""
        cand = self.pool.copy()
        for ki, val in self._override_columns(q):
            cand[:, ki] = val
        return cand

    # -- the coalesced dispatch --------------------------------------------

    def _dispatch(self, submissions: List) -> List:
        """One micro-batch window through the staged oracle hierarchy.

        Submissions already past their deadline fail immediately with
        :class:`DeadlineExceeded` (counted ``deadline_misses``) — they
        never reach an oracle.  Cache hits answer next; the remaining
        queries are deduped by key (same-window duplicates coalesce onto
        one computation), routed to the surrogate tier when eligible
        (:meth:`_surrogate_answers`), and the rest grouped by override
        signature (same overrides = same candidate block, evaluated
        once) into ONE stacked ``PackedMatrix`` dispatch (sharded over
        devices when configured) behind the retry policy and circuit
        breaker.  Per-candidate rows are independent, so stacking order
        cannot change any query's answer.  The returned list holds one
        outcome per submission — an :class:`Answer` or a structured
        error (the batcher fails exactly that item's future with it).
        """
        subs = [s if isinstance(s, _Submission) else _Submission(s)
                for s in submissions]
        now = time.monotonic()
        with self._lock:
            outcomes: List[Optional[object]] = [None] * len(subs)
            answers: Dict[Tuple, object] = {}
            fresh: Dict[Tuple, Query] = {}
            self.window_log.append([s.query.key for s in subs])
            for i, sub in enumerate(subs):
                q = sub.query
                if sub.deadline is not None and now > sub.deadline:
                    self.deadline_misses += 1
                    outcomes[i] = DeadlineExceeded(
                        f"query expired {now - sub.deadline:.3f}s before "
                        f"evaluation", workload=q.workload)
                elif q.key in answers or q.key in fresh:
                    self.cache_stats["coalesced"] += 1
                elif q.key in self._cache:
                    self.cache_stats["hits"] += 1
                    cached = self._cache[q.key]
                    answers[q.key] = Answer(cached.query, cached.cells,
                                            cached.designs,
                                            cached.best_arch, cached=True,
                                            tier=cached.tier,
                                            err_bound=cached.err_bound)
                else:
                    self.cache_stats["misses"] += 1
                    fresh[q.key] = q

        if fresh:
            # staged oracle hierarchy: queries whose every resolved cell
            # clears the surrogate's calibrated bound answer from the fast
            # tier; the rest fall back to the exact packed dispatch
            sur = {k: q for k, q in fresh.items()
                   if self._surrogate_answers(q)}
            packed = {k: q for k, q in fresh.items() if k not in sur}
            if sur:
                self._answer_surrogate(sur, answers)
            if packed:
                self._answer_packed(packed, answers)

        return [o if o is not None else answers[s.query.key]
                for o, s in zip(outcomes, subs)]

    def _surrogate_answers(self, q: Query) -> bool:
        """True when the armed surrogate's calibrated per-cell bounds
        clear ``surrogate_max_err`` for EVERY cell the query resolves to
        (memoized per resolved subset)."""
        if self.surrogate is None:
            return False
        key = (q.workload, q.archs)
        ok = self._sur_ok.get(key)
        if ok is None:
            _, cols = self._resolve(q)
            ok = bool(np.all(self.surrogate.err_bound[cols]
                             <= self.surrogate_max_err))
            self._sur_ok[key] = ok
        return ok

    def _answer_surrogate(self, group: Dict[Tuple, Query],
                          answers: Dict[Tuple, object],
                          degraded: bool = False) -> None:
        """Fast tier: each distinct override signature's candidate block
        goes through the bundle's host numpy predictor
        (``SurrogateBundle.predict_full``: no device dispatch, by the
        tier's design) once; the device-dispatch counters
        (``dispatched_candidates``,
        ``evaluated_log``) are deliberately NOT touched, they count exact
        packed work only.  In ``degraded`` mode (circuit breaker open)
        answers are stamped ``tier="surrogate-degraded"`` with the
        :data:`DEGRADED_WIDEN`-widened bound and are NOT cached — once
        the breaker closes, the same question gets an exact answer."""
        tier = "surrogate-degraded" if degraded else "surrogate"
        t0 = time.perf_counter()
        blocks: Dict[Tuple, np.ndarray] = {}
        preds: Dict[Tuple, Tuple[np.ndarray, np.ndarray]] = {}
        for q in group.values():
            if q.overrides not in blocks:
                blocks[q.overrides] = self._candidates_for(q)
                preds[q.overrides] = self.surrogate.predict_full(
                    blocks[q.overrides])
        with self._lock:
            for key, q in group.items():
                cycles, energy = preds[q.overrides]
                ans = self._rank(q, blocks[q.overrides], cycles, energy,
                                 tier=tier)
                answers[key] = ans
                if not degraded:
                    self._cache[key] = ans
            self.tier_counts[tier] += len(group)
            self.tier_time_s[tier] += time.perf_counter() - t0

    def _answer_packed(self, group: Dict[Tuple, Query],
                       answers: Dict[Tuple, object]) -> None:
        """Exact tier: one candidate block per distinct override
        signature, stacked along the candidate axis and evaluated in ONE
        ``PackedMatrix`` dispatch (sharded over devices when configured)
        behind the retry policy and circuit breaker.  Per-candidate rows
        are independent, so stacking order cannot change any query's
        answer.  When the breaker is open — or a dispatch exhausts its
        retry budget — the whole group degrades
        (:meth:`_answer_degraded`) instead of queuing behind the dead
        oracle."""
        t0 = time.perf_counter()
        if not self.breaker.allow():
            self._answer_degraded(group, answers, "circuit breaker open")
            return
        blocks: Dict[Tuple, np.ndarray] = {}
        for q in group.values():
            if q.overrides not in blocks:
                blocks[q.overrides] = self._candidates_for(q)
        sigs = list(blocks)
        stacked = np.concatenate([blocks[s] for s in sigs], axis=0)
        try:
            cycles, energy = self._packed_evaluate(stacked)
        except TransientDispatchError as e:
            self.breaker.record_failure()
            self._answer_degraded(group, answers,
                                  f"packed dispatch failed: {e}")
            return
        except BaseException:
            # a non-transient dispatch death (WorkerKill, SystemExit)
            # must still resolve the breaker's admitted attempt — a
            # half-open probe that died silently would otherwise leave
            # the breaker shedding forever; the exception itself keeps
            # propagating (the batcher fails the window's futures)
            self.breaker.record_failure()
            raise
        self.breaker.record_success()
        starts = dict(zip(sigs, np.cumsum(
            [0] + [blocks[s].shape[0] for s in sigs[:-1]])))
        with self._lock:
            self.dispatched_candidates += stacked.shape[0]
            self.evaluated_log.append(list(group))
            for key, q in group.items():
                s = int(starts[q.overrides])
                block = blocks[q.overrides]
                ans = self._rank(q, block,
                                 cycles[s: s + block.shape[0]],
                                 energy[s: s + block.shape[0]])
                answers[key] = ans
                self._cache[key] = ans
            self.tier_counts["packed"] += len(group)
            self.tier_time_s["packed"] += time.perf_counter() - t0

    def _packed_evaluate(self, stacked: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """One guarded oracle call: fault injection (when a plan is
        armed), output validation (a "successful" dispatch returning
        non-finite numbers is a :class:`PoisonedDispatch`, not an
        answer), and retry-with-backoff around both.  Raises the last
        :class:`TransientDispatchError` once the budget is spent."""
        def attempt() -> Tuple[np.ndarray, np.ndarray]:
            poisoned = False
            if self.faults is not None:
                n, act = self.faults.next("packed")
                if act.latency_s:
                    time.sleep(act.latency_s)
                if act.kind == "error":
                    raise TransientDispatchError(
                        f"injected dispatch fault at attempt {n}", attempt=n)
                if act.kind == "kill":
                    raise WorkerKill(f"injected worker kill at attempt {n}")
                poisoned = act.kind == "poison"
            if poisoned:
                # the oracle "returns", but its payload is garbage
                shape = (stacked.shape[0], len(self.explorer.compiled))
                cycles = np.full(shape, np.nan, np.float32)
                energy = np.full(shape, np.nan, np.float32)
            else:
                cycles, energy = self.explorer.evaluate_full(
                    stacked, chunk=self.chunk, sharded=self.sharded,
                    n_devices=self.n_devices)
            if not (np.isfinite(cycles).all() and np.isfinite(energy).all()):
                raise PoisonedDispatch(
                    "packed dispatch returned non-finite cycles/energy")
            return cycles, energy

        def on_retry(_e: BaseException) -> None:
            with self._lock:
                self.retries += 1

        return self.retry.call(attempt, retry_on=(TransientDispatchError,),
                               on_retry=on_retry)

    def _answer_degraded(self, group: Dict[Tuple, Query],
                         answers: Dict[Tuple, object], reason: str) -> None:
        """Graceful degradation down the oracle hierarchy: with the
        packed oracle unreachable, queries whose every resolved cell has
        a calibrated surrogate bound at or under ``degraded_max_err``
        are still answered — ``tier="surrogate-degraded"``, widened
        bound stamped — and the rest fail fast with a structured
        :class:`OracleUnavailable` instead of queuing behind a dead
        dispatch.  Neither outcome is cached."""
        cover: Dict[Tuple, Query] = {}
        for key, q in group.items():
            _, cols = self._resolve(q)
            covered = (self.surrogate is not None and bool(
                np.all(np.isfinite(self.surrogate.err_bound[cols])
                       & (self.surrogate.err_bound[cols]
                          <= self.degraded_max_err))))
            if covered:
                cover[key] = q
            else:
                with self._lock:
                    self.tier_counts["failed"] += 1
                answers[key] = OracleUnavailable(
                    f"packed oracle unavailable ({reason}) and query has "
                    f"no calibrated surrogate coverage",
                    breaker=self.breaker.state, workload=q.workload)
        if cover:
            self._answer_surrogate(cover, answers, degraded=True)

    def _rank(self, q: Query, cand: np.ndarray, cycles: np.ndarray,
              energy_pj: np.ndarray, tier: str = "packed") -> Answer:
        """Score one query's candidate block over its resolved cell subset
        and extract the Pareto-ranked top-k designs — the same latency /
        energy / cost / ``pareto_front`` pipeline as ``Explorer.explore``,
        with latency and energy averaged over the queried cells only."""
        names, cols = self._resolve(q)
        rel = cycles[:, cols] / self.explorer.baselines[None, cols]
        latency = rel.mean(axis=1)
        energy = (energy_pj[:, cols]
                  / self.explorer.energy_baselines[None, cols]).mean(axis=1)
        cost = self.explorer.cost_proxy(cand)
        front = pareto_front(np.stack([latency, energy, cost], axis=1))
        top = front[: q.top_k]
        designs = tuple(
            Design(theta=tuple(float(v) for v in cand[i]),
                   latency=float(latency[i]), energy=float(energy[i]),
                   cost=float(cost[i]),
                   cycles=tuple(float(c) for c in cycles[i, cols]))
            for i in top)
        # "which accelerator": the arch whose cell runs the top design at
        # the lowest baseline-relative latency
        lead = int(top[0]) if len(top) else int(np.argmin(latency))
        best_cell = int(np.argmin(rel[lead]))
        best_arch = self.explorer.compiled[int(cols[best_cell])].arch
        if tier == "surrogate":
            err = float(self.surrogate.err_bound[cols].max())
        elif tier == "surrogate-degraded":
            err = DEGRADED_WIDEN * float(self.surrogate.err_bound[cols].max())
        else:
            err = 0.0
        return Answer(query=q, cells=names, designs=designs,
                      best_arch=best_arch, tier=tier, err_bound=err)
