"""Deterministic, replayable fault injection for the serving stack.

A :class:`FaultPlan` is a schedule of failures keyed by **packed-dispatch
attempt index** — not wall-clock time — so the same chaos schedule
replays bit-identically in unit tests, the load harness
(``examples/serve_dse.py --faults``), and the CI ``chaos-smoke`` job.
Attempt ``n`` is the n-th time the service tries the packed oracle
(retries count: a dispatch retried twice consumes three attempt
indices), which makes a plan meaningful independent of how queries
happen to coalesce into windows.

Plans are written in a compact spec string::

    packed[2:5]=error; packed[6]=latency:0.05; packed[8]=poison; packed[9]=kill

``site[selector]=action`` clauses, ``;``-separated.  Selectors are
half-open attempt ranges (``N``, ``A:B``, ``A:`` = from A on, ``:B``);
later clauses override earlier ones.  Actions:

* ``error`` — the attempt raises
  :class:`~repro.serve.errors.TransientDispatchError` (a transient
  dispatch failure: the retry policy and circuit breaker see it);
* ``latency:S`` — the attempt succeeds but only after an injected
  ``S``-second spike (exercises deadlines and slow-oracle behaviour);
* ``poison`` — the attempt "succeeds" but returns an all-NaN payload;
  the service's output validation converts it into
  :class:`~repro.serve.errors.PoisonedDispatch`;
* ``kill`` — the attempt raises :class:`WorkerKill`, a ``BaseException``
  that tears down the batcher worker thread mid-flight (the batch's
  futures still fail cleanly, and the next submission respawns the
  worker — the "a worker dies" scenario).

Activate a plan via ``DSEService(fault_plan=...)`` (a plan, a spec
string, or ``None``) or the ``SERVE_FAULT_PLAN`` environment variable
(read when ``fault_plan`` is not given — the CI hook).
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["FaultAction", "FaultPlan", "FaultInjector", "WorkerKill",
           "ENV_FAULT_PLAN"]

ENV_FAULT_PLAN = "SERVE_FAULT_PLAN"

_KINDS = ("error", "latency", "poison", "kill")


class WorkerKill(BaseException):
    """Injected worker-thread death.  Deliberately NOT an ``Exception``:
    it exercises the batcher's ``BaseException`` path — fail the batch's
    futures, then re-raise so the worker actually dies (like a real
    ``SystemExit``/``KeyboardInterrupt`` would) instead of being silently
    routed into futures."""


@dataclass(frozen=True)
class FaultAction:
    """What one attempt does: ``kind`` in ``{"ok", "error", "poison",
    "kill"}`` plus an optional injected ``latency_s`` sleep (a bare
    ``latency:S`` clause is ``kind="ok"`` with a spike)."""

    kind: str = "ok"
    latency_s: float = 0.0

    def __post_init__(self):
        if self.kind not in ("ok", "error", "poison", "kill"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.latency_s < 0:
            raise ValueError(f"latency_s must be >= 0, got {self.latency_s}")


_CLAUSE = re.compile(
    r"^(?P<site>[a-z_]+)\s*\[\s*(?P<lo>\d*)\s*(?P<colon>:?)\s*(?P<hi>\d*)\s*\]"
    r"\s*=\s*(?P<action>[a-z]+)(?::(?P<param>[0-9.eE+-]+))?$")


@dataclass(frozen=True)
class FaultPlan:
    """An ordered set of ``(site, [lo, hi), action)`` rules; the LAST
    matching rule wins so later clauses refine earlier ranges.  ``hi``
    ``None`` means unbounded (``A:``)."""

    rules: Tuple[Tuple[str, int, Optional[int], FaultAction], ...] = ()
    spec: str = field(default="", compare=False)

    SITES = ("packed",)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse the spec grammar in the module docstring; raises
        ``ValueError`` with the offending clause on malformed input."""
        rules: List[Tuple[str, int, Optional[int], FaultAction]] = []
        for raw in spec.split(";"):
            clause = raw.strip()
            if not clause:
                continue
            m = _CLAUSE.match(clause)
            if m is None:
                raise ValueError(f"malformed fault clause {clause!r} "
                                 f"(grammar: site[lo:hi]=action[:param])")
            site = m.group("site")
            if site not in cls.SITES:
                raise ValueError(f"unknown fault site {site!r} in "
                                 f"{clause!r}; known sites: {cls.SITES}")
            lo = int(m.group("lo") or 0)
            if m.group("colon"):
                hi = int(m.group("hi")) if m.group("hi") else None
            else:
                hi = lo + 1
            if hi is not None and hi <= lo:
                raise ValueError(f"empty attempt range in {clause!r}")
            kind, param = m.group("action"), m.group("param")
            if kind == "latency":
                action = FaultAction("ok", float(param if param is not None
                                                 else 0.01))
            elif kind in ("error", "poison", "kill"):
                if param is not None:
                    raise ValueError(f"{kind} takes no parameter "
                                     f"({clause!r})")
                action = FaultAction(kind)
            else:
                raise ValueError(f"unknown fault action {kind!r} in "
                                 f"{clause!r}; known: {_KINDS}")
            rules.append((site, lo, hi, action))
        return cls(rules=tuple(rules), spec=spec)

    def to_spec(self) -> str:
        """Canonical spec string (parses back to an equal plan)."""
        out = []
        for site, lo, hi, act in self.rules:
            sel = f"{lo}" if hi == lo + 1 else f"{lo}:{hi if hi else ''}"
            if act.kind == "ok":
                out.append(f"{site}[{sel}]=latency:{act.latency_s:g}")
            else:
                out.append(f"{site}[{sel}]={act.kind}")
        return ";".join(out)

    def action(self, site: str, n: int) -> FaultAction:
        """The action for attempt ``n`` at ``site`` (last match wins;
        default: a clean ``ok``)."""
        hit = FaultAction()
        for s, lo, hi, act in self.rules:
            if s == site and lo <= n and (hi is None or n < hi):
                hit = act
        return hit

    def max_faulty_attempt(self, site: str = "packed") -> int:
        """One past the last attempt index any non-ok rule can touch
        (``-1`` when a rule is unbounded) — lets harnesses check a plan's
        fault window actually ends so recovery is reachable."""
        worst = 0
        for s, lo, hi, act in self.rules:
            if s != site or act == FaultAction():
                continue
            if hi is None:
                return -1
            worst = max(worst, hi)
        return worst


class FaultInjector:
    """The runtime half: owns the per-site attempt counters (thread-safe)
    and hands each dispatch attempt its scheduled :class:`FaultAction`.
    One injector per service instance, so a fresh replay service walks
    the identical schedule from attempt 0."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def next(self, site: str = "packed") -> Tuple[int, FaultAction]:
        """Claim the next attempt index at ``site`` and return it with
        its scheduled action."""
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
        return n, self.plan.action(site, n)

    def attempts(self, site: str = "packed") -> int:
        """Attempt indices consumed so far at ``site``."""
        with self._lock:
            return self._counts.get(site, 0)
