"""Query/answer surface of the DSE service.

A :class:`Query` is one client's "which accelerator + config for my
model?" question: a workload (an operator kind such as ``"gemm"`` or a
network name such as ``"whisper_small"``), an optional architecture
subset, optional knob overrides that pin design-space axes the client has
already committed to, and the number of ranked designs wanted back.

Queries are *canonical* — construction normalizes the archs/overrides
containers into sorted tuples — so a query's identity (:attr:`Query.key`)
is a pure function of what is being asked, never of how the dataclass was
spelled.  The service's answer cache, its dispatch dedup, and the
determinism guarantee ("same answer regardless of arrival order or
batching") all hang off that property.

An :class:`Answer` carries the Pareto-ranked :class:`Design` rows.  Both
are plain frozen dataclasses comparing by value, so tests can assert a
served answer ``==`` the answer recomputed from a direct Explorer sweep;
the bookkeeping :attr:`Answer.cached` flag is excluded from comparison
(a cache hit MUST equal the recomputed answer).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Dict, Iterable, Mapping, Optional, Sequence, Tuple,
                    Union)

__all__ = ["Query", "Design", "Answer"]


@dataclass(frozen=True)
class Query:
    """One client question over the served design space.

    ``workload``: operator kind (``"gemm"``) or network name
    (``"whisper_small"``); ``None`` asks over the whole served matrix.
    ``archs``: restrict to these architectures (``None`` = all).
    ``overrides``: sorted ``(knob name, θ)`` pairs pinning axes the client
    has fixed (their columns are overwritten in every candidate).
    ``top_k``: maximum number of ranked designs in the answer.

    Build via :meth:`make` (it normalizes dict/list arguments); the frozen
    tuple fields make the query hashable — :attr:`key` is the answer-cache
    and dedup identity.
    """

    workload: Optional[str] = None
    archs: Optional[Tuple[str, ...]] = None
    overrides: Tuple[Tuple[str, float], ...] = ()
    top_k: int = 5

    @staticmethod
    def make(workload: Optional[str] = None,
             archs: Optional[Sequence[str]] = None,
             overrides: Union[Mapping[str, float],
                              Iterable[Tuple[str, float]], None] = None,
             top_k: int = 5) -> "Query":
        """Canonicalizing constructor: ``archs`` (any iterable, or a bare
        string) and ``overrides`` (a mapping or ``(name, θ)`` pairs)
        become sorted tuples, so two queries asking the same thing are
        equal and cache-alias."""
        if isinstance(archs, str):
            archs = (archs,)
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if hasattr(overrides, "items"):
            overrides = overrides.items()
        return Query(
            workload=workload,
            archs=None if archs is None else tuple(sorted(set(archs))),
            overrides=() if not overrides else tuple(
                sorted((str(k), float(v)) for k, v in overrides)),
            top_k=int(top_k))

    @property
    def key(self) -> Tuple:
        """Hashable canonical identity (the answer-cache/dedup key)."""
        return (self.workload, self.archs, self.overrides, self.top_k)

    @property
    def override_map(self) -> Dict[str, float]:
        """The overrides as a plain dict (knob name -> pinned θ)."""
        return dict(self.overrides)

    def to_payload(self) -> Dict[str, object]:
        """JSON-safe wire form (the RPC front-end's request body)."""
        return {"workload": self.workload,
                "archs": None if self.archs is None else list(self.archs),
                "overrides": {k: v for k, v in self.overrides},
                "top_k": self.top_k}

    @staticmethod
    def from_payload(payload: Mapping) -> "Query":
        """Rebuild (and re-canonicalize) a query from its wire form."""
        return Query.make(workload=payload.get("workload"),
                          archs=payload.get("archs"),
                          overrides=payload.get("overrides"),
                          top_k=payload.get("top_k", 5))


@dataclass(frozen=True)
class Design:
    """One ranked design point in an answer: the shared knob vector θ plus
    its objectives over the query's cell subset.

    ``latency`` is the mean baseline-relative cycle count across the
    queried cells (1.0 = the reference machine); ``energy`` is the mean
    baseline-relative energy over the same cells (dynamic switching +
    static leakage, 1.0 = the reference machine); ``cost`` is the area
    proxy; ``cycles`` are the raw per-cell estimates, aligned with the
    answer's ``cells`` tuple."""

    theta: Tuple[float, ...]         # shared knob values, space order
    latency: float                   # mean baseline-relative cycles
    energy: float                    # mean baseline-relative energy
    cost: float                      # area proxy
    cycles: Tuple[float, ...]        # per queried cell, Answer.cells order

    def knobs(self, names: Sequence[str]) -> Dict[str, float]:
        """θ as a name -> value dict (``names`` from the design space)."""
        return dict(zip(names, self.theta))

    def to_payload(self) -> Dict[str, object]:
        """JSON-safe wire form."""
        return {"theta": list(self.theta), "latency": self.latency,
                "energy": self.energy, "cost": self.cost,
                "cycles": list(self.cycles)}

    @staticmethod
    def from_payload(payload: Mapping) -> "Design":
        """Rebuild a design from its wire form."""
        return Design(theta=tuple(float(v) for v in payload["theta"]),
                      latency=float(payload["latency"]),
                      energy=float(payload["energy"]),
                      cost=float(payload["cost"]),
                      cycles=tuple(float(c) for c in payload["cycles"]))


@dataclass(frozen=True)
class Answer:
    """The service's reply: the resolved cell subset and the Pareto-ranked
    designs (sorted by latency, at most ``query.top_k`` rows).

    ``best_arch`` names the architecture whose cell runs the top design at
    the lowest baseline-relative latency — the "which accelerator" half of
    the question; ``designs[0]`` is the "which config" half.  ``cached``
    records whether this reply came from the answer cache; ``tier`` names
    the oracle tier that computed it (``"packed"``, or ``"surrogate"``
    when the staged hierarchy answered from the fast tier) and
    ``err_bound`` is that tier's stated relative-error bound (0.0 for the
    exact packed tier).  The bookkeeping fields are excluded from
    equality because a cache hit must compare equal to the same answer
    recomputed from scratch."""

    query: Query
    cells: Tuple[str, ...]           # resolved cell names, matrix order
    designs: Tuple[Design, ...]      # Pareto-ranked, latency-ascending
    best_arch: str
    cached: bool = field(default=False, compare=False)
    tier: str = field(default="packed", compare=False)
    err_bound: float = field(default=0.0, compare=False)

    @property
    def best(self) -> Design:
        """The lowest-latency Pareto design (rank 0)."""
        return self.designs[0]

    def to_payload(self) -> Dict[str, object]:
        """JSON-safe wire form — the RPC front-end's answer body; the
        round trip (``from_payload(to_payload(a)) == a``) preserves value
        equality AND the bookkeeping tier/bound fields."""
        return {"query": self.query.to_payload(),
                "cells": list(self.cells),
                "designs": [d.to_payload() for d in self.designs],
                "best_arch": self.best_arch, "cached": self.cached,
                "tier": self.tier, "err_bound": self.err_bound}

    @staticmethod
    def from_payload(payload: Mapping) -> "Answer":
        """Rebuild an answer from its wire form (the client half)."""
        return Answer(query=Query.from_payload(payload["query"]),
                      cells=tuple(payload["cells"]),
                      designs=tuple(Design.from_payload(d)
                                    for d in payload["designs"]),
                      best_arch=str(payload["best_arch"]),
                      cached=bool(payload.get("cached", False)),
                      tier=str(payload.get("tier", "packed")),
                      err_bound=float(payload.get("err_bound", 0.0)))
