"""Failure policy for the packed-oracle dispatch: retry with jittered
exponential backoff, and a circuit breaker with graceful degradation
hooks.

Both pieces are deliberately deterministic so the serving determinism
contract (threaded == sequential replay, asserted under injected faults
in ``tests/test_serve_faults.py``) survives them:

* :class:`RetryPolicy` draws its jitter from a seeded RNG, so the delay
  SEQUENCE is a pure function of (seed, call order) — and delays only
  affect wall time, never which answer a query gets;
* :class:`CircuitBreaker` measures its open→half-open cooldown in
  *rejected dispatch opportunities* (``probe_after``), not wall-clock
  seconds, so a replay of the same dispatch sequence walks the same
  closed → open → half-open → closed path bit-identically.  An optional
  ``cooldown_s`` adds a wall-clock minimum on top for real deployments.

The state machine (see ``docs/serving.md`` for the diagram):

* **closed** — dispatches flow; ``open_after`` CONSECUTIVE failures trip
  the breaker (any success resets the streak);
* **open** — every dispatch is rejected without touching the oracle
  (callers degrade to the surrogate tier or fail fast); after
  ``probe_after`` rejections (and ``cooldown_s``, if set) the next
  ``allow()`` admits exactly one half-open probe;
* **half-open** — one probe in flight: success closes the breaker,
  failure re-opens it and the cooldown starts over.
"""

from __future__ import annotations

import threading
import time
from random import Random
from typing import Callable, Iterator, List, Optional, Tuple

__all__ = ["RetryPolicy", "CircuitBreaker"]


class RetryPolicy:
    """Jittered-exponential-backoff schedule for transient dispatch
    failures: attempt ``i`` (0-based) sleeps ``base_s * factor**(i-1) *
    (1 + jitter * u)`` first, with ``u ~ U[0, 1)`` from a seeded RNG and
    no sleep before the first attempt.  ``max_attempts`` bounds the total
    tries (1 = no retries)."""

    def __init__(self, max_attempts: int = 3, base_s: float = 0.005,
                 factor: float = 2.0, jitter: float = 0.5, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if base_s < 0 or factor < 1.0 or jitter < 0:
            raise ValueError("need base_s >= 0, factor >= 1, jitter >= 0")
        self.max_attempts = int(max_attempts)
        self.base_s = float(base_s)
        self.factor = float(factor)
        self.jitter = float(jitter)
        self._rng = Random(seed)
        self._sleep = sleep
        self._lock = threading.Lock()

    def delays(self) -> Iterator[float]:
        """One backoff schedule: yields ``max_attempts`` delays (the
        first is always 0.0); the caller sleeps each delay before the
        corresponding attempt."""
        for i in range(self.max_attempts):
            if i == 0:
                yield 0.0
                continue
            with self._lock:
                u = self._rng.random()
            yield self.base_s * self.factor ** (i - 1) * (1 + self.jitter * u)

    def call(self, fn: Callable[[], object],
             retry_on: Tuple[type, ...],
             on_retry: Optional[Callable[[BaseException], None]] = None):
        """Run ``fn`` under the schedule: exceptions in ``retry_on`` are
        retried (``on_retry`` observes each one) until the budget is
        spent, then the last one propagates; anything else propagates
        immediately."""
        last: Optional[BaseException] = None
        for i, delay in enumerate(self.delays()):
            if delay:
                self._sleep(delay)
            try:
                return fn()
            except retry_on as e:          # noqa: PERF203 — retry loop
                last = e
                if on_retry is not None and i + 1 < self.max_attempts:
                    on_retry(e)
        assert last is not None
        raise last


class CircuitBreaker:
    """Consecutive-failure circuit breaker over the packed dispatch (see
    the module docstring for the state machine).  Thread-safe; every
    transition is recorded in :attr:`transitions` as ``(from, to)`` pairs
    so tests can assert the exact path taken."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, open_after: int = 3, probe_after: int = 2,
                 cooldown_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        if open_after < 1:
            raise ValueError(f"open_after must be >= 1, got {open_after}")
        if probe_after < 0:
            raise ValueError(f"probe_after must be >= 0, got {probe_after}")
        self.open_after = int(open_after)
        self.probe_after = int(probe_after)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._rejected_since_open = 0
        self._opened_at = 0.0
        self.opens = 0                      # total closed/half-open -> open
        self.shed = 0                       # dispatches rejected while open
        self.transitions: List[Tuple[str, str]] = []

    @property
    def state(self) -> str:
        """Current state: ``"closed"``, ``"open"``, or ``"half-open"``."""
        with self._lock:
            return self._state

    def _move(self, to: str) -> None:
        self.transitions.append((self._state, to))
        self._state = to

    def allow(self) -> bool:
        """May the next dispatch touch the oracle?  While open, each call
        is one rejected opportunity; after ``probe_after`` of them (and
        the wall cooldown, if any) the breaker goes half-open and THIS
        call is admitted as the probe."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN:
                # one probe at a time: concurrent dispatches keep shedding
                # until the in-flight probe reports back
                self.shed += 1
                return False
            ready = self._rejected_since_open >= self.probe_after and \
                (self._clock() - self._opened_at) >= self.cooldown_s
            if ready:
                self._move(self.HALF_OPEN)
                return True
            self._rejected_since_open += 1
            self.shed += 1
            return False

    def record_success(self) -> None:
        """A dispatch completed: resets the failure streak; a successful
        half-open probe closes the breaker."""
        with self._lock:
            self._consecutive_failures = 0
            if self._state == self.HALF_OPEN:
                self._move(self.CLOSED)

    def record_failure(self) -> None:
        """A dispatch failed (retries exhausted): a failed probe
        re-opens; in closed state, ``open_after`` consecutive failures
        trip the breaker."""
        with self._lock:
            self._consecutive_failures += 1
            if self._state == self.HALF_OPEN or (
                    self._state == self.CLOSED
                    and self._consecutive_failures >= self.open_after):
                self._move(self.OPEN)
                self.opens += 1
                self._rejected_since_open = 0
                self._opened_at = self._clock()

    def snapshot(self) -> dict:
        """Counters for ``DSEService.stats()`` / the health probe."""
        with self._lock:
            return {"state": self._state, "opens": self.opens,
                    "shed": self.shed,
                    "consecutive_failures": self._consecutive_failures,
                    "transitions": list(self.transitions)}
