"""Straggler detection, failure injection and step metrics.

``StragglerMonitor`` flags steps whose wall time deviates from the running
median by more than ``k`` median-absolute-deviations — at fleet scale this
is the first signal of a failing host/NIC before the job hard-fails; the
driver reacts by logging + (optionally) checkpointing early.

``FailureInjector`` deterministically raises at a chosen step — used by the
fault-tolerance tests to prove the checkpoint/restore path end-to-end.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np

__all__ = ["StragglerMonitor", "FailureInjector", "Metrics"]


class StragglerMonitor:
    def __init__(self, window: int = 50, k: float = 5.0, warmup: int = 5):
        self.window = window
        self.k = k
        self.warmup = warmup
        self.times: Deque[float] = deque(maxlen=window)
        self.flagged: List[int] = []
        self._t0: Optional[float] = None
        self._step = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        """Record the step; True if it is a straggler."""
        assert self._t0 is not None, "stop() without start()"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._step += 1
        is_straggler = False
        if len(self.times) >= self.warmup:
            med = float(np.median(self.times))
            mad = float(np.median(np.abs(np.asarray(self.times) - med)))
            if dt > med + self.k * max(mad, 1e-9):
                is_straggler = True
                self.flagged.append(self._step)
        self.times.append(dt)
        return is_straggler

    def observe(self, dt: float) -> bool:
        """Direct-observation variant (tests feed synthetic timings)."""
        self._t0 = time.perf_counter() - dt
        return self.stop()


class FailureInjector:
    """Raises RuntimeError at ``fail_at_step`` exactly once (test hook)."""

    def __init__(self, fail_at_step: int = -1):
        self.fail_at_step = fail_at_step
        self.fired = False

    def check(self, step: int) -> None:
        if step == self.fail_at_step and not self.fired:
            self.fired = True
            raise RuntimeError(f"injected failure at step {step}")


@dataclass
class Metrics:
    """Tiny append-only metrics log (CSV-serializable)."""

    rows: List[Dict[str, float]] = field(default_factory=list)

    def log(self, step: int, **kv: float) -> None:
        self.rows.append({"step": step, **{k: float(v) for k, v in kv.items()}})

    def to_csv(self) -> str:
        if not self.rows:
            return ""
        keys = list(self.rows[0].keys())
        lines = [",".join(keys)]
        for r in self.rows:
            lines.append(",".join(str(r.get(k, "")) for k in keys))
        return "\n".join(lines)
