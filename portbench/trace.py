"""The traced span: ``torch.profiler`` over the host's operators and the
device's activity, reduced to the device's busy time (the union of its
intervals), time by device operation, and the idle gaps by what the host
was doing.

Events are read from the profiler's raw results, without building its
operator tree, so that a span of some 10⁵ events reduces in seconds.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

TOP = 10
NAME_CHARS = 160
ANNOTATIONS = ("portbench.", "ProfilerStep")   # the benchmark's own ranges


@dataclass
class TraceSummary:
    window_s: float                       # host seconds of the traced span
    busy_s: float                         # union of device intervals
    ops: Dict[str, Tuple[float, int]]     # device op -> (seconds, count)
    idle_by_host: Dict[str, float]        # host op -> idle device seconds
    items: int = 0                        # requests or steps traced

    def op_seconds(self, pred) -> Tuple[float, int]:
        s = n = 0
        for name, (sec, cnt) in self.ops.items():
            if pred(name):
                s += sec
                n += cnt
        return s, n

    def breakdown(self) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:TOP]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, (s, _) in ops],
                "idle_gaps": [[n[:NAME_CHARS], s] for n, s in gaps]}


@dataclass
class Tracer:
    """Start and stop around the window's first ``limit`` items."""
    device: object
    limit: Optional[int] = None
    running: bool = False
    _prof: object = None
    _t0: int = 0
    _t1: int = 0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.time_ns()
        self.running = True

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize(self.device)
        self._t1 = time.time_ns()
        self._prof.stop()
        self.running = False

    def summary(self, items: int) -> TraceSummary:
        return reduce(self._prof.profiler.kineto_results.events(),
                      self._t0, self._t1, items)


def _is_device(e) -> bool:
    """A device activity (kernel, memcpy, memset), not a range projected
    onto the device's timeline from a host annotation."""
    if not str(e.device_type()).endswith("CUDA"):
        return False
    kind = getattr(e, "activity_type", None)
    if kind is not None and "user_annotation" in str(kind()).lower():
        return False
    return not e.name().startswith(ANNOTATIONS)


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge (start, end) intervals into disjoint ones, in order."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(events, t0: int, t1: int, items: int) -> TraceSummary:
    """Busy time, op times and idle gaps of the span [t0, t1] (Unix ns)."""
    ops: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    dev: List[Tuple[int, int]] = []
    host: List[Tuple[int, int, str]] = []
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if _is_device(e):
            if dur <= 0:
                continue
            dev.append((start, start + dur))
            rec = ops[e.name()]
            rec[0] += dur * 1e-9
            rec[1] += 1
        elif dur > 0:
            host.append((start, start + dur, e.name()))
    merged = union(dev)
    busy = sum(e - s for s, e in merged)
    gaps = [(merged[k + 1][0] - merged[k][1], merged[k][1],
             merged[k + 1][0]) for k in range(len(merged) - 1)]
    if merged:
        gaps.append((merged[0][0] - t0, t0, merged[0][0]))
        gaps.append((t1 - merged[-1][1], merged[-1][1], t1))
    idle = _by_host([g for g in gaps if g[0] > 0], host)
    return TraceSummary(window_s=(t1 - t0) * 1e-9, busy_s=busy * 1e-9,
                        ops={k: (v[0], v[1]) for k, v in ops.items()},
                        idle_by_host=idle, items=items)


def _by_host(gaps, host, longest: int = 2000, look_back: int = 4000
             ) -> Dict[str, float]:
    """Seconds of the ``longest`` idle gaps, each named by the innermost
    host operator running at its midpoint ("host idle" where none is); the
    rest of the gaps summed under "shorter gaps"."""
    host.sort()
    starts = [h[0] for h in host]
    out: Dict[str, float] = defaultdict(float)
    gaps = sorted(gaps, reverse=True)
    for dur, s, e in gaps[:longest]:
        mid = (s + e) // 2
        k = bisect.bisect_right(starts, mid)
        best = None
        for j in range(k - 1, max(-1, k - 1 - look_back), -1):
            hs, he, name = host[j]
            if he >= mid and (best is None or he - hs < best[0]):
                best = (he - hs, name)
        out[best[1] if best else "host idle"] += dur * 1e-9
    rest = sum(g[0] for g in gaps[longest:])
    if rest:
        out["shorter gaps"] += rest * 1e-9
    return dict(out)


def idle_pct(run) -> Optional[float]:
    """The device's idle share of the traced span: 1 − the union of its
    activity intervals ÷ the span, in %."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def peak_share(run) -> Optional[float]:
    """The work of the traced items (``run.flops_per_item`` each, counted
    from the cell's shapes by ``counts``) over the traced span, as a share
    of the card's bf16 peak, in %."""
    from . import counts
    if run.trace is None or not run.trace.items:
        return None
    flops = run.flops_per_item * run.trace.items
    return 100.0 * flops / run.trace.window_s / counts.BF16_FLOP_PER_S
