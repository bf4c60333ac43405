#!/usr/bin/env python3
"""The port's spans in one traced run of a cell: the device time, launches,
copies and idle gaps that each ``repro_torch.*`` span (the port's
``runtime/spans.py``) launched or held, per traced item.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

Sets the cell up as ``run.py`` does and traces the window's first
``trace_items`` items as ``--trace 1`` does, then prints the traced span's
device time and one JSON object of the port's spans, keyed ``outer/name``:
the outermost port span open at the span's start, then the span (``name``
alone where it is its own outermost); the row ``unattributed`` holds the
activities launched in no port span.  No check against the reference and
no result line: the benchmark's metrics are ``run.py``'s.

Each device activity is tied to its launch, the runtime call (``cu*``)
with the same correlation id, and its duration and count are credited to
every port span open at that instant, matched by time and not by thread:
the recompute's spans, opened on autograd's device thread, lie inside
``backward``, opened on the caller's.  Memcpy activity and kernels whose
name holds "copy" count as copies too (``metrics/copy_ms.train.py``'s
rule).  Each idle gap of the device goes to the innermost port span open
at its middle.  One sweep in time order: some 10⁵ events take seconds.
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Tuple

ROOT = Path(__file__).resolve().parents[1]
PORT = "repro_torch."
UNATTRIBUTED = ("", "unattributed")
# (outermost port span open at the span's start, the span), both without
# the prefix; a span that no other encloses is its own outermost
SpanKey = Tuple[str, str]


@dataclass
class SpanTotals:
    count: int = 0
    host_s: float = 0.0          # the spans' own host durations
    device_s: float = 0.0        # activities launched inside them
    launches: int = 0
    copy_s: float = 0.0          # of device_s, memcpy and "copy" kernels
    idle_s: float = 0.0          # idle gaps whose middle they hold


def by_span(events, t0: int, t1: int) -> Dict[SpanKey, SpanTotals]:
    """The port's spans among the profiler's raw ``events`` of the span
    [t0, t1] (Unix ns), each key with its totals."""
    from . import manifest, trace
    is_copy = manifest.load_module("metrics", "copy_ms.train")._is_copy
    dev, acts, port, runtime = [], [], [], {}
    for e in events:
        start, dur, name = e.start_ns(), e.duration_ns(), e.name()
        if dur <= 0:
            continue
        if name.startswith(PORT):
            if not str(e.device_type()).endswith("CUDA"):
                port.append((start, start + dur, name[len(PORT):]))
        elif trace._is_device(e):
            dev.append((start, start + dur))
            acts.append((e.correlation_id(), dur, is_copy(name)))
        elif name.startswith("cu"):             # cudaLaunchKernel, ...
            runtime[e.correlation_id()] = start
    merged = trace.union(dev)
    gaps = [(merged[k + 1][0] - merged[k][1], merged[k][1],
             merged[k + 1][0]) for k in range(len(merged) - 1)]
    if merged:
        gaps += [(merged[0][0] - t0, t0, merged[0][0]),
                 (t1 - merged[-1][1], merged[-1][1], t1)]
    gaps = [g for g in gaps if g[0] > 0]
    return _sweep(port, acts, [runtime.get(c) if c else None
                               for c, _, _ in acts], gaps)


def _sweep(port, acts, launches, gaps) -> Dict[SpanKey, SpanTotals]:
    """One pass in time order over the spans' starts and ends, the
    activities' launches and the gaps' middles."""
    points = [(s, 1, k) for k, (s, _, _) in enumerate(port)]
    points += [(e, 0, k) for k, (_, e, _) in enumerate(port)]
    points += [(t, 2, k) for k, t in enumerate(launches) if t is not None]
    points += [((s + e) // 2, 3, k) for k, (_, s, e) in enumerate(gaps)]
    points.sort()
    out: Dict[SpanKey, SpanTotals] = defaultdict(SpanTotals)
    for k, t in enumerate(launches):
        if t is None:                   # its runtime call was not traced
            _credit(out[UNATTRIBUTED], acts[k])
    opened: Dict[int, SpanKey] = {}     # open spans in order of start
    for _, kind, k in points:
        if kind == 0:
            del opened[k]
        elif kind == 1:
            s, e, name = port[k]
            outer = port[next(iter(opened))][2] if opened else name
            opened[k] = (outer, name)
            out[opened[k]].count += 1
            out[opened[k]].host_s += (e - s) * 1e-9
        elif kind == 2:
            for key in set(opened.values()) or (UNATTRIBUTED,):
                _credit(out[key], acts[k])
        else:
            key = opened[next(reversed(opened))] if opened else UNATTRIBUTED
            out[key].idle_s += gaps[k][0] * 1e-9
    return dict(out)


def _credit(tot: SpanTotals, act) -> None:
    _, ns, copy = act
    tot.device_s += ns * 1e-9
    tot.launches += 1
    if copy:
        tot.copy_s += ns * 1e-9


def per_item(spans: Dict[SpanKey, SpanTotals], items: int) -> dict:
    """Each key's totals per traced item, in ms, keyed ``outer/name``."""
    n = max(items, 1)
    out = {}
    for (outer, name), t in sorted(spans.items()):
        key = name if outer in ("", name) else f"{outer}/{name}"
        out[key] = {"n": round(t.count / n, 2),
                    "host_ms": round(1e3 * t.host_s / n, 3),
                    "device_ms": round(1e3 * t.device_s / n, 3),
                    "launches": round(t.launches / n, 1),
                    "copy_ms": round(1e3 * t.copy_s / n, 3),
                    "idle_ms": round(1e3 * t.idle_s / n, 3)}
    return out


def measure(bench, cell, seed: int, seconds: float, device, *, conf=None,
            traffic=None):
    """Set up ``cell`` and trace its window's first ``trace_items`` items:
    (``trace.TraceSummary``, the spans' totals).  ``conf`` and ``traffic``
    replace the cell's own, as in ``harness.run_cell``."""
    import torch
    from . import harness, manifest, trace
    from .loop import closed_loop
    traffic = traffic if traffic is not None else bench.traffic(cell.traffic)
    run = harness.Run(cell=cell.name, config_name=cell.config,
                      conf=conf if conf is not None
                      else bench.config(cell.config),
                      traffic=traffic, seed=seed, device=device,
                      kind=traffic["driver"])
    driver = manifest.load_module("drivers", run.kind)
    torch.manual_seed(seed)
    prog = driver.Program(run)
    tracer = trace.Tracer(device, traffic.get("trace_items"))
    run.window = closed_loop(prog.one, seconds, tracer)
    events = tracer._prof.profiler.kineto_results.events()
    return (trace.reduce(events, tracer._t0, tracer._t1, run.window.traced),
            by_span(events, tracer._t0, tracer._t1))


def report(summary, spans, out=None) -> None:
    out = out or sys.stdout
    held = sum(t.device_s for (o, n), t in spans.items() if o == n)
    total = held + spans.get(UNATTRIBUTED, SpanTotals()).device_s
    print(f"traced {summary.items} items over {summary.window_s:.4f} s: "
          f"device busy {summary.busy_s:.4f} s, activities "
          f"{total:.4f} s, of which {100 * held / max(total, 1e-30):.2f}% "
          f"launched in the port's outermost spans", file=out, flush=True)
    print(f"port spans over the traced items: "
          f"{json.dumps(per_item(spans, summary.items))}", file=out,
          flush=True)


def main(argv) -> int:
    import torch
    from . import harness, manifest
    args = harness.parse(argv)
    bench = manifest.Manifest()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench/spans.py: needs a CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    print(f"card: {harness.card_line()}", flush=True)
    report(*measure(bench, cell, args.seed, args.seconds,
                    torch.device("cuda", 0)))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from portbench.run import fixed_caches
    fixed_caches(ROOT)
    from portbench import spans
    sys.exit(spans.main(sys.argv[1:]))
