"""One run of one cell: set-up, the measured window, the check against the
plain reference, the metrics, and the result line."""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

from . import judge, manifest
from .loop import Window, closed_loop

BANNED = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    """What a run knows, handed to the driver and to every metric reader."""
    cell: str
    config_name: str
    conf: dict
    traffic: dict
    seed: int
    device: object
    kind: str = ""
    fault: Optional[str] = None
    setup_s: float = 0.0
    window: Window = field(default_factory=Window)
    peak_bytes: int = 0
    trace: object = None            # trace.TraceSummary with --trace 1
    counters: dict = field(default_factory=dict)
    failed: int = 0
    flops_per_item: float = 0.0
    marks: list = field(default_factory=list)   # (set-up phase, Unix time)

    def mark(self, phase: str) -> None:
        self.marks.append((phase, time.time()))


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py",
                                description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def banned_modules(names=None) -> list:
    """Modules of JAX, Flax or the JAX package among ``names`` (default:
    those loaded in this process), compared by whole top-level names
    (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv, started: float) -> int:
    marks = [("interpreter", time.time())]
    args = parse(argv)
    bench = manifest.Manifest()
    cell = bench.cell(args.workload)
    import torch
    marks.append(("import torch", time.time()))
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found; nothing was run",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    marks.append(("CUDA context", time.time()))
    return run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                    started, device, marks=marks)


def run_cell(bench, cell, seed: int, seconds: float, trace: bool,
             started: float, device, *, conf=None, traffic=None,
             limits=None, fault=None, out=None, err=None,
             marks=()) -> int:
    """Set up, measure, check and report one cell.  ``conf``,
    ``traffic``, ``limits`` and ``fault`` replace the cell's own (the
    tests run a tiny configuration on the CPU this way)."""
    import torch
    from . import trace as tracing
    out, err = out or sys.stdout, err or sys.stderr
    traffic = traffic if traffic is not None else bench.traffic(cell.traffic)
    run = Run(cell=cell.name, config_name=cell.config,
              conf=conf if conf is not None else bench.config(cell.config),
              traffic=traffic, seed=seed, device=device, fault=fault,
              kind=traffic["driver"], marks=list(marks))
    limits = limits if limits is not None else bench.limits(cell.name)
    driver = manifest.load_module("drivers", run.kind)
    cuda = torch.device(device).type == "cuda"
    torch.manual_seed(seed)

    prog = driver.Program(run)
    before = prog.counters()
    tracer = (tracing.Tracer(device, traffic.get("trace_items"))
              if trace else None)
    run.window = closed_loop(prog.one, seconds, tracer)
    run.setup_s = run.window.start_unix - started
    run.counters = {k: v - before.get(k, 0)
                    for k, v in prog.counters().items()}
    if cuda:
        torch.cuda.synchronize(device)
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    if tracer is not None:
        run.trace = tracer.summary(run.window.traced)
    run.flops_per_item = driver.flops_per_item(run)
    outputs = prog.outputs(driver.sample(run, len(run.window.items)))
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = driver.judge(run, outputs)
    del outputs
    print(f"portbench: the check against the reference took "
          f"{time.perf_counter() - t:.1f} s", file=err, flush=True)
    correct = judge.verdict(numbers, limits) and run.failed == 0

    banned = banned_modules()
    if banned:
        print(f"portbench: {', '.join(banned)} loaded in this process; no "
              f"result", file=err)
        return 3
    names = (bench.per_layer_of(cell.name) if trace
             else bench.end_to_end_of(cell.name))
    metrics = {}
    for name in names:
        value = manifest.load_module("metrics", name).read(run)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {name} read nothing "
                                   f"in cell {cell.name}")
            continue
        metrics[name] = {"value": value, "unit": bench.metrics[name].unit}
    if cuda:
        print(f"card: {card_line()}", file=out, flush=True)
    print("set-up: " + setup_line(started, run.marks, run.window.start_unix),
          file=out, flush=True)
    print("window: " + window_line(run.window), file=out, flush=True)
    if run.counters:
        print(f"program counters over the window: "
              f"{json.dumps(run.counters)}", file=out, flush=True)
    result = {"correct": correct, "attempted": len(run.window.items),
              "failed": run.failed, "metrics": metrics,
              "device": device_info(run, cell, device, cuda)}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = judge.checks(numbers, limits)
    print(json.dumps(result), file=out, flush=True)
    print(judge.check_lines(numbers, limits), file=err, flush=True)
    return 0


def setup_line(started: float, marks, window_start: float) -> str:
    """Seconds of each set-up phase, from the process's start on."""
    parts, last = [], started
    for phase, t in list(marks) + [("until the window", window_start)]:
        parts.append(f"{phase} {t - last:.2f} s")
        last = t
    return "; ".join(parts)


def window_line(w) -> str:
    """The spread of the window's requests or steps, to tell a stall in a
    few of them from a slower run of all."""
    secs = sorted(it.done - it.issued for it in w.items)
    if not secs:
        return "no item completed"
    between = sum(b.issued - a.done for a, b in zip(w.items, w.items[1:]))
    slow = sum(x > 2 * secs[len(secs) // 2] for x in secs)
    return (f"{len(secs)} items in {w.seconds:.3f} s; item s min "
            f"{secs[0]:.4f} median {secs[len(secs) // 2]:.4f} p90 "
            f"{secs[int(0.9 * (len(secs) - 1))]:.4f} max {secs[-1]:.4f}; "
            f"{slow} over twice the median; {between:.4f} s between items")


def device_info(run, cell, device, cuda: bool) -> dict:
    import torch
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    return info
