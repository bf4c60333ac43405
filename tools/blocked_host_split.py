#!/usr/bin/env python3
"""Where the blocked Explorer's wall time goes between the block
relaxation and the storage-queue replay, on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/blocked_host_split.py

For each of the 10 cells of ``default_scenarios()`` it builds the blocked
engine's inputs for 4096 seed-0 candidates as ``Explorer.explore`` does
(``dse._reweight`` of the candidates' θ), then times on the host clock,
after a warm-up:

* the queueing fixed point as the Explorer runs it (``_fixed_point_core``
  with its 2 iterations), with one ``torch.cuda.synchronize()`` at the
  end;
* the same fixed point step by step, with a synchronize after each step,
  so that its parts add up to its time: the closures
  (``Solver.relax_for``: one closure launch for the cell), the 3
  relaxations (``_blocked_relax``: a folded matvec, the far-edge gathers
  and a closure matvec per block) and the 2 queue replays (``_queue_fold``:
  every storage's request-slot queue replayed in arrival order);

each the median of 3 calls, and counts the device kernels a relaxation
and a queue replay launch (``torch.profiler``).  The step-by-step total
exceeds the fixed point's by what the synchronizes cost and what the
fixed point overlaps (the host issues a step while the device still runs
the last).  The last line is a JSON object of the numbers.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.core.aidg import dse as DSE  # noqa: E402
from repro_torch.core.aidg import maxplus as MP  # noqa: E402
from repro_torch.core.aidg.explorer import (DEFAULT_SPACE,  # noqa: E402
                                            compile_scenario,
                                            default_scenarios,
                                            random_candidates)

N_ITERS = 2     # the Explorer's queueing iterations


def host_ms(fn, reps: int = 3) -> float:
    """Median host ms of ``fn()`` followed by a synchronize, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return float(np.median(out))


def stepwise_ms(solver, work, base, st_lat, reps: int = 3) -> dict:
    """Median host ms of each part of ``_fixed_point_core``, run step by
    step with a synchronize after each: {"closures", "relax" (all 3),
    "replay" (both)}; the first of ``reps + 1`` runs is a warm-up."""
    runs = []
    for _ in range(reps + 1):
        part = {"closures": 0.0, "relax": 0.0, "replay": 0.0}

        def timed(name, fn, *args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            part[name] += (time.perf_counter() - t) * 1e3
            return out

        relax = timed("closures", solver.relax_for, work)
        t = timed("relax", relax, base)
        for _ in range(N_ITERS if solver.ca.aidg.storage_nodes else 0):
            b = timed("replay", MP._queue_fold, solver, work, t, base,
                      st_lat)
            t = timed("relax", relax, b)
        runs.append(part)
    return {k: float(np.median([r[k] for r in runs[1:]])) for k in runs[0]}


def launches(fn) -> int:
    """Device kernels (and copies) ``fn()`` launches."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if str(e.device_type).split(".")[-1] == "CUDA")


def main() -> int:
    if not torch.cuda.is_available():
        print("blocked_host_split: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}", flush=True)
    dev = torch.device("cuda")
    cand = random_candidates(DEFAULT_SPACE, cs.N_CAND, seed=0)
    parts = ("closures", "relax", "replay")
    rows = {}
    tot = {k: 0.0 for k in parts + ("stepwise", "fixed_point")}
    for sc in default_scenarios():
        cp = compile_scenario(sc)
        sw = DSE._Sweep(cp.problem, N_ITERS, "blocked", dev)
        to, ts = DEFAULT_SPACE.theta_for(cp.problem, cand)
        work, st_lat, _ = DSE._reweight(cp.problem, sw.tensor(to),
                                        sw.tensor(ts), sw.arrays)
        base = sw.base.expand(work.shape[0], -1).contiguous()
        relax = sw.solver.relax_for(work)
        t = relax(base)
        r = {f"{k}_ms": v for k, v in stepwise_ms(sw.solver, work, base,
                                                  st_lat).items()}
        r["stepwise_ms"] = sum(r[f"{k}_ms"] for k in parts)
        r["fixed_point_ms"] = host_ms(lambda: MP._fixed_point_core(
            sw.solver, work, base, st_lat, N_ITERS))
        r["relax_launches"] = launches(lambda: relax(base))
        r["replay_launches"] = launches(lambda: MP._queue_fold(
            sw.solver, work, t, base, st_lat))
        rows[sc.name] = r
        for k in tot:
            tot[k] += r[f"{k}_ms"]
        print(f"{sc.name}: step by step: closures {r['closures_ms']:.2f} ms"
              f", 3 relaxations {r['relax_ms']:.2f} ms ({r['relax_launches']}"
              f" launches each), 2 queue replays {r['replay_ms']:.2f} ms "
              f"({r['replay_launches']} launches each) = "
              f"{r['stepwise_ms']:.2f} ms; the fixed point in one go "
              f"{r['fixed_point_ms']:.2f} ms", flush=True)
    print(f"all 10 cells, step by step: closures {tot['closures']:.1f} ms, "
          f"3 relaxations {tot['relax']:.1f} ms, 2 queue replays "
          f"{tot['replay']:.1f} ms = {tot['stepwise']:.1f} ms; the fixed "
          f"points in one go {tot['fixed_point']:.1f} ms", flush=True)
    print(json.dumps({"cells": rows, "total_ms": tot}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
