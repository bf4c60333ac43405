#!/usr/bin/env python3
"""Read the numbers that set a cell's limits, on the card, in one process:
the program's on many seeds, the control's (the reference in float8
products put in the program's place) and the planted faults' on a few.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... \\
        [--control-seeds 21,22,23] [--faults half_batch,answer_altered] \\
        [--fault-seeds 31,32,33] [--items 6] [--out <file.jsonl>]

A prefill cell's program runs ``--items`` requests (a short window at the
cell's own load) and is judged on the sample a run would draw from them; a
training cell's runs only its checked steps.  Each reading is one JSON
line; the last lines give each number's largest sound reading (the lower
end of its limit) and smallest control reading (the upper end).  The
benchmark's own runs never run this.
"""

import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(bench, cell, seed, items, fault=None, control=False,
             device="cuda", conf=None, traffic=None):
    import torch
    from portbench import harness, manifest
    traffic = traffic or bench.traffic(cell.traffic)
    run = harness.Run(cell=cell.name, config_name=cell.config,
                      conf=conf or bench.config(cell.config),
                      traffic=traffic, seed=seed,
                      device=torch.device(device),
                      fault=fault, kind=traffic["driver"])
    driver = manifest.load_module("drivers", run.kind)
    n = items if run.kind == "prefill" else 0
    sample = driver.sample(run, n)
    if control:
        outputs = driver.control(run, sample)
    else:
        prog = driver.Program(run)
        for i in range(n):
            prog.one(i)
        outputs = prog.outputs(sample)
        del prog
    _free()
    numbers = driver.judge(run, outputs)
    del outputs
    _free()
    return numbers, run.failed


def _free():
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(argv) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--items", type=int, default=6)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import manifest
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = manifest.Manifest()
    cell = bench.cell(args.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    jobs = [("sound", None, s) for s in ints(args.seeds)]
    jobs += [("control", None, s) for s in ints(args.control_seeds)]
    jobs += [(f, f, s) for f in args.faults.split(",") if f
             for s in ints(args.fault_seeds)]
    sink = open(args.out, "a") if args.out else None
    table = {}
    for kind, fault, seed in jobs:
        t = time.perf_counter()
        numbers, failed = readings(bench, cell, seed, args.items, fault,
                                   control=kind == "control")
        line = {"cell": cell.name, "kind": kind, "seed": seed,
                "numbers": numbers, "failed": failed,
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        if sink:
            print(json.dumps(line), file=sink, flush=True)
        table.setdefault(kind, []).append(numbers)
    for name in (table.get("sound") or table.get("control") or [{}])[0]:
        row = {kind: [r[name] for r in rows] for kind, rows in table.items()}
        lower = max(row.get("sound", [float("nan")]))
        upper = min(row.get("control", [float("nan")]))
        print(f"{name}: lower (largest sound) {lower!r}, upper (smallest "
              f"control) {upper!r}, ratio {upper / lower if lower else 0:.3g}"
              f"; faults " + ", ".join(
                  f"{k} min {min(v)!r}" for k, v in row.items()
                  if k not in ("sound", "control")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
