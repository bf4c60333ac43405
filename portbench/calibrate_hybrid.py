#!/usr/bin/env python3
"""``calibrate.py`` for the cells of ``drivers/prefill_hybrid.py``: the
same readings and summary, the program run for ``--items`` requests (a
short window at the cell's own load) and judged on the sample a run would
draw from them.

    python3 portbench/calibrate_hybrid.py --workload jamba2-mini.prefill-16k \\
        --seeds 11,12,... [--control-seeds 21,22,23] \\
        [--faults state_unchanged,answer_altered] [--fault-seeds 31] \\
        [--items 6] [--out <file.jsonl>]

The benchmark's own runs never run this.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(bench, cell, seed, items, fault=None, control=False,
             device="cuda"):
    """(numbers, failed) of one seed: the program's over ``items``
    requests, or the control's."""
    import torch
    from portbench import calibrate, harness, manifest
    traffic = bench.traffic(cell.traffic)
    run = harness.Run(cell=cell.name, config_name=cell.config,
                      conf=bench.config(cell.config), traffic=traffic,
                      seed=seed, device=torch.device(device), fault=fault,
                      kind=traffic["driver"])
    driver = manifest.load_module("drivers", run.kind)
    sample = driver.sample(run, items)
    if control:
        outputs = driver.control(run, sample)
    else:
        prog = driver.Program(run)
        for i in range(items):
            prog.one(i)
        outputs = prog.outputs(sample)
        del prog
    calibrate._free()
    numbers = driver.judge(run, outputs)
    del outputs
    calibrate._free()
    return numbers, run.failed


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from portbench import calibrate
    calibrate.readings = readings
    sys.exit(calibrate.main(sys.argv[1:]))
