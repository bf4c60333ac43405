#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights and inputs from the seed on the card, warm-up at the
cell's shapes), a measured window of ``--seconds``, then the comparison
with the plain reference that decides ``correct``.  The last line of
standard output is one JSON object; the numbers compared, each beside its
limit, are the last lines of standard error.  Exits non-zero, printing no
result, without enough CUDA devices for the cell.
"""

import os
import sys
import time
from pathlib import Path

_FIRST_LINE = time.time()
ROOT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """Unix time at which this process started: its age from
    ``/proc/self/stat`` against ``/proc/uptime`` (10 ms ticks), or the
    time this module began where that cannot be read."""
    try:
        stat = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(stat[19]) / os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        age = uptime - started
        if 0.0 <= age < 120.0:
            return time.time() - age
    except (OSError, ValueError, IndexError):
        pass
    return _FIRST_LINE


def fixed_caches(root: Path) -> None:
    """Keep every build and kernel cache inside the checkout at fixed
    paths, so that only the first run of a cell in a checkout builds."""
    base = root / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"     # no library may load JAX behind us


if __name__ == "__main__":
    started = process_start()
    fixed_caches(ROOT)
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    sys.exit(harness.main(sys.argv[1:], started))
