"""Roofline report: read the dry run's JSON records and emit the roofline
table on the H100 (the port of ``repro.launch.roofline_report``).

    PYTHONPATH=src python -m repro_torch.launch.roofline_report \\
        --dryrun experiments/dryrun_torch --mesh single --markdown
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path
from typing import Dict, List, Optional

from ..models.config import SHAPES
from .roofline import HW_H100, RooflineCell, roofline_terms

__all__ = ["load_cells", "analyze", "table", "main"]


def load_cells(dryrun_dir: Path, mesh: str = "single") -> List[Dict]:
    out = []
    for p in sorted(Path(dryrun_dir).glob(f"*__{mesh}.json")):
        r = json.loads(p.read_text())
        if "memory" in r:
            out.append(r)
    return out


def analyze(rec: Dict) -> Optional[RooflineCell]:
    """Roofline terms for one dry-run record, on ``HW_H100``.

    FLOPs, bytes and collective bytes per device are the record's
    (``StepCounter`` counts every op the step runs, so no loop trip
    correction applies, unlike the reference's HLO walk).  The chips are
    the product of the record's mesh (``"16x16"``)."""
    flops = rec.get("flops_per_device") or 0.0
    hbm = rec.get("bytes_per_device") or 0.0
    coll = rec.get("collective_bytes_total") or 0.0
    shape = SHAPES[rec["shape"]]
    tokens = (shape.global_batch if shape.mode == "decode"
              else shape.global_batch * shape.seq_len)
    mult = 3 if shape.mode == "train" else 1
    n_chips = math.prod(int(n) for n in rec["mesh"].split("x"))
    model_flops = 2.0 * mult * rec["n_active_params"] * tokens / n_chips
    t = roofline_terms(flops, hbm, coll, HW_H100)
    cell = RooflineCell(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        compute_s=t["compute_s"], memory_s=t["memory_s"],
        collective_s=t["collective_s"],
        model_flops=model_flops, hlo_flops=flops,
        useful_ratio=model_flops / max(flops, 1e-30))
    # decode: mandatory traffic = parameters + cache streamed once a token
    cell.mandatory_memory_s = (  # type: ignore[attr-defined]
        rec.get("memory", {}).get("argument_bytes", 0)
        / HW_H100["hbm_bytes_per_s"])
    return cell


def table(cells: List[RooflineCell], markdown: bool = True) -> str:
    hdr = ["arch", "shape", "compute_s", "memory_s", "collective_s",
           "bound", "roofline_frac", "useful_flops_ratio"]
    rows = []
    for c in cells:
        rows.append([c.arch, c.shape, f"{c.compute_s:.4g}",
                     f"{c.memory_s:.4g}", f"{c.collective_s:.4g}",
                     c.dominant, f"{c.roofline_fraction:.3f}",
                     f"{c.useful_ratio:.3f}"])
    if markdown:
        lines = ["| " + " | ".join(hdr) + " |",
                 "|" + "|".join(["---"] * len(hdr)) + "|"]
        lines += ["| " + " | ".join(r) + " |" for r in rows]
        return "\n".join(lines)
    lines = [",".join(hdr)] + [",".join(r) for r in rows]
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    recs = load_cells(Path(args.dryrun), args.mesh)
    cells = [analyze(r) for r in recs]
    print(table([c for c in cells if c], markdown=args.markdown))


if __name__ == "__main__":
    main()
