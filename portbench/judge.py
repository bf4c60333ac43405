"""What decides ``correct``: each number compared against its limit from
``limits/<cell>.json``, and how the numbers are printed."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Mapping


def rel_gap(a: float, b: float, floor: float) -> float:
    """|a - b| against the larger of |b| and ``floor``."""
    return abs(a - b) / max(abs(b), floor)


def train_numbers(prog: Mapping, ref: Mapping) -> Dict[str, float]:
    """The training cell's numbers (see ``PERF.md``):

    loss_gap    the widest |loss - reference loss| over the checked steps
    gnorm_gap   the first step's global gradient norm before clipping,
                against the reference's, relative
    grad_gap    the worst leaf's gap between the norms of the first
                gradient as AdamW applied it, against the reference's norm
                of that leaf or of the median leaf, whichever is larger
    change_gap  the same of each leaf's change over the checked steps,
                leaving out leaves whose reference gradient is under a
                thousandth of the median leaf's
    """
    inf = float("inf")
    if set(prog.get("grad_norms", {})) != set(ref["grad_norms"]) or \
            len(prog.get("loss", [])) != len(ref["loss"]):
        return {"loss_gap": inf, "gnorm_gap": inf, "grad_gap": inf,
                "change_gap": inf}
    g_ref = ref["grad_norms"]
    med_g = statistics.median(g_ref.values())
    keep = [k for k, g in g_ref.items() if g >= 1e-3 * med_g]
    c_ref = ref["change_norms"]
    med_c = statistics.median(c_ref[k] for k in keep)
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(prog["loss"],
                                                   ref["loss"])),
        "gnorm_gap": rel_gap(prog["gnorm"], ref["gnorm"], 0.0),
        "grad_gap": max(rel_gap(prog["grad_norms"][k], g_ref[k], med_g)
                        for k in g_ref),
        "change_gap": max(rel_gap(prog["change_norms"][k], c_ref[k], med_c)
                          for k in keep),
    }


def verdict(numbers: Mapping[str, float], limits: Mapping) -> bool:
    """True when every number has a limit, is finite and is within it, and
    every limit has its number."""
    lim = limits.get("numbers", {})
    if not lim or set(lim) != set(numbers):
        return False
    return all(math.isfinite(numbers[k]) and numbers[k] <= lim[k]["limit"]
               for k in lim)


def checks(numbers: Mapping[str, float], limits: Mapping) -> dict:
    lim = limits.get("numbers", {})
    return {k: {"value": v, "limit": lim.get(k, {}).get("limit")}
            for k, v in numbers.items()}


def check_lines(numbers: Mapping[str, float], limits: Mapping) -> str:
    return "\n".join(f"check {k} {v['value']!r} limit {v['limit']!r}"
                     for k, v in checks(numbers, limits).items())
