"""Faults planted under the timed path, to show that ``correct`` comes out
false for each (``tests/test_portbench_faults.py``) and to read them on the
card (``calibrate.py``).  A run of the benchmark takes none: ``fault`` is
None there.

state_unchanged  the step or prefill returns without changing its state
                 (the parameters and optimizer state; the cache)
half_batch       half of the batch left out: the step takes the mean over
                 the rest; the prefill serves the first half's answers for
                 all rows
answer_altered   the answer altered where it is produced: the step's loss
                 by 1%, the prefill's served token to the next id
"""

from __future__ import annotations

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def train_step(step, fault):
    """The program's ``train_step`` with ``fault`` planted under it."""
    if fault is None:
        return step
    import torch

    def faulty(params, opt_state, batch):
        if fault == "half_batch":
            half = batch["tokens"].shape[0] // 2
            return step(params, opt_state,
                        {k: v[:half] for k, v in batch.items()})
        if fault == "state_unchanged":
            saved = {n: p.detach().clone()
                     for n, p in params.named_parameters()}
            moments = {k: {n: t.clone() for n, t in opt_state[k].items()}
                       for k in ("m", "v")}
            step_count = opt_state["step"]
            out = step(params, opt_state, batch)
            with torch.no_grad():
                for n, p in params.named_parameters():
                    p.copy_(saved[n])
                for k in ("m", "v"):
                    for n, t in opt_state[k].items():
                        t.copy_(moments[k][n])
            opt_state["step"] = step_count
            return out
        if fault == "answer_altered":
            params, opt_state, metrics = step(params, opt_state, batch)
            return params, opt_state, dict(metrics,
                                           loss=metrics["loss"] * 1.01)
        raise ValueError(f"unknown fault {fault!r}")

    return faulty
