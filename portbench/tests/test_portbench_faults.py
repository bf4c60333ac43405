"""A whole run on the CPU at a tiny size, past the look for a card, with
each fault the cell can have planted under the timed path: ``correct``
comes out false.  Without a fault it comes out true, under the same
limits (the cell's own, set at full size on the card)."""

import io
import json
import time

import pytest
import torch

from conftest import tiny_cell
from portbench import faults, harness, manifest

BENCH = manifest.Manifest()


def applicable(cell_name):
    traffic = BENCH.traffic(BENCH.cell(cell_name).traffic)
    return [f for f in faults.FAULTS
            if f != "half_batch" or traffic["batch"] > 1]


CASES = [(c, f) for c in BENCH.cells for f in applicable(c)]


def tiny_run(cell_name, fault):
    cell, conf, traffic = tiny_cell(BENCH, cell_name)
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(BENCH, cell, 2 ** 31 + 99, 1.0, False, time.time(),
                          torch.device("cpu"), conf=conf, traffic=traffic,
                          fault=fault, out=out, err=err)
    assert rc == 0, err.getvalue()
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    return result


@pytest.mark.parametrize("cell_name,fault", CASES,
                         ids=[f"{c}-{f}" for c, f in CASES])
def test_fault_makes_the_run_incorrect(cell_name, fault):
    assert tiny_run(cell_name, fault)["correct"] is False


@pytest.mark.parametrize("cell_name", list(BENCH.cells))
def test_sound_tiny_run_is_correct(cell_name):
    result = tiny_run(cell_name, None)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_training_check_reads_the_window_steps(monkeypatch):
    """A step that goes wrong only from the call after as many calls as the
    check compares is caught: the steps compared are the window's, after
    set-up's warm-up."""
    real = faults.train_step
    sound_calls = BENCH.traffic("train-4k")["check_steps"]

    def late(step, fault):
        inner, calls = real(step, fault), []

        def wrapped(params, opt_state, batch):
            calls.append(1)
            params, opt_state, metrics = inner(params, opt_state, batch)
            if len(calls) > sound_calls:
                metrics = dict(metrics, loss=metrics["loss"] * 1.01)
            return params, opt_state, metrics

        return wrapped

    monkeypatch.setattr(faults, "train_step", late)
    assert tiny_run("olmo-1b.train-4k", None)["correct"] is False
