"""The control: the reference in float8 products, put in the program's
place, comes out not correct under each cell's limits.  On the card, at
the cell's widths and a few layers (what a test run can hold); the full
size was read by ``calibrate.py`` (see PERF.md)."""

import pytest

from portbench import harness, judge, manifest

BENCH = manifest.Manifest()
LAYERS = 4


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", list(BENCH.cells))
def test_control_is_not_correct(cuda_device, cell_name):
    cell = BENCH.cell(cell_name)
    conf = dict(BENCH.config(cell.config), num_hidden_layers=LAYERS)
    traffic = BENCH.traffic(cell.traffic)
    if traffic["driver"] == "train":
        traffic["batch"] = 1
    run = harness.Run(cell=cell.name, config_name=cell.config, conf=conf,
                      traffic=traffic, seed=2 ** 31 + 5, device=cuda_device,
                      kind=traffic["driver"])
    driver = manifest.load_module("drivers", run.kind)
    sample = driver.sample(run, traffic.get("check_requests", 3) + 2)
    numbers = driver.judge(run, driver.control(run, sample))
    assert not judge.verdict(numbers, BENCH.limits(cell.name)), numbers
