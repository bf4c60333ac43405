"""``portbench/spans.py``: the port's spans credited with what they launched
and held, on made-up events and on tiny runs of each cell on the CPU."""

import contextlib
import io
import time

import pytest

from conftest import tiny_cell
from portbench import manifest, spans, trace


class Ev:
    """A profiler event as the reduction reads it, with the correlation id
    that ties a device activity to the runtime call that launched it."""

    def __init__(self, name, start, dur, dev=False, corr=0):
        self.n, self.s, self.u, self.d, self.c = name, start, dur, dev, corr

    def name(self):
        return self.n

    def device_type(self):
        return "DeviceType.CUDA" if self.d else "DeviceType.CPU"

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.u

    def correlation_id(self):
        return self.c


def launched(name, at, start, dur, corr):
    """A runtime call at ``at`` and the activity it launched."""
    return [Ev("cudaLaunchKernel", at, 5, corr=corr),
            Ev(name, start, dur, dev=True, corr=corr)]


def step_events():
    """forward [0, 1000) holding layer [100, 500) holding attention
    [150, 300); backward [1000, 2000) holding, on another thread, the
    recompute's layer [1200, 1400); optimizer [2000, 2100)."""
    ev = [Ev("repro_torch.forward", 0, 1000),
          Ev("repro_torch.layer", 100, 400),
          Ev("repro_torch.attention", 150, 150),
          Ev("repro_torch.backward", 1000, 1000),
          Ev("repro_torch.layer", 1200, 200),
          Ev("repro_torch.optimizer", 2000, 100),
          Ev("aten::mm", 50, 20, corr=7)]      # an operator's own id
    ev += launched("gemm", 200, 600, 100, corr=7)              # attention
    ev += launched("Memcpy DtoD", 600, 700, 50, corr=8)        # forward
    ev += launched("elementwise", 1300, 1310, 40, corr=9)      # recompute
    ev += launched("direct_copy_kernel", 2050, 2060, 30, corr=10)
    ev += launched("stray", 2500, 2510, 10, corr=11)           # no span
    return ev


def test_a_launch_is_credited_to_every_span_open_at_it():
    s = spans.by_span(step_events(), 0, 3000)
    att = s[("forward", "attention")]
    assert att.device_s == pytest.approx(100e-9) and att.launches == 1
    assert att.count == 1 and att.host_s == pytest.approx(150e-9)
    assert s[("forward", "layer")].launches == 1
    fwd = s[("forward", "forward")]
    assert fwd.device_s == pytest.approx(150e-9) and fwd.launches == 2
    assert fwd.copy_s == pytest.approx(50e-9)
    opt = s[("optimizer", "optimizer")]
    assert opt.copy_s == pytest.approx(30e-9) == opt.device_s


def test_the_recompute_is_the_layer_inside_backward():
    s = spans.by_span(step_events(), 0, 3000)
    rec = s[("backward", "layer")]
    assert rec.count == 1 and rec.device_s == pytest.approx(40e-9)
    assert s[("forward", "layer")].count == 1
    assert s[("backward", "backward")].device_s == pytest.approx(40e-9)


def test_a_launch_in_no_span_is_unattributed():
    s = spans.by_span(step_events(), 0, 3000)
    un = s[spans.UNATTRIBUTED]
    assert un.launches == 1 and un.device_s == pytest.approx(10e-9)
    # an activity whose launch was not traced is unattributed too
    ev = step_events() + [Ev("lost", 2600, 10, dev=True, corr=99)]
    assert spans.by_span(ev, 0, 3000)[spans.UNATTRIBUTED].launches == 2


def test_an_idle_gap_goes_to_the_innermost_span():
    """The device busy over [400, 450) and [1500, 1600) of [0, 2000]: the
    gaps' middles 200, 975 and 1800 lie in attention (inside layer inside
    forward), in forward alone, and in backward."""
    ev = [Ev("repro_torch.forward", 0, 1000),
          Ev("repro_torch.layer", 100, 400),
          Ev("repro_torch.attention", 150, 150),
          Ev("repro_torch.backward", 1000, 1000)]
    ev += launched("k1", 120, 400, 50, corr=1)
    ev += launched("k2", 1100, 1500, 100, corr=2)
    s = spans.by_span(ev, 0, 2000)
    assert {k: t.idle_s for k, t in s.items()} == {
        ("forward", "forward"): pytest.approx(1050e-9),
        ("forward", "layer"): 0.0,
        ("forward", "attention"): pytest.approx(400e-9),
        ("backward", "backward"): pytest.approx(400e-9)}


def test_a_span_on_the_device_timeline_is_neither_span_nor_activity():
    """A port range copied onto the device's timeline (as a user
    annotation would be) counts neither as a span nor as device work."""
    ev = [Ev("repro_torch.layer", 0, 500),
          Ev("repro_torch.layer", 100, 300, dev=True)]
    ev += launched("k", 10, 150, 50, corr=3)
    s = spans.by_span(ev, 0, 500)
    lay = s[("layer", "layer")]
    assert lay.count == 1 and lay.launches == 1
    assert lay.device_s == pytest.approx(50e-9)
    assert lay.idle_s == pytest.approx(450e-9)


def test_the_busy_figures_are_the_benchmarks_own():
    """The events that ``trace.reduce`` counts as device work are those
    credited here: the port's spans add none."""
    s = spans.by_span(step_events(), 0, 3000)
    busy = trace.reduce(step_events(), 0, 3000, items=1).busy_s
    held = sum(t.device_s for (o, n), t in s.items() if o == n)
    assert held + s[spans.UNATTRIBUTED].device_s == pytest.approx(busy)


def test_reduction_of_many_events_takes_seconds():
    ev, n = [], 50_000
    for k in range(0, n, 100):
        ev.append(Ev("repro_torch.layer", 10 * k, 10 * 100))
    for k in range(n):
        ev += launched("k", 10 * k + 1, 10 * k + 3, 5, corr=k + 1)
    t = time.perf_counter()
    s = spans.by_span(ev, 0, 10 * n)
    assert time.perf_counter() - t < 20
    assert s[("layer", "layer")].launches == n


def test_per_item_line_and_report():
    tot = spans.SpanTotals
    found = {("forward", "forward"): tot(2, 1.0, 1.2, 10),
             ("backward", "layer"): tot(32, 1.0, 1.4, 8),
             spans.UNATTRIBUTED: tot(0, 0.0, 0.02, 1)}
    line = spans.per_item(found, 2)
    assert line["backward/layer"]["n"] == 16
    assert line["backward/layer"]["device_ms"] == pytest.approx(700.0)
    assert line["forward"]["launches"] == 5
    assert line["unattributed"]["device_ms"] == pytest.approx(10.0)
    out = io.StringIO()
    summary = trace.TraceSummary(3.0, 1.2, {}, {}, items=2)
    spans.report(summary, found, out)
    assert "98.36% launched in the port's outermost spans" in out.getvalue()
    assert out.getvalue().splitlines()[1].startswith(
        "port spans over the traced items: {")


def test_without_a_card_nothing_runs(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = spans.main(["--workload", "olmo-1b.train-4k", "--seed", "1",
                         "--seconds", "1"])
    assert rc == 2 and "CUDA" in err.getvalue()


@pytest.mark.parametrize("cell_name", list(manifest.Manifest().cells))
def test_a_tiny_run_of_each_cell_opens_the_spans(cell_name, bench,
                                                monkeypatch):
    """Each cell cut to a tiny model on the CPU: every traced item opens
    one span per layer and two norms per layer and one more, and a train
    step runs its layers again inside ``backward`` (remat)."""
    import torch
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cell, conf, traffic = tiny_cell(bench, cell_name)
    traffic["trace_items"] = 1
    summary, found = spans.measure(bench, cell, 2 ** 31 + 7, 0.5,
                                   torch.device("cpu"), conf=conf,
                                   traffic=traffic)
    layers = conf["num_hidden_layers"]
    assert summary.items == 1
    if traffic["driver"] == "train":
        want = {("forward", "layer"): layers, ("backward", "layer"): layers,
                ("forward", "norm"): 2 * layers + 1,
                ("optimizer", "optimizer"): 1}
    else:
        want = {("prefill", "prefill"): 1, ("prefill", "layer"): layers,
                ("prefill", "attention"): layers, ("prefill", "mlp"): layers,
                ("prefill", "norm"): 2 * layers + 1}
    assert {k: found[k].count for k in want} == want
