"""The command without a card, the window's loop, the trace's reduction
and the metric readers on made-up runs."""

import contextlib
import io
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from portbench import harness, loop, manifest, trace

CELLS = [w for w in manifest.Manifest().cells]


@pytest.mark.parametrize("cell", CELLS)
def test_without_a_card_no_result(cell, monkeypatch):
    """Each driver's cell, asked for a tiny run on a machine without a
    card, prints no result and exits non-zero."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.main(["--workload", cell, "--seed", str(2 ** 31 + 11),
                           "--seconds", "1", "--trace", "0"], time.time())
    assert rc != 0 and out.getvalue() == ""
    assert "CUDA" in err.getvalue()


def test_command_in_a_process_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(manifest.HERE / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout == ""


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        manifest.Manifest().cell("no-such.cell")


def test_closed_loop_runs_until_the_time_and_counts_all():
    calls = []

    def one(i):
        t = time.perf_counter()
        time.sleep(0.01)
        calls.append(i)
        return loop.Item(t, time.perf_counter(), 3)

    w = loop.closed_loop(one, 0.1)
    assert calls == list(range(len(calls))) and len(calls) >= 5
    assert w.units == 3 * len(calls)
    assert w.seconds >= 0.1 and w.end == w.items[-1].done


def test_union_and_idle_gaps():
    assert trace.union([(5, 7), (0, 2), (1, 3), (6, 9)]) == [(0, 3), (5, 9)]

    class E:
        def __init__(self, name, dev, start, dur, kind="kernel"):
            self.n, self.d, self.s, self.u, self.k = name, dev, start, dur, \
                kind

        def name(self):
            return self.n

        def device_type(self):
            return "DeviceType.CUDA" if self.d else "DeviceType.CPU"

        def activity_type(self):
            return self.k

        def start_ns(self):
            return self.s

        def duration_ns(self):
            return self.u

    events = [E("k1", True, 100, 100), E("k2", True, 150, 100),
              E("memcpy", True, 400, 100),
              E("gpu_range", True, 0, 1000, "gpu_user_annotation"),
              E("aten::mm", False, 260, 120), E("host_loop", False, 0, 1000)]
    s = trace.reduce(events, 0, 1000, items=2)
    assert s.busy_s == pytest.approx(250e-9)
    assert s.window_s == pytest.approx(1000e-9)
    assert s.ops["k1"] == (pytest.approx(1e-7), 1)
    # the gap 250..400 is named by the innermost op over its middle
    assert s.idle_by_host["aten::mm"] == pytest.approx(150e-9)
    assert s.idle_by_host["host_loop"] == pytest.approx(600e-9)
    b = s.breakdown()
    assert b["device_ops"][0][0] in ("k1", "k2", "memcpy")
    assert len(b["idle_gaps"]) == 2


def fake_run(kind, **kw):
    items = [loop.Item(0.0, 0.5, 100, 0.01), loop.Item(0.5, 1.0, 100, 0.03)]
    w = loop.Window(start=0.0, end=1.0, items=items, traced=1)
    tr = trace.TraceSummary(window_s=0.5, busy_s=0.4,
                            ops={"void flash_attention_wgmma_kernel<96, 96>":
                                 (0.1, 2), "Memcpy DtoD": (0.05, 3),
                                 "direct_copy_kernel": (0.05, 1)},
                            idle_by_host={}, items=1)
    bench = manifest.Manifest()
    conf = bench.config("olmo-1b" if kind == "train" else "phi3-vision-4b")
    traffic = bench.traffic("train-4k" if kind == "train" else "prefill-16k")
    return SimpleNamespace(kind=kind, window=w, trace=tr, setup_s=12.5,
                           peak_bytes=2 ** 31, conf=conf, traffic=traffic,
                           flops_per_item=1e12, **kw)


def read(name, run):
    return manifest.load_module("metrics", name).read(run)


def test_readers_of_a_training_run():
    run = fake_run("train")
    assert read("train_tokens_per_s", run) == 200.0
    assert read("peak_mem_gib", run) == 2.0
    assert read("setup_s", run) == 12.5
    assert read("idle_pct.train", run) == pytest.approx(20.0)
    assert read("copy_ms.train", run) == pytest.approx(100.0)
    assert read("mfu.train", run) == pytest.approx(100 * 2e12 / 989e12)


def test_readers_of_a_prefill_run():
    run = fake_run("prefill")
    assert read("prefill_tokens_per_s", run) == 200.0
    assert read("ttft_p90_ms", run) == pytest.approx(500.0)
    assert read("enqueue_ms.prefill", run) == pytest.approx(30.0)
    roof = read("b2_roofline.prefill", run)
    assert roof == pytest.approx(100 * 2 * 32 * 134_225_920 * 384 / 989e12
                                 / 0.1)
    assert read("mfu.prefill", run) == pytest.approx(100 * 2e12 / 989e12)
    assert read("idle_pct.prefill", run) == pytest.approx(20.0)
    run.trace = None
    assert read("b2_roofline.prefill", run) is None
    assert read("idle_pct.prefill", run) is None
    assert read("mfu.prefill", run) is None


def test_each_cell_reads_only_its_own_metrics():
    """``workloads`` in BENCHMARK.json alone binds a metric to its cells."""
    bench = manifest.Manifest()
    train = bench.per_layer_of("olmo-1b.train-4k")
    prefill = bench.per_layer_of("phi3-vision-4b.prefill-2k")
    assert {"mfu.train", "idle_pct.train", "copy_ms.train"} <= set(train)
    assert not any(m.endswith(".prefill") for m in train)
    assert not any(m.endswith(".train") for m in prefill)
    assert "train_tokens_per_s" not in bench.end_to_end_of(
        "phi3-vision-4b.prefill-16k")
