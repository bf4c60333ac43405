"""The hybrid prefill cell (``drivers/prefill_hybrid.py``): its sizes and
weights, the frozen counts, the readers it reports, the float32 reference
against the port, and whole runs on the CPU at a tiny size of one period
(8 layers: attention at 4, experts at the odd ones), with the faults that
``correct`` must catch failing the new numbers by ten times their limits
or more."""

import io
import json
import time
from dataclasses import replace
from types import SimpleNamespace

import pytest
import torch

from conftest import TINY
from portbench import counts_hybrid, harness, manifest, seeded_hybrid, trace
from portbench.reference import hybrid as ref
from portbench.reference.lm import Precision

CELL = "jamba2-mini.prefill-16k"
BENCH = manifest.Manifest()


def tiny():
    """(cell, configuration, traffic) of the cell at one period of 8
    layers, 4 of 16 experts held, on the CPU."""
    cell = BENCH.cell(CELL)
    conf = dict(BENCH.config(cell.config), **TINY)
    conf.update(num_hidden_layers=8, num_key_value_heads=2, num_experts=4,
                mamba_dt_rank=8, published={"num_experts": 16})
    traffic = dict(BENCH.traffic(cell.traffic), prompt_tokens=40,
                   prompt_pool=4, trace_items=1)
    return cell, conf, traffic


def test_the_configuration_keeps_the_published_sizes():
    conf = BENCH.config("jamba2-mini")
    s = seeded_hybrid.dims(conf)
    assert (s["d"], s["ff"], s["layers"], s["heads"], s["kv_heads"],
            s["head_dim"], s["vocab"]) == (4096, 14336, 32, 32, 8, 128, 65536)
    assert (s["experts"], s["held"], s["top_k"]) == (16, 8, 2)
    assert (s["d_state"], s["d_conv"], s["d_inner"], s["dt_rank"]) == \
        (16, 4, 8192, 256)
    layers = seeded_hybrid.kinds(conf)
    assert [i for i, (m, _) in enumerate(layers) if m == "attn"] == \
        [4, 12, 20, 28]
    assert [i for i, (_, e) in enumerate(layers) if e] == \
        list(range(1, 32, 2))
    entry = [c for c in json.loads((manifest.ROOT / "BENCHMARK.json")
                                   .read_text())["configs"]
             if c["name"] == "jamba2-mini"][0]
    assert entry["reduced"] == ["num_experts"]
    assert conf["published"] == {"num_experts": 16}
    assert "EP 2" in conf["deployment"]
    n = sum(torch.Size(shape).numel()
            for _, shape, _, _ in seeded_hybrid.layout(conf))
    assert 29.0e9 < n < 29.05e9         # ~54 GiB in bf16


def test_weights_from_the_seed_repeat_and_follow_their_kinds():
    _, conf, _ = tiny()
    a = seeded_hybrid.weights(conf, 5, "cpu", torch.float32)
    b = seeded_hybrid.weights(conf, 5, "cpu", torch.float32)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["layers.0.mix.A_log"][3],
                       torch.log(torch.arange(1.0, 17.0)))
    assert abs(float(a["layers.0.mix.dt_bias"].mean()) + 4.6) < 0.2
    assert a["layers.1.ffn.w_gate"].shape == (4, 64, 128)
    assert a["layers.1.ffn.router"].shape == (64, 16)
    assert "layers.4.mix.wq" in a and "layers.4.mix.in_proj" not in a
    # the router's held and other experts' mean columns are balanced
    r = a["layers.1.ffn.router"]
    torch.testing.assert_close(r[:, :4].mean(1), r[:, 4:].mean(1),
                               atol=1e-6, rtol=0)
    assert not torch.allclose(r[:, 0], r[:, 1])


def test_prefill_flops_by_hand():
    conf = BENCH.config("jamba2-mini")
    d, ff, di, dtr, n, T = 4096, 14336, 8192, 256, 16, 16384
    mamba = 2 * T * (d * 2 * di + di * (dtr + 2 * n) + dtr * di + di * d)
    attn = 2 * T * d * 128 * (64 + 16) + \
        2 * 2 * 128 * 32 * (T * (T + 1) // 2)
    ffn = 6 * d * ff * T
    want = 28 * mamba + 4 * attn + 16 * ffn + 16 * (2 * 8 / 16) * ffn + \
        2 * d * 65536
    got = counts_hybrid.prefill_flops(conf, 1, T)
    assert got == pytest.approx(want, rel=1e-12)
    assert 18.0e9 < got / T < 18.1e9


def test_scan_bound_by_hand():
    sec, kind = counts_hybrid.scan_bound(1, 16384, 8192, 16)
    assert kind == "operations"
    assert sec == pytest.approx(16384 * 8192 * 16 / (132 * 16 * 1.98e9))
    # PERF.md's kernel table, row 3: 0.2568 ms at (4, 2048, 8192)
    assert counts_hybrid.scan_bound(4, 2048, 8192, 16)[0] == \
        pytest.approx(0.2568e-3, rel=1e-3)
    assert counts_hybrid.scan_bound(1, 64, 8192, 1)[1] == "bytes"


def fake_run(trace_ops):
    conf = BENCH.config("jamba2-mini")
    traffic = BENCH.traffic("hybrid-prefill-16k")
    tr = trace.TraceSummary(window_s=2.0, busy_s=1.9, ops=trace_ops,
                            idle_by_host={}, items=2)
    return SimpleNamespace(trace=tr, conf=conf, traffic=traffic,
                           flops_per_item=3e14)


def read(name, run):
    return manifest.load_module("metrics", name).read(run)


def test_the_readers():
    scan = "void (anonymous namespace)::ring::selective_scan_ring_kernel" \
        "<2, 16, true>(CUtensorMap, CUtensorMap)"
    run = fake_run({scan: (0.056, 56), "nvjet_bf16": (1.0, 900)})
    bound, _ = counts_hybrid.scan_bound(1, 16384, 8192, 16)
    assert read("b3_roofline.prefill", run) == pytest.approx(
        100 * bound * 56 / 0.056)
    assert read("mfu.prefill", run) == pytest.approx(
        100 * 6e14 / 2.0 / 989e12)
    assert read("idle_pct.prefill", run) == pytest.approx(5.0)
    assert read("b3_roofline.prefill", fake_run({"nvjet": (1.0, 3)})) \
        is None
    run.trace = None
    for name in ("b3_roofline.prefill", "mfu.prefill", "idle_pct.prefill"):
        assert read(name, run) is None


def test_the_reference_matches_the_port_in_float32():
    from repro_torch.models import lm
    from portbench import port
    drv = manifest.load_module("drivers", "prefill_hybrid")
    cell, conf, t = tiny()
    cfg = replace(drv.model_config(conf, cell.config, "pallas"),
                  param_dtype="float32", compute_dtype="float32")
    flat = seeded_hybrid.weights(conf, 7, "cpu", torch.float32)
    model = port.lm(cfg, flat, conf)
    tokens = torch.randint(0, conf["vocab_size"], (2, 40),
                           generator=torch.Generator().manual_seed(1))
    cache = lm.init_cache(cfg, 2, 48, "cpu")
    logits, cache = lm.prefill(model, cfg, tokens, cache,
                               impl="flash_pallas")
    seen = {}
    want = ref.prefill(flat, conf, tokens, Precision(),
                       kv=lambda i, k, v: seen.update({i: (k, v)}),
                       state=lambda i, h, c: seen.update({i: (h, c)}))
    tol = dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(logits[:, -1], want, **tol)
    assert sorted(seen) == list(range(8))
    for i, c in enumerate(cache):
        got = (c["k"][:, :40], c["v"][:, :40]) if i == 4 else \
            (c["h"], c["conv"])
        torch.testing.assert_close(got[0], seen[i][0], **tol)
        torch.testing.assert_close(got[1], seen[i][1], **tol)


def test_the_reference_takes_the_routes_it_is_handed():
    """Handed its own top-k, the reference computes its own bits; handed
    other experts, it takes them, with their probabilities as gates."""
    _, conf, _ = tiny()
    flat = seeded_hybrid.weights(conf, 9, "cpu", torch.float32)
    tokens = torch.randint(0, conf["vocab_size"], (1, 24),
                           generator=torch.Generator().manual_seed(3))
    own = ref.prefill(flat, conf, tokens, Precision())
    seen = []

    def same(j, probs, ids):
        seen.append(j)
        return ids

    assert torch.equal(ref.prefill(flat, conf, tokens, Precision(),
                                   route=same), own)
    assert seen == [1, 3, 5, 7]
    h = torch.randn(1, 24, 64, generator=torch.Generator().manual_seed(4))
    s = seeded_hybrid.dims(conf)
    last = ref.expert_layer(h, flat, "layers.1.ffn.", s, Precision(),
                            route=lambda probs, ids: ids.flip(-1))
    assert torch.equal(last, ref.expert_layer(h, flat, "layers.1.ffn.", s,
                                              Precision()))
    held0 = ref.expert_layer(h, flat, "layers.1.ffn.", s, Precision(),
                             route=lambda probs, ids: torch.zeros_like(ids))
    probs = torch.softmax(h.reshape(24, 64) @ flat["layers.1.ffn.router"],
                          dim=-1)
    y = ref.swiglu(h.reshape(24, 64), flat["layers.1.ffn.w_gate"][0],
                   flat["layers.1.ffn.w_up"][0],
                   flat["layers.1.ffn.w_down"][0], Precision())
    torch.testing.assert_close(held0.reshape(24, 64),
                               2 * probs[:, :1] * y, rtol=1e-5, atol=1e-6)


def test_the_reference_scans_in_blocks_as_step_by_step(monkeypatch):
    g = torch.Generator().manual_seed(2)
    x, dt = torch.randn(2, 37, 12, generator=g), \
        0.1 * torch.rand(2, 37, 12, generator=g)
    bm, cm = torch.randn(2, 37, 5, generator=g), \
        torch.randn(2, 37, 5, generator=g)
    a, d = -torch.rand(12, 5, generator=g) - 0.1, torch.randn(12, generator=g)
    whole = ref.scan(x, dt, bm, cm, a, d)
    monkeypatch.setattr(ref, "SCAN_BLOCK", 8)
    blocks = ref.scan(x, dt, bm, cm, a, d)
    for p, q in zip(whole, blocks):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-6)


def tiny_run(fault):
    cell, conf, traffic = tiny()
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(BENCH, cell, 2 ** 31 + 77, 0.5, True, time.time(),
                          torch.device("cpu"), conf=conf, traffic=traffic,
                          fault=fault, out=out, err=err)
    assert rc == 0, err.getvalue()
    lines = out.getvalue().strip().splitlines()
    counters = json.loads([ln for ln in lines if ln.startswith(
        "program counters")][0].split(": ", 1)[1])
    return json.loads(lines[-1]), counters


def test_a_sound_tiny_run_is_correct_and_counts_its_work(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    result, counters = tiny_run(None)
    assert result["correct"] is True, result["checks"]
    n = result["attempted"]
    assert counters["scan.plain"] == 7 * n          # the CPU's plain scan
    assert counters["mamba.CHUNKED_SCAN_CALLS"] == 0
    assert counters["moe.DROPPED_SLOTS"] == 0
    assert counters["moe.HELD_ROWS"] > 0
    assert counters["plain"] == n                   # one attention layer
    assert set(result["metrics"]) == {"mfu.prefill", "idle_pct.prefill",
                                      "enqueue_ms.prefill"}


def test_a_program_that_routes_off_the_top_k_fails_route_gap(monkeypatch):
    """The port routing every token to its two least likely experts: the
    reference follows the routes it is handed, and ``route_gap`` fails."""
    from repro_torch.models import moe
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    route = moe._route

    def lowest(params, xg, m, want_aux=True):
        gates, ids, aux = route(params, xg, m, want_aux)
        router = params["router"].to(xg.dtype).float()
        probs = torch.softmax(xg.float() @ router, dim=-1)
        g, i = torch.topk(probs, m.top_k, dim=-1, largest=False)
        return g, i, aux

    sound = tiny_run(None)[0]["checks"]["route_gap"]["value"]
    monkeypatch.setattr(moe, "_route", lowest)
    result, _ = tiny_run(None)
    check = result["checks"]["route_gap"]
    assert result["correct"] is False
    assert check["value"] > check["limit"]
    assert check["value"] >= 10 * sound


@pytest.mark.parametrize("fault,number", [
    ("state_unchanged", "state_err"), ("state_unchanged", "kv_err"),
    ("state_unchanged", "first_state_err"), ("answer_altered", "token_gap")])
def test_each_fault_fails_its_number_tenfold(fault, number, monkeypatch):
    """Past its limit, and ten times what a sound run reads or more."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    sound = tiny_run(None)[0]["checks"][number]["value"]
    result, _ = tiny_run(fault)
    check = result["checks"][number]
    assert result["correct"] is False
    assert check["value"] > check["limit"]
    assert check["value"] >= 10 * sound
