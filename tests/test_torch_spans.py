"""The port's spans (``repro_torch.runtime.spans``) on the CPU: how many of
each a prefill and a train step open, how they nest, that the recompute
of a checkpointed group shows as ``layer`` spans inside ``backward``, that
a profiled pass computes the same bits as an unprofiled one, and that no
profiler means no span."""

import contextlib
import functools
from collections import Counter
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.runtime import spans

PORT = "repro_torch."
B, S = 8, 16                     # B divides jamba's 8 microbatches
ARCHS = ("olmo-1b", "phi3-vision-4b", "jamba-v0.1-52b", "falcon-mamba-7b",
         "jamba2-mini")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(arch):
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=8.0))
    if arch == "jamba2-mini":     # the scan's kernel route (its plain
        cfg = replace(cfg, ssm_impl="pallas")   # version here), held experts
        cfg = replace(cfg, moe=replace(cfg.moe, held_experts=(0, 1)))
    return cfg


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.n_patches:
        batch["patches"] = torch.from_numpy(rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32))
    return batch


def _spans(prof):
    """(name without the prefix, start, end) of every port span the
    profiler recorded on the host, in order of start."""
    out = [(e.name()[len(PORT):], e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(PORT)
           and str(e.device_type()).endswith("CPU")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _outermost(found, s):
    """The outermost port span open at ``s``'s start (``s`` itself where
    none encloses it)."""
    for o in found:
        if o[1] <= s[1] and s[2] <= o[2]:
            return o[0]
    return s[0]


def _keyed(found):
    return Counter((_outermost(found, s), s[0]) for s in found)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _prefill(cfg, traced):
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _inputs(cfg)
    cache = lm.init_cache(cfg, B, S + cfg.n_patches + 4, "cpu")

    def run():
        return lm.prefill(params, cfg, batch["tokens"], cache,
                          patches=batch.get("patches"))

    return _profiled(run) if traced else (run(), None)


def _train_step(cfg, traced, remat=True):
    params, opt_state = steps.init_train_state(
        cfg, torch.Generator().manual_seed(0))
    step = steps.make_train_step(cfg, remat=remat)

    def run():
        step(params, opt_state, _inputs(cfg))
        return {n: p.detach().clone() for n, p in params.named_parameters()}

    return _profiled(run) if traced else (run(), None)


@functools.lru_cache(maxsize=None)
def _prefill_spans(arch):
    return _prefill(_config(arch), True)[1]


@functools.lru_cache(maxsize=None)
def _step_spans(arch, remat):
    return _train_step(_config(arch), True, remat)[1]


def _per_pass(cfg):
    """Spans of one pass through the layers: name -> count."""
    kinds, moes = cfg.layer_kinds(), cfg.moe_layers()
    n_ffn = sum(m or cfg.d_ff > 0 for m in moes)
    n_moe = sum(moes)
    scans = cfg.ssm_impl in ("pallas", "pallas_interpret")
    return {"layer": cfg.n_layers,
            "norm": cfg.n_layers + n_ffn,
            "attention": kinds.count("attn"), "mamba": kinds.count("mamba"),
            "scan": kinds.count("mamba") if scans else 0,
            "mlp": n_ffn - n_moe, "moe": n_moe, "route": n_moe,
            "experts": n_moe}


def _prefill_counts(cfg):
    want = {("prefill", n): k for n, k in _per_pass(cfg).items()}
    want[("prefill", "norm")] += 1                        # the final norm
    want.update({("prefill", "prefill"): 1, ("prefill", "embed"): 1,
                 ("prefill", "cast"): cfg.n_layers,
                 ("prefill", "unembed"): 1})
    return {k: v for k, v in want.items() if v}


def _step_counts(cfg, remat):
    micro = max(1, cfg.train_microbatches)
    want = {("forward", n): micro * k for n, k in _per_pass(cfg).items()}
    want[("forward", "norm")] += micro
    want.update({("forward", "forward"): micro, ("forward", "loss"): micro,
                 ("forward", "embed"): micro, ("forward", "unembed"): micro,
                 ("forward", "cast"): micro * cfg.n_layers,
                 ("backward", "backward"): micro,
                 ("optimizer", "optimizer"): 1})
    if remat:
        want.update({("backward", n): micro * k
                     for n, k in _per_pass(cfg).items()})
    return {k: v for k, v in want.items() if v}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_opens_each_span_as_often_as_it_runs(arch):
    cfg = _config(arch)
    assert _keyed(_prefill_spans(arch)) == _prefill_counts(cfg)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_opens_each_span_as_often_as_it_runs(arch, remat):
    cfg = _config(arch)
    assert _keyed(_step_spans(arch, remat)) == _step_counts(cfg, remat)


@pytest.mark.parametrize("arch", ["olmo-1b", "jamba-v0.1-52b"])
def test_recompute_shows_as_layers_inside_backward(arch):
    """With remat, the backward runs every layer again (L a microbatch);
    without it, none."""
    cfg = _config(arch)
    micro = max(1, cfg.train_microbatches)
    for remat, want in ((True, micro * cfg.n_layers), (False, 0)):
        keyed = _keyed(_step_spans(arch, remat))
        assert keyed[("backward", "layer")] == want


@pytest.mark.parametrize("traced", ["prefill", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_parts_of_a_layer_lie_inside_a_layer(arch, traced):
    found = (_prefill_spans(arch) if traced == "prefill"
             else _step_spans(arch, True))
    layers = [s for s in found if s[0] == "layer"]
    parts = [s for s in found if s[0] in
             ("attention", "mamba", "mlp", "moe", "norm", "scan", "route",
              "experts")]
    final = 1 if traced == "prefill" else _config(arch).train_microbatches
    inside = [s for s in parts
              if any(l[1] <= s[1] and s[2] <= l[2] for l in layers)]
    # every part but the final norms lies inside a layer span
    assert len(parts) - len(inside) == max(1, final)
    assert all(s[0] == "norm" for s in parts if s not in inside)


@pytest.mark.parametrize("arch", ["olmo-1b", "phi3-vision-4b"])
def test_prefill_is_bit_identical_under_the_profiler(arch):
    cfg = _config(arch)
    (plain, plain_cache), _ = _prefill(cfg, False)
    (traced, traced_cache), _ = _prefill(cfg, True)
    assert torch.equal(plain, traced)
    for a, b in zip(plain_cache, traced_cache):
        for k in a:
            if torch.is_tensor(a[k]):
                assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("arch", ["olmo-1b", "jamba-v0.1-52b"])
def test_train_step_is_bit_identical_under_the_profiler(arch):
    cfg = _config(arch)
    plain, _ = _train_step(cfg, False)
    traced, _ = _train_step(cfg, True)
    assert plain.keys() == traced.keys()
    for n in plain:
        assert torch.equal(plain[n], traced[n]), n


def test_no_profiler_no_span():
    off = spans.span("repro_torch.layer")
    assert isinstance(off, contextlib.nullcontext)
    assert spans.span("repro_torch.norm") is off
    with off:
        with spans.span("repro_torch.mlp"):     # the shared one nests
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = spans.span("repro_torch.layer")
    assert isinstance(on, torch._C._profiler._RecordFunctionFast)
    assert spans.span("repro_torch.layer") is off


def test_a_span_is_an_operator_not_a_user_annotation():
    """The profiler copies a user annotation onto the device's timeline,
    as one more device event; a span is an operator's range, with no copy
    there."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("repro_torch.layer"):
            torch.ones(4).sum()
    found = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "repro_torch.layer"]
    assert len(found) == 1 and not found[0].is_user_annotation()


def test_spanned_asks_for_the_profiler_at_each_call():
    @spans.spanned("repro_torch.layer")
    def double(x):
        """Twice x."""
        return 2 * x

    assert double.__name__ == "double" and double.__doc__ == "Twice x."
    assert double(3) == 6
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        double(torch.ones(2))
        double(torch.ones(2))
    assert [e.name for e in prof.events()].count("repro_torch.layer") == 2


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("annotated", [True, False])
def test_the_smokes_kernel_table_leaves_out_the_port_spans(annotated):
    """``chip_smoke.profile_call``'s table: a port span is listed apart
    with its calls, host time and the device time launched inside it, and
    an entry of its name on the device's timeline (a user annotation's
    copy, marked as one or not) is no kernel."""
    from types import SimpleNamespace

    def evt(key, device, us, count=1, host_us=0.0, inside_us=0.0, ua=False):
        return SimpleNamespace(key=key, device_type=f"DeviceType.{device}",
                               self_device_time_total=us, count=count,
                               cpu_time_total=host_us,
                               device_time_total=inside_us,
                               is_user_annotation=ua)

    averages = [
        evt("repro_torch.layer", "CPU", 0.0, count=2, host_us=900.0,
            inside_us=650.0),
        evt("repro_torch.attention", "CPU", 0.0, count=2, host_us=400.0,
            inside_us=350.0),
        evt("repro_torch.attention", "CUDA", 380.0, count=2, ua=annotated),
        evt("aten::mm", "CPU", 0.0, host_us=80.0, inside_us=300.0),
        evt("sm90_xmma_gemm_bf16", "CUDA", 300.0, count=4),
        evt("Memcpy DtoD (Device -> Device)", "CUDA", 50.0),
        evt("idle_kernel", "CUDA", 0.0),
    ]
    kernels, found = _chip_smoke().kernels_and_spans(averages)
    assert kernels == {"sm90_xmma_gemm_bf16": 300.0,
                       "Memcpy DtoD (Device -> Device)": 50.0}
    assert found == {"repro_torch.layer": [2, 900.0, 650.0],
                     "repro_torch.attention": [2, 400.0, 350.0]}


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "jamba2-mini"])
def test_scan_route_and_experts_lie_inside_their_blocks(arch):
    """``scan`` inside ``mamba`` (the kernel route only), ``route`` and
    ``experts`` inside ``moe``, once each per block."""
    found = _prefill_spans(arch)
    for part, block in (("scan", "mamba"), ("route", "moe"),
                        ("experts", "moe")):
        parts = [s for s in found if s[0] == part]
        blocks = [s for s in found if s[0] == block]
        assert all(sum(b[1] <= s[1] and s[2] <= b[2] for b in blocks) == 1
                   for s in parts)
        assert len(parts) == (len(blocks) if part != "scan" or
                              _config(arch).ssm_impl == "pallas" else 0)


def test_no_span_name_holds_what_the_benchmark_matches():
    """The benchmark's readers match "copy" and "flash_attention" in
    device ops' names: no port span may hold either."""
    names = {s[0] for arch in ARCHS for s in _prefill_spans(arch)}
    names |= {s[0] for arch in ARCHS for s in _step_spans(arch, True)}
    assert {"scan", "route", "experts"} <= names
    assert not [n for n in names if "copy" in n or "flash_attention" in n]
