"""The port's training substrate -- schedules, compression, checkpoints,
the data pipeline and the runtime monitors -- held against the JAX
reference on the same inputs, and the port's mirror of
``tests/test_substrate.py``.

Tolerances: the schedules are the reference's float32 arithmetic, within
two float32 ulps of its values (numpy's and XLA's float32 ``cos`` round
apart, and ``0.45 * (1 + cos)`` carries an ulp of the sum); int8
compression and error feedback are exact; stochastic bf16 rounding draws
from a ``torch.Generator`` (not the reference's stream), so it is held to
its properties: every value one of the two bf16 neighbours of its input,
the mean unbiased to the reference test's 2e-4; checkpoints are equal
element for element and, file by file, byte for byte.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import load_pytree as ref_load
from repro.ckpt import save_pytree as ref_save
from repro.data import DataConfig as RefDataConfig
from repro.data import synthetic_source as ref_synthetic
from repro.optim import compress as ref_compress
from repro.optim import schedule as ref_schedule
from repro_torch.ckpt import (CheckpointManager, latest_checkpoint,
                              load_pytree, manifest_extra, save_pytree)
from repro_torch.data import (DataConfig, TokenPipeline, memmap_source,
                              synthetic_source)
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress_bf16, compress_int8,
                               cosine_schedule, decompress_int8,
                               error_feedback_update, linear_warmup_cosine)
from repro_torch.runtime import FailureInjector, Metrics, StragglerMonitor


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,args", [
    ("cosine", (100,)), ("cosine", (37, 0.0)),
    ("warmup", (10, 100)), ("warmup", (1, 30, 0.25)), ("warmup", (5, 5))])
def test_schedules_match_reference(kind, args):
    ref_f = {"cosine": ref_schedule.cosine_schedule,
             "warmup": ref_schedule.linear_warmup_cosine}[kind](*args)
    port_f = {"cosine": cosine_schedule,
              "warmup": linear_warmup_cosine}[kind](*args)
    steps = np.arange(0, 130)
    ref = np.asarray(jax.vmap(ref_f)(jnp.asarray(steps, jnp.int32)))
    port = np.asarray([port_f(int(s)) for s in steps], np.float32)
    assert all(isinstance(port_f(int(s)), float) for s in steps[:3])
    np.testing.assert_array_max_ulp(port, ref, maxulp=2)


def test_schedule_warmup_then_decay():
    f = linear_warmup_cosine(10, 100)
    assert f(0) < 0.11
    assert abs(f(10) - 1.0) < 0.01
    assert f(95) < 0.5


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def _grads(seed, n=4096, scale=1e-3):
    return np.random.default_rng(seed).normal(size=(n,)).astype(
        np.float32) * np.float32(scale)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_matches_reference_exactly(seed):
    x = _grads(seed)
    x[:7] = 0.0
    rq, rs = ref_compress.compress_int8(jnp.asarray(x))
    pq, ps = compress_int8(torch.from_numpy(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    assert np.array_equal(pq.numpy(), np.asarray(rq))
    assert ps.item() == float(rs)
    assert np.array_equal(decompress_int8(pq, ps).numpy(),
                          np.asarray(ref_compress.decompress_int8(rq, rs)))
    # an all-zero tensor: the 1e-12 floor on the scale
    zq, zs = compress_int8(torch.zeros(5))
    assert zs.item() == np.float32(1e-12) / np.float32(127.0)
    assert not zq.any()


def test_error_feedback_matches_reference_exactly():
    """64 rounds of error feedback on the same gradient stream."""
    rr = jnp.zeros(256, jnp.float32)
    pr = torch.zeros(256)
    for i in range(64):
        g = _grads(100 + i, n=256)
        rq, rs, rr = ref_compress.error_feedback_update(jnp.asarray(g), rr)
        pq, ps, pr = error_feedback_update(torch.from_numpy(g), pr)
        assert np.array_equal(pq.numpy(), np.asarray(rq)), i
        assert ps.item() == float(rs), i
        assert np.array_equal(pr.numpy(), np.asarray(rr)), i


def test_int8_error_feedback_converges():
    """EF residual keeps the long-run quantization bias near zero."""
    g = torch.from_numpy(_grads(0, n=256))
    resid = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    for _ in range(64):
        q, s, resid = error_feedback_update(g, resid)
        acc = acc + decompress_int8(q, s)
    np.testing.assert_allclose((acc / 64).numpy(), g.numpy(),
                               atol=float(g.abs().max()) * 0.05)


def _bf16_neighbours(x: np.ndarray):
    """(round-to-nearest bf16 of x, the next bf16 toward x), as float32."""
    lo = torch.from_numpy(x).to(torch.bfloat16)
    bits = lo.view(torch.int16).numpy().astype(np.int64) & 0xFFFF
    lo32 = lo.float().numpy()
    step = np.where((x > lo32) != (lo32 < 0), 1, -1)
    hi = ((bits + step) & 0xFFFF).astype(np.uint16).view(np.int16)
    return lo32, torch.from_numpy(hi).view(torch.bfloat16).float().numpy()


def test_bf16_stochastic_rounding_unbiased():
    """The reference's test: a value between bf16 grid points, rounded 8
    times, averages back to it."""
    x = {"g": torch.full((20000,), 1.0 + 2 ** -10)}
    gen = torch.Generator().manual_seed(0)
    total = np.zeros((20000,), np.float64)
    for _ in range(8):
        q = compress_bf16(x, gen)
        assert q["g"].dtype == torch.bfloat16
        total += q["g"].double().numpy()
    mean = total.mean() / 8
    assert abs(mean - (1.0 + 2 ** -10)) < 2e-4  # unbiased to ~1e-4


def test_bf16_stochastic_rounding_lands_on_neighbours():
    """Every output is one of its input's two bf16 neighbours (signs,
    exact grid values and zeros included), with the probability of the far
    one: the mean over draws against the reference's, on the same inputs;
    the same generator state gives the same draws."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(size=2000), -rng.normal(size=2000),
                        [0.0, 1.0, -2.5, 2 ** -20]]).astype(np.float32)
    lo, hi = _bf16_neighbours(x)
    outs = []
    for seed in range(16):
        out = compress_bf16({"a": {"b": torch.from_numpy(x)}},
                            torch.Generator().manual_seed(seed))["a"]["b"]
        out = out.float().numpy()
        assert np.all((out == lo) | (out == hi))
        outs.append(out)
    again = compress_bf16(torch.from_numpy(x),
                          torch.Generator().manual_seed(15))
    assert np.array_equal(again.float().numpy(), outs[-1])
    exact = lo == x
    assert all(np.array_equal(o[exact], x[exact]) for o in outs)
    ref = np.mean([np.asarray(ref_compress.compress_bf16(
        {"g": jnp.asarray(x)}, jax.random.key(s))["g"], np.float32)
        for s in range(16)], axis=0)
    port = np.mean(outs, axis=0)
    # both are unbiased estimates of x: over 4000 values, means agree
    assert abs(float(np.mean(port - x))) < 2e-4 * np.abs(x).mean()
    assert abs(float(np.mean(ref - x))) < 2e-4 * np.abs(x).mean()


# ---------------------------------------------------------------------------
# optimizer (the reference's substrate tests, on the port's AdamW)
# ---------------------------------------------------------------------------


def test_adamw_optimizes_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, m = adamw_update(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 1e-2
    assert state["step"] == 200


def test_adamw_clipping_bounds_update():
    cfg = AdamWConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0,
                      schedule=linear_warmup_cosine(2, 10))
    params = {"w": torch.zeros(3)}
    state = adamw_init(params)
    _, _, m = adamw_update(cfg, params, {"w": torch.full((3,), 1e6)}, state)
    assert float(m["grad_norm"]) > 1e5  # reported pre-clip
    assert m["lr"] == 0.5               # warmup step 1 of 2
    assert float(params["w"].abs().max()) <= 0.5 * (1 + 1e-6)


# ---------------------------------------------------------------------------
# checkpoints: the port's mirror, then across the packages
# ---------------------------------------------------------------------------


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 5), generator=g),
            "b": {"c": torch.arange(7, dtype=torch.int32)}}


def test_ckpt_roundtrip(tmp_path):
    t = _tree()
    save_pytree(t, tmp_path, 10, extra={"data_step": 10})
    path = latest_checkpoint(tmp_path)
    assert path is not None and path.name == "step_000000010"
    back = load_pytree(path, {"a": torch.empty(4, 5, device="meta"),
                              "b": {"c": np.zeros(7, np.int32)}})
    assert torch.equal(back["a"], t["a"])
    assert torch.equal(back["b"]["c"], t["b"]["c"])
    assert manifest_extra(path) == {"data_step": 10}
    whole = load_pytree(path)         # no like: the tree from the keys
    assert whole.keys() == {"a", "b"} and torch.equal(whole["a"], t["a"])


def test_ckpt_uncommitted_ignored(tmp_path):
    save_pytree(_tree(), tmp_path, 5)
    # fake a torn checkpoint at a later step (no COMMIT)
    bad = tmp_path / "step_000000009"
    bad.mkdir()
    (bad / "manifest.json").write_text("{}")
    assert latest_checkpoint(tmp_path).name == "step_000000005"
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp")]


def test_ckpt_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, every_steps=1, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(_tree(), s)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["step_000000003", "step_000000004"]
    tree, extra = mgr.restore_or_none()
    assert extra == {} and torch.equal(tree["a"], _tree()["a"])
    assert CheckpointManager(tmp_path / "none").restore_or_none() == \
        (None, None)


def test_ckpt_elastic_dtype_cast(tmp_path):
    save_pytree({"w": torch.ones(8)}, tmp_path, 1)
    like = {"w": torch.empty(8, dtype=torch.bfloat16, device="meta")}
    back = load_pytree(latest_checkpoint(tmp_path), like)
    assert back["w"].dtype == torch.bfloat16 and back["w"].device.type == "cpu"
    with pytest.raises(KeyError, match="missing leaf"):
        load_pytree(latest_checkpoint(tmp_path), {"x": torch.empty(1)})


def _state_pair():
    """The same training-state-shaped tree in both packages: float32,
    bfloat16 and int32 leaves, a tuple of blocks, an empty dict."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 4, 5)).astype(np.float32)
    e = rng.normal(size=(6, 4)).astype(np.float32)
    ref = {"params": {"blocks": ({"w": jnp.asarray(w), "ln": {}},
                                 {"w": jnp.asarray(w[:, :2])}),
                      "embed": jnp.asarray(e, jnp.bfloat16)},
           "opt": {"step": jnp.asarray(7, jnp.int32)}}
    port = {"params": {"blocks": [{"w": torch.from_numpy(w), "ln": {}},
                                  {"w": torch.from_numpy(w[:, :2].copy())}],
                       "embed": torch.from_numpy(e).to(torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    return ref, port


def test_port_reads_reference_checkpoint(tmp_path):
    ref, port = _state_pair()
    path = ref_save(ref, tmp_path, 3, extra={"data_step": 3})
    back = load_pytree(path)
    assert back["opt"]["step"].dtype == torch.int32
    assert int(back["opt"]["step"]) == 7
    assert back["params"]["embed"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["embed"], port["params"]["embed"])
    for b, p in zip(back["params"]["blocks"], port["params"]["blocks"]):
        assert torch.equal(b["w"], p["w"])
    assert manifest_extra(path) == {"data_step": 3}
    # into a like, cast: the bf16 leaf as float32, the blocks a tuple
    like = {"params": {"blocks": ({"w": np.zeros((3, 4, 5), np.float32)},
                                  {"w": np.zeros((3, 4, 2), np.float32)}),
                       "embed": torch.empty(6, 4, device="meta")},
            "opt": {"step": torch.empty((), dtype=torch.int64)}}
    cast = load_pytree(path, like)
    assert isinstance(cast["params"]["blocks"], tuple)
    assert cast["params"]["embed"].dtype == torch.float32
    assert torch.equal(cast["params"]["embed"],
                       port["params"]["embed"].float())
    assert cast["opt"]["step"].dtype == torch.int64


def test_reference_reads_port_checkpoint(tmp_path):
    """The port's files equal the reference's byte for byte (manifest keys
    and dtypes too); the reference's ``load_pytree`` reads the port's
    float32 and int32 leaves."""
    ref, port = _state_pair()
    rpath = ref_save(ref, tmp_path / "ref", 3)
    ppath = save_pytree(port, tmp_path / "port", 3)
    rman = (rpath / "manifest.json").read_text()
    pman = (ppath / "manifest.json").read_text()
    import json
    rindex, pindex = json.loads(rman)["index"], json.loads(pman)["index"]
    assert rindex == pindex
    for e in rindex:
        assert (rpath / e["file"]).read_bytes() == \
            (ppath / e["file"]).read_bytes(), e
    like = {"params": {"blocks": ref["params"]["blocks"]},
            "opt": ref["opt"]}
    back = ref_load(ppath, like)
    assert int(back["opt"]["step"]) == 7
    assert np.array_equal(np.asarray(back["params"]["blocks"][1]["w"]),
                          port["params"]["blocks"][1]["w"].numpy())


def test_reference_cannot_load_bf16_leaves(tmp_path):
    """ROADMAP.md, C9: the reference's ``load_pytree`` raises on a bfloat16
    leaf -- its own checkpoint's as the port's (``np.load`` gives a void
    array) -- while the port reads both."""
    ref, port = _state_pair()
    like = {"params": {"embed": ref["params"]["embed"]}}
    for path in (ref_save(ref, tmp_path / "ref", 1),
                 save_pytree(port, tmp_path / "port", 1)):
        with pytest.raises(TypeError, match="V2"):
            ref_load(path, like)
        assert torch.equal(load_pytree(path)["params"]["embed"],
                           port["params"]["embed"])


# ---------------------------------------------------------------------------
# data pipeline (a copy of the reference's module: the same batches)
# ---------------------------------------------------------------------------


def test_data_equals_reference_batches():
    for kw in (dict(seed=7), dict(seed=0, host_id=1, n_hosts=2)):
        port = synthetic_source(DataConfig(16, 4, 100, **kw))
        ref = ref_synthetic(RefDataConfig(16, 4, 100, **kw))
        for step in (0, 3, 11):
            for k in ("tokens", "labels"):
                assert np.array_equal(port(step)[k], ref(step)[k])


def test_data_deterministic_and_resumable():
    cfg = DataConfig(seq_len=16, global_batch=4, vocab_size=100, seed=7)
    src = synthetic_source(cfg)
    np.testing.assert_array_equal(src(3)["tokens"], src(3)["tokens"])
    assert not np.array_equal(src(3)["tokens"], src(4)["tokens"])
    full = src(0)
    np.testing.assert_array_equal(full["labels"][:, :-1],
                                  full["tokens"][:, 1:])
    pipe = TokenPipeline(cfg, src, start_step=5)
    first = next(pipe)
    np.testing.assert_array_equal(first["tokens"], src(5)["tokens"])
    assert pipe.state()["step"] == 6
    pipe.close()
    assert not pipe._thread.is_alive()


def test_data_host_sharding_differs():
    a = synthetic_source(DataConfig(16, 8, 100, host_id=0, n_hosts=2))(0)
    b = synthetic_source(DataConfig(16, 8, 100, host_id=1, n_hosts=2))(0)
    assert a["tokens"].shape == (4, 16)
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_memmap_source(tmp_path):
    toks = np.arange(1000, dtype=np.uint16)
    path = tmp_path / "tokens.bin"
    toks.tofile(path)
    cfg = DataConfig(seq_len=9, global_batch=2, vocab_size=50000)
    b0 = memmap_source(cfg, path)(0)
    assert b0["tokens"].shape == (2, 9)
    np.testing.assert_array_equal(b0["labels"][:, :-1], b0["tokens"][:, 1:])


# ---------------------------------------------------------------------------
# runtime monitors (a copy of the reference's module)
# ---------------------------------------------------------------------------


def test_straggler_monitor_flags_outlier():
    """Step times spread by 0.01 s, so the median absolute deviation is not
    the host clock's noise."""
    mon = StragglerMonitor(window=20, k=5.0, warmup=5)
    for i in range(10):
        assert not mon.observe(0.10 + 0.01 * (i % 3 - 1))
    assert mon.observe(1.0)       # 10x median -> flagged
    assert mon.flagged == [11]
    assert not mon.observe(0.10)


def test_failure_injector():
    inj = FailureInjector(fail_at_step=3)
    inj.check(2)
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        inj.check(3)
    inj.check(3)  # fires once


def test_metrics_csv():
    m = Metrics()
    m.log(0, loss=1.5)
    m.log(1, loss=1.25)
    csv = m.to_csv()
    assert csv.splitlines()[0] == "step,loss"
    assert "1.25" in csv
