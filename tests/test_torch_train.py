"""The port's training path (``repro_torch.launch``, autograd through
``models.lm``), held against the JAX reference on the same inputs.

Parameters and optimizer state come from the reference's own init, carried
across as numpy (``convert.train_state_from_numpy``); batches are made with
numpy from fixed seeds; the reference runs jitted, one compile per config
and batch shape.  Smoke configs; MoE at ``capacity_factor=8`` (ROADMAP.md,
C5); phi3-vision's batches carry patch embeddings.  Tolerances:

* float32 compute: the loss within rtol 1e-5, every gradient leaf within
  1e-5 of that leaf's largest reference magnitude; with bfloat16 masters
  (mistral-large) the gradients are bfloat16 in both packages, and each
  element is held within one bf16 ulp of itself plus that limit;
* bfloat16 compute (each package rounds to bf16 at other points; XLA
  fuses elementwise chains in float32): the loss within 2^-8 relative,
  every gradient leaf's difference within 2^-4 of the leaf's RMS (RMS)
  and 2^-3 of its largest magnitude (max).  jamba's MoE router turns such
  differences into other experts for tokens near a tie (the forward tests
  of ``tests/test_torch_lm.py`` say so): the reference's own bf16
  gradients lie 5-50% (RMS, leaf by leaf) from its float32 ones.  So jamba
  in bf16 is held by parity instead: over the leaves, the port's bf16
  gradients' distance from the float32 reference's (RMS over the leaf's
  RMS) is on average, and at its largest, within 1.25x the reference's
  own bf16 gradients' distance.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.launch import steps as ref_steps
from repro.launch.train import train_loop as ref_train_loop
from repro.models import get_model as ref_get_model
from repro.optim import AdamWConfig as RefAdamW
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.ckpt import latest_checkpoint
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.convert import (load_train_state, train_state_from_numpy,
                                 train_state_tree)
from repro_torch.launch import steps as port_steps
from repro_torch.launch.train import main as port_main
from repro_torch.launch.train import train_loop as port_train_loop
from repro_torch.models import lm as port_lm
from repro_torch.optim import AdamWConfig

ARCHS = ["olmo_1b", "olmoe_1b_7b", "falcon_mamba_7b", "jamba_v01_52b",
         "h2o_danube3_4b", "deepseek_moe_16b", "mistral_large_123b",
         "phi3_vision_4b"]
F32_LOSS_RTOL, F32_GRAD = 1e-5, 1e-5
BF16_LOSS_RTOL, BF16_RMS, BF16_MAX = 2.0 ** -8, 2.0 ** -4, 2.0 ** -3
BF16_PARITY = 1.25
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def quiet(*a, **k):
    pass


def _configs(arch, compute_dtype="float32", **over):
    out = []
    for cfg in (ref_smoke(arch), port_smoke(arch)):
        cfg = replace(cfg, compute_dtype=compute_dtype, **over)
        if cfg.moe is not None:
            cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=8.0))
        out.append(cfg)
    return out


def _batch(cfg, b=B, s=S, seed=1):
    """Tokens and next-token labels; a VLM's batch also carries its patch
    embeddings (the loss drops the patch prefix)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.n_patches:
        batch["patches"] = rng.normal(
            size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    rcfg, _ = _configs(arch)
    params = jax.jit(ref_get_model(rcfg).init_params)(jax.random.key(0))
    return jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads(arch, compute_dtype):
    """The reference's (loss + aux, loss, gradients) on ``_batch``, one
    jit per config."""
    rcfg, _ = _configs(arch, compute_dtype)
    f = jax.jit(jax.value_and_grad(ref_steps.make_loss_fn(rcfg),
                                   has_aux=True))
    (total, m), g = f(jax.tree.map(jnp.asarray, _ref_params(arch)),
                      {k: jnp.asarray(v) for k, v in _batch(rcfg).items()})
    return float(total), float(m["loss"]), jax.tree.map(np.asarray, g)


def _port_state(arch, pcfg):
    params = _ref_params(arch)
    opt = jax.tree.map(np.asarray, ref_adamw_init(params))
    return train_state_from_numpy(pcfg, params, opt, device="cpu")


def _port_loss_and_grads(arch, compute_dtype, remat=True, **over):
    _, pcfg = _configs(arch, compute_dtype, **over)
    model, _ = _port_state(arch, pcfg)
    total, m = port_steps.make_loss_fn(pcfg, remat=remat)(model,
                                                          _batch(pcfg))
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(total, list(named.values()))
    # the gradients in the reference's layout (stacked by pattern position)
    flat = dict(zip(named, grads))
    tree = train_state_tree(model, {"step": 0, "m": flat, "v": flat})
    return (float(total.detach()), float(m["loss"].detach()),
            tree["opt"]["m"], flat)


def _leaves(ref_tree, port_tree):
    """(path, reference leaf, port leaf) over the reference's leaves."""
    for path, r in jax.tree_util.tree_flatten_with_path(ref_tree)[0]:
        node = port_tree
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        yield jax.tree_util.keystr(path), np.asarray(r, np.float32), \
            node.float().numpy()


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _bf16_ulp(a):
    """One bfloat16 unit in the last place at |a| (8 significant bits),
    element by element; the smallest normal's at 0."""
    mag = np.maximum(np.abs(a).astype(np.float64), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


# ---------------------------------------------------------------------------
# the loss and every gradient
# ---------------------------------------------------------------------------


REMAT = {"on": {}, "off": {}, "group2": {"remat_group": 2}}
# remat_group 2 needs two pattern-period repeats: jamba's 8 smoke layers
# are one period
CASES = [(arch, dtype, remat) for arch in ARCHS
         for dtype in ("float32", "bfloat16") for remat in REMAT
         if not (remat == "group2" and arch == "jamba_v01_52b")]


@pytest.mark.parametrize("arch,compute_dtype,remat", CASES)
def test_loss_and_grads_match_reference(arch, compute_dtype, remat):
    """Every gradient leaf with remat on (checkpointed groups), off, and at
    ``remat_group`` 2 where the config's repeats allow it."""
    over = REMAT[remat]
    r_total, r_loss, r_grads = _ref_loss_and_grads(arch, compute_dtype)
    p_total, p_loss, p_grads, _ = _port_loss_and_grads(
        arch, compute_dtype, remat=remat != "off", **over)
    leaves = list(_leaves(r_grads, p_grads))
    assert len(leaves) == len(jax.tree.leaves(r_grads))
    if compute_dtype == "float32":
        np.testing.assert_allclose(p_total, r_total, rtol=F32_LOSS_RTOL)
        np.testing.assert_allclose(p_loss, r_loss, rtol=F32_LOSS_RTOL)
        bf16_masters = ref_smoke(arch).param_dtype == "bfloat16"
        for key, r, p in leaves:
            if bf16_masters:
                # mistral-large: bfloat16 masters give bfloat16 gradients
                # in both packages.  Each element within one bf16 ulp of
                # itself (the two casts of the float32 sums) plus the
                # float32 limit (those sums' own difference: an element
                # that cancels to near zero is many of its ulps off)
                lim = (_bf16_ulp(np.maximum(np.abs(p), np.abs(r)))
                       + F32_GRAD * np.abs(r).max())
                assert (np.abs(p - r) <= lim).all(), (
                    key, float((np.abs(p - r) / lim).max()))
                continue
            np.testing.assert_allclose(p, r, rtol=0,
                                       atol=F32_GRAD * np.abs(r).max(),
                                       err_msg=key)
        return
    np.testing.assert_allclose(p_total, r_total, rtol=BF16_LOSS_RTOL)
    if arch == "jamba_v01_52b":
        _, _, f32 = _ref_loss_and_grads(arch, "float32")
        dist = np.asarray([(_rms(p - f) / _rms(f), _rms(r - f) / _rms(f))
                           for (_, r, p), (_, f, _) in zip(
                               leaves, _leaves(f32, p_grads))])
        port, ref = dist.mean(axis=0)
        assert port <= BF16_PARITY * ref, (port, ref)
        port, ref = dist.max(axis=0)
        assert port <= BF16_PARITY * ref, (port, ref)
        return
    for key, r, p in leaves:
        assert _rms(p - r) <= BF16_RMS * _rms(r), (key, _rms(p - r) / _rms(r))
        assert np.abs(p - r).max() <= BF16_MAX * np.abs(r).max(), key


@pytest.mark.parametrize("arch", ["olmo_1b", "jamba_v01_52b"])
def test_remat_changes_no_gradient_bit(arch):
    """Recomputing a checkpointed group reproduces its forward exactly, so
    remat on and off give the same gradients bit for bit (on the CPU)."""
    on = _port_loss_and_grads(arch, "float32", remat=True)[3]
    off = _port_loss_and_grads(arch, "float32", remat=False)[3]
    assert on.keys() == off.keys()
    for name in on:
        assert torch.equal(on[name], off[name]), name


def test_grad_to_compute_dtype_casts_the_cotangent():
    x = torch.ones(3, dtype=torch.bfloat16, requires_grad=True)
    y = port_lm._grad_to_compute_dtype(x)
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad(y.float().sum() * 3.0, x)
    assert g.dtype == torch.bfloat16
    z = torch.ones(2)
    assert port_lm._grad_to_compute_dtype(z) is z    # nothing to record


def test_forward_records_only_when_a_gradient_is_wanted():
    _, pcfg = _configs("olmo_1b")
    model, _ = _port_state("olmo_1b", pcfg)
    toks = _batch(pcfg)["tokens"]
    assert port_lm.forward(model, pcfg, toks).requires_grad
    with torch.no_grad():
        out = port_lm.forward(model, pcfg, toks)
    assert not out.requires_grad and out.is_inference()
    model.requires_grad_(False)
    assert port_lm.forward(model, pcfg, toks).is_inference()


# ---------------------------------------------------------------------------
# train steps: clip, schedule, AdamW; microbatches
# ---------------------------------------------------------------------------


SCHED_STEPS = 10


def _opt_configs():
    from repro.optim import linear_warmup_cosine as ref_sched
    from repro_torch.optim import linear_warmup_cosine as port_sched
    return (RefAdamW(lr=1e-2, schedule=ref_sched(2, SCHED_STEPS)),
            AdamWConfig(lr=1e-2, schedule=port_sched(2, SCHED_STEPS)))


def _run_steps(arch, n_steps, **over):
    """n_steps of both packages' train_step from the same state on the same
    batches; returns (reference state, its metrics, port state, its
    metrics), the states in the reference's layout."""
    rcfg, pcfg = _configs(arch, **over)
    ropt, popt = _opt_configs()
    rstep = jax.jit(ref_steps.make_train_step(rcfg, ropt))
    pstep = port_steps.make_train_step(pcfg, popt)
    params = jax.tree.map(jnp.asarray, _ref_params(arch))
    opt = ref_adamw_init(params)
    model, state = _port_state(arch, pcfg)
    rms_, pms = [], []
    for i in range(n_steps):
        batch = _batch(rcfg, b=4, seed=10 + i)
        params, opt, rm = rstep(params, opt,
                                {k: jnp.asarray(v) for k, v in batch.items()})
        model, state, pm = pstep(model, state, batch)
        rms_.append({k: float(v) for k, v in rm.items()})
        pms.append({k: float(v) for k, v in pm.items()})
    ref = {"params": params, "opt": opt}
    return ref, rms_, train_state_tree(model, state), pms


def _close_states(arch, ref, port, lr_sum, n_steps=1):
    """Moments within the gradients' tolerance times the steps (``m`` and
    ``v`` are sums of g and g² terms, each step's gradient taken at
    parameters that differ as below; ``v``, quadratic in g, within twice
    that).  Parameters: every element within 2·Σ lr of the
    reference's -- Adam divides m by sqrt(v), so an element whose gradient
    is near zero may step the other way, by at most lr a step -- and each
    leaf's RMS difference within 1e-3 of the RMS of its update (the
    update's elements are ~lr each)."""
    init = _ref_params(arch)
    for part, scale in (("m", 1), ("v", 2)):
        for key, r, p in _leaves(ref["opt"][part], port["opt"][part]):
            np.testing.assert_allclose(p, r, rtol=0,
                                       atol=scale * F32_GRAD * n_steps
                                       * np.abs(r).max(),
                                       err_msg=f"{part} {key}")
    for (key, r, p), (_, r0, _) in zip(
            _leaves(ref["params"], port["params"]),
            _leaves(init, port["params"])):
        assert np.abs(p - r).max() <= 2 * lr_sum, key
        assert _rms(p - r) <= 1e-3 * _rms(r - r0), (key, _rms(p - r),
                                                    _rms(r - r0))
    assert int(port["opt"]["step"]) == int(ref["opt"]["step"])


@pytest.mark.parametrize("n_steps", [1, 5])
def test_train_steps_match_reference(n_steps):
    """olmo-1b in float32: clipping (the smoke model's gradient norm is
    above 1), the warmup + cosine schedule and AdamW, one step then five."""
    ref, rm, port, pm = _run_steps("olmo_1b", n_steps)
    for r, p in zip(rm, pm):
        np.testing.assert_allclose(p["loss"], r["loss"], rtol=F32_LOSS_RTOL)
        np.testing.assert_allclose(p["grad_norm"], r["grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(p["lr"], r["lr"], rtol=1e-6)
    assert rm[0]["grad_norm"] > 1.0       # the clip is active
    _close_states("olmo_1b", ref, port, sum(r["lr"] for r in rm), n_steps)


def test_train_microbatches_match_reference_scan():
    """``train_microbatches=2``: the port's loop against the reference's
    scan (float32 accumulators, mean loss, last microbatch's metrics)."""
    ref, rm, port, pm = _run_steps("olmo_1b", 1, train_microbatches=2)
    for key in ("loss", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(pm[0][key], rm[0][key], rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    _close_states("olmo_1b", ref, port, rm[0]["lr"])


# ---------------------------------------------------------------------------
# checkpoints across the packages: a reference run resumes in the port
# ---------------------------------------------------------------------------


def test_reference_run_resumes_in_the_port(tmp_path):
    """The reference trains 8 steps (checkpoints at 4 and 8); the port
    restores the step-4 checkpoint and runs steps 4-7, on the reference's
    loss curve: float32, same data pipeline (a copy), same schedule."""
    rcfg, pcfg = _configs("olmo_1b")
    kw = dict(steps=8, batch=4, seq=32, ckpt_every=4, print_fn=quiet)
    _, ref_m = ref_train_loop(rcfg, ckpt_dir=str(tmp_path / "ref"), **kw)
    (tmp_path / "port").mkdir()
    (tmp_path / "ref" / "step_000000004").rename(
        tmp_path / "port" / "step_000000004")
    lines = []
    _, port_m = port_train_loop(pcfg, ckpt_dir=str(tmp_path / "port"),
                                device="cpu",
                                **dict(kw, print_fn=lines.append))
    assert lines[0].startswith("[resume] restored step 4")
    assert [r["step"] for r in port_m.rows] == [4, 5, 6, 7]
    for r, p in zip(ref_m.rows[4:], port_m.rows):
        np.testing.assert_allclose(p["loss"], r["loss"], rtol=1e-4)
        np.testing.assert_allclose(p["lr"], r["lr"], rtol=1e-6)
    # the port's final checkpoint is the reference's layout: the reference
    # restores it (float32 leaves), and so does the port's reader
    final = latest_checkpoint(tmp_path / "port")
    assert final.name == "step_000000008"
    from repro.ckpt import load_pytree as ref_load
    from repro.launch.steps import init_train_state as ref_init
    like = dict(zip(("params", "opt"), ref_init(rcfg, jax.random.key(1))))
    back = ref_load(final, like)
    model, state = load_train_state(pcfg, final, device="cpu")
    assert state["step"] == int(back["opt"]["step"]) == 8
    for key, r, p in _leaves(back["params"],
                             train_state_tree(model, state)["params"]):
        assert np.array_equal(r, p), key


# ---------------------------------------------------------------------------
# the port's mirror of tests/test_train_e2e.py
# ---------------------------------------------------------------------------


def test_train_loss_decreases():
    cfg = port_smoke("olmo_1b")
    _, metrics = port_train_loop(cfg, steps=30, batch=8, seq=64,
                                 ckpt_dir=None, print_fn=quiet, device="cpu")
    losses = [r["loss"] for r in metrics.rows]
    assert losses[-1] < losses[0] - 0.3


def test_crash_resume_is_exact(tmp_path):
    """Run A: 16 steps uninterrupted.  Run B: crash at step 12 (after the
    step-8 checkpoint), restart, finish.  On the CPU the resumed run is
    the uninterrupted one bit for bit."""
    cfg = port_smoke("olmo_1b")
    kw = dict(steps=16, batch=4, seq=32, ckpt_every=8, print_fn=quiet,
              device="cpu")
    params_a, m_a = port_train_loop(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    with pytest.raises(RuntimeError, match="injected failure"):
        port_train_loop(cfg, ckpt_dir=str(tmp_path / "b"), fail_at_step=12,
                        **kw)
    params_b, m_b = port_train_loop(cfg, ckpt_dir=str(tmp_path / "b"), **kw)
    assert [r["step"] for r in m_b.rows] == list(range(8, 16))
    assert m_a.rows[8:] == m_b.rows
    for (name, a), (_, b) in zip(params_a.named_parameters(),
                                 params_b.named_parameters()):
        assert torch.equal(a, b), name


def test_moe_arch_trains():
    cfg = port_smoke("olmoe_1b_7b")
    _, metrics = port_train_loop(cfg, steps=16, batch=4, seq=32,
                                 ckpt_dir=None, print_fn=quiet, device="cpu")
    losses = [r["loss"] for r in metrics.rows]
    assert losses[-1] < losses[0]


def test_ssm_arch_trains():
    cfg = port_smoke("falcon_mamba_7b")
    _, metrics = port_train_loop(cfg, steps=40, batch=4, seq=32,
                                 ckpt_dir=None, lr=1e-3, print_fn=quiet,
                                 device="cpu")  # SSM needs warmup
    losses = [r["loss"] for r in metrics.rows]
    assert losses[-1] < losses[0] - 0.5


def test_hybrid_arch_trains_with_its_microbatches():
    """jamba's smoke config keeps its 8 microbatches."""
    cfg = port_smoke("jamba_v01_52b")
    assert cfg.train_microbatches == 8
    _, metrics = port_train_loop(cfg, steps=6, batch=8, seq=16,
                                 ckpt_dir=None, lr=1e-3, print_fn=quiet,
                                 device="cpu")
    losses = [r["loss"] for r in metrics.rows]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    rc = port_main(["--arch", "olmo-1b", "--smoke", "--steps", "3",
                    "--batch", "2", "--seq", "16", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "first loss" in out
    assert latest_checkpoint(tmp_path).name == "step_000000003"


def test_train_defaults_to_cuda_and_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_smoke("olmo_1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train_loop(cfg, steps=1, batch=2, seq=8, print_fn=quiet)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main(["--arch", "olmo-1b", "--smoke", "--steps", "1"])
    # the dry run needs no card: meta tensors, the step an int32 scalar
    params, opt = port_steps.abstract_train_state(cfg)
    leaves = jax.tree.leaves((params, opt))
    assert leaves and all(t.is_meta for t in leaves)
    assert opt["step"].dtype == torch.int32 and opt["step"].shape == ()
