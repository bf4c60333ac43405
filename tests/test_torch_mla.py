"""Multi-head latent attention (MLA, minicpm3-4b) in the port, held against
the JAX reference on the same inputs.

Parameters come from the reference's own init, carried across with
``convert``; activations and tokens are made with numpy from fixed seeds;
the reference runs jitted.  Smoke config (40 heads become 4; dn 16, dr 8,
dv 16: Dq = 24 != Dv = 16), ``compute_dtype="float32"``.  Tolerances:

* outputs and logits: atol 2e-4, rtol 1e-3 (the reference's own
  serve-consistency tolerance, ``tests/test_models.py``);
* the loss: rtol 1e-5; every gradient leaf within 1e-5 of that leaf's
  largest reference magnitude (as ``tests/test_torch_train.py``);
* bfloat16 blocks on the same bf16 input: RMS of the difference within
  2^-7 of the reference's RMS, the largest within 2^-6 of its largest
  (``tests/test_torch_lm.py``).

The kernel impl (``flash_pallas``) is held to the reference's
``impl="chunked"``, never to its Pallas kernel: that kernel returns NaN
at Dv != Dq (ROADMAP.md, C1).  On these CPU tensors the port's kernel
wrapper takes its plain version; the card tests
(``tests/test_torch_cuda.py``) hold the kernel itself.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.launch import steps as ref_steps
from repro.models import get_model as ref_get_model
from repro.models import layers as ref_layers
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.configs import get_config as port_config
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.convert import (lm_params_from_numpy,
                                 train_state_from_numpy, train_state_tree)
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import steps as port_steps
from repro_torch.models import get_model as port_get_model
from repro_torch.models import layers as port_layers
from repro_torch.models import lm as port_lm

ARCH = "minicpm3_4b"
TOL = dict(atol=2e-4, rtol=1e-3)
F32_LOSS_RTOL, F32_GRAD = 1e-5, 1e-5
REF_MLA = jax.jit(ref_layers.mla_block,
                  static_argnames=("cfg", "impl", "chunk"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(port, ref, **tol):
    np.testing.assert_allclose(_np(port), _np(ref), **(tol or TOL))


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_t(tree):
    return {k: _tree_t(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _configs(**over):
    return [replace(cfg, compute_dtype="float32", **over)
            for cfg in (ref_smoke(ARCH), port_smoke(ARCH))]


@functools.lru_cache(maxsize=None)
def _ref_params():
    rcfg, _ = _configs()
    params = jax.jit(ref_get_model(rcfg).init_params)(jax.random.key(0))
    return jax.tree.map(np.asarray, params)


def _models():
    rcfg, pcfg = _configs()
    params = _ref_params()
    return (rcfg, pcfg, jax.tree.map(jnp.asarray, params),
            lm_params_from_numpy(pcfg, params, device="cpu"))


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def block():
    cfg = ref_smoke(ARCH)
    params = ref_layers.init_mla(jax.random.key(3), cfg.attention,
                                 cfg.d_model, jnp.float32)
    x = np.random.default_rng(4).normal(
        size=(2, 16 + 4, cfg.d_model)).astype(np.float32)
    return cfg, params, _tree_t(params), x


def test_mla_block_without_cache_matches_reference(block):
    """dense and chunked (chunk 4: four key chunks) against the
    reference's; the kernel impl's CPU route (the plain flash version,
    called once) against the reference's chunked impl."""
    cfg, params, pp, x = block
    a = port_smoke(ARCH).attention
    xs, pos = x[:, :16], np.arange(16)[None, :]
    for impl in ("dense", "chunked"):
        ref, _ = REF_MLA(params, jnp.asarray(xs), cfg.attention,
                         positions=jnp.asarray(pos), impl=impl, chunk=4)
        port, none = port_layers.mla_block(pp, _t(xs), a, positions=_t(pos),
                                           impl=impl, chunk=4)
        assert none is None
        _close(port, ref)
    FA.reset_counts()
    port, _ = port_layers.mla_block(pp, _t(xs), a, positions=_t(pos),
                                    impl="flash_pallas")
    assert FA.PLAIN_CALLS["flash_attention"] == 1
    _close(port, ref)


def test_mla_block_with_cache_matches_reference(block):
    """Prefill (16 tokens, chunked on both sides) into a compressed cache,
    then 4 absorbed decode steps: outputs and both cache leaves."""
    cfg, params, pp, x = block
    a = port_smoke(ARCH).attention
    b, t, s = 2, 24, 16
    rc = {"c_kv": jnp.zeros((b, t, a.kv_lora_rank)),
          "k_rope": jnp.zeros((b, t, a.qk_rope_head_dim)),
          "pos": jnp.zeros((), jnp.int32)}
    pc = {"c_kv": torch.zeros((b, t, a.kv_lora_rank)),
          "k_rope": torch.zeros((b, t, a.qk_rope_head_dim)), "pos": 0}
    pos = np.arange(s)[None, :]
    ref, rc = REF_MLA(params, jnp.asarray(x[:, :s]), cfg.attention,
                      positions=jnp.asarray(pos), cache=rc)
    c_kv = pc["c_kv"]
    port, pc = port_layers.mla_block(pp, _t(x[:, :s]), a,
                                     positions=_t(pos), cache=pc)
    assert pc["c_kv"] is c_kv                  # updated in place
    _close(port, ref)
    for i in range(s, s + 4):
        ref, rc = REF_MLA(params, jnp.asarray(x[:, i:i + 1]), cfg.attention,
                          positions=jnp.full((1, 1), i), cache=rc)
        port, pc = port_layers.mla_block(pp, _t(x[:, i:i + 1]), a,
                                         positions=torch.full((1, 1), i),
                                         cache=pc)
        _close(port, ref)
        assert pc["pos"] == int(rc["pos"]) == i + 1
        _close(pc["c_kv"], rc["c_kv"])
        _close(pc["k_rope"], rc["k_rope"])


def _bf16_close(port, ref, what):
    a, b = _np(port), _np(ref)
    rms = lambda t: float(np.sqrt(np.mean(np.square(t))))  # noqa: E731
    d = a - b
    assert rms(d) <= 2.0 ** -7 * rms(b), (what, rms(d) / rms(b))
    assert np.abs(d).max() <= 2.0 ** -6 * np.abs(b).max(), what


def test_mla_block_bf16_matches_reference(block):
    """bfloat16 parameters and input: the chunked impl and the kernel
    impl's route against the reference's chunked impl."""
    cfg, params, pp, x = block
    a = port_smoke(ARCH).attention
    p16 = jax.tree.map(lambda v: v.astype(jnp.bfloat16), params)
    pt16 = {k: ({kk: vv.bfloat16() for kk, vv in v.items()}
                if isinstance(v, dict) else v.bfloat16())
            for k, v in pp.items()}
    xs = jnp.asarray(x[:, :16]).astype(jnp.bfloat16)
    xt = _t(x[:, :16]).bfloat16()
    pos = np.arange(16)[None, :]
    ref, _ = REF_MLA(p16, xs, cfg.attention, positions=jnp.asarray(pos),
                     impl="chunked", chunk=4)
    for impl in ("chunked", "flash_pallas"):
        out, _ = port_layers.mla_block(pt16, xt, a, positions=_t(pos),
                                       impl=impl, chunk=4)
        assert out.dtype == torch.bfloat16
        _bf16_close(out, ref, impl)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_minicpm3_smoke_matches_reference():
    """``Model.logits``; ``lm.forward`` on the kernel impl (the flash
    wrapper once per layer, against the reference's chunked logits);
    ``Model.prefill`` and ``lm.prefill(impl="flash_pallas")`` into the
    compressed caches, then 4 greedy absorbed decode steps."""
    rcfg, pcfg, params, port = _models()
    rm, pm = ref_get_model(rcfg), port_get_model(pcfg)
    toks = _tokens(rcfg, 2, 16)
    ref = rm.logits(params, {"tokens": jnp.asarray(toks)})
    out = pm.logits(port, {"tokens": toks})
    assert out.shape == (2, 16, rcfg.vocab_size)
    _close(out, ref)
    FA.reset_counts()
    with torch.no_grad():
        kern = port_lm.forward(port, pcfg, toks, impl="flash_pallas")
    assert FA.PLAIN_CALLS["flash_attention"] == pcfg.n_layers
    _close(kern, ref)
    ref_decode = jax.jit(rm.decode_step)
    rc = rm.init_cache(2, 24)
    ref, rc = rm.prefill(params, {"tokens": jnp.asarray(toks)}, rc)
    out, pc = pm.prefill(port, {"tokens": toks},
                         pm.init_cache(2, 24, device="cpu"))
    _close(out, ref)
    kern, _ = port_lm.prefill(port, pcfg, toks,
                              pm.init_cache(2, 24, device="cpu"),
                              impl="flash_pallas")
    _close(kern, ref)
    for _ in range(4):
        rt = np.asarray(jnp.argmax(ref[:, -1], -1))[:, None]
        pt = out[:, -1].argmax(-1)[:, None]
        assert np.array_equal(pt.numpy(), rt)
        ref, rc = ref_decode(params, jnp.asarray(rt), rc)
        out, pc = pm.decode_step(port, pt, pc)
        _close(out, ref)
    for name in ("c_kv", "k_rope"):
        for i, layer_cache in enumerate(pc):
            _close(layer_cache[name], rc[0][name][i])


def test_absorbed_decode_matches_expanded_forward():
    """The port alone: teacher-forced absorbed decode steps give the
    logits of the expanded (training-form) forward over the same
    sequence, position by position."""
    _, pcfg, _, port = _models()
    pm = port_get_model(pcfg)
    toks = _tokens(pcfg, 2, 20, seed=5)
    with torch.no_grad():
        full = port_lm.forward(port, pcfg, toks)
    out, cache = pm.prefill(port, {"tokens": toks[:, :12]},
                            pm.init_cache(2, 20, device="cpu"))
    _close(out[:, 0], full[:, 11])
    for i in range(12, 20):
        out, cache = pm.decode_step(port, toks[:, i:i + 1], cache)
        _close(out[:, 0], full[:, i])


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads():
    rcfg, _ = _configs()
    f = jax.jit(jax.value_and_grad(ref_steps.make_loss_fn(rcfg),
                                   has_aux=True))
    (total, m), g = f(jax.tree.map(jnp.asarray, _ref_params()),
                      {k: jnp.asarray(v) for k, v in _batch(rcfg).items()})
    return float(total), float(m["loss"]), jax.tree.map(np.asarray, g)


def _batch(cfg, b=2, s=32, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_minicpm3_loss_and_grads_match_reference(remat):
    """Every gradient leaf, including all nine MLA leaves, in the
    reference's layout (``convert.train_state_tree``)."""
    r_total, r_loss, r_grads = _ref_loss_and_grads()
    _, pcfg = _configs()
    params = _ref_params()
    opt = jax.tree.map(np.asarray, ref_adamw_init(params))
    model, _ = train_state_from_numpy(pcfg, params, opt, device="cpu")
    total, m = port_steps.make_loss_fn(pcfg, remat=remat)(model,
                                                          _batch(pcfg))
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(total,
                                                list(named.values()))))
    tree = train_state_tree(model, {"step": 0, "m": grads, "v": grads})
    np.testing.assert_allclose(float(total.detach()), r_total,
                               rtol=F32_LOSS_RTOL)
    np.testing.assert_allclose(float(m["loss"].detach()), r_loss,
                               rtol=F32_LOSS_RTOL)
    leaves = jax.tree_util.tree_flatten_with_path(r_grads)[0]
    mla = set()
    for path, r in leaves:
        node = tree["opt"]["m"]
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        key = jax.tree_util.keystr(path)
        if "['mix']" in key:
            mla.add(path[3].key)
        np.testing.assert_allclose(node.numpy(), r, rtol=0,
                                   atol=F32_GRAD * np.abs(r).max(),
                                   err_msg=key)
    assert mla == {"wdq", "q_norm", "wuq", "wdkv", "kv_norm", "wkr", "wuk",
                   "wuv", "wo"}


def test_mla_cache_is_compressed():
    """The port of ``tests/test_models.py::test_mla_cache_is_compressed``
    at minicpm3-4b's full size, on the meta device (no storage): each
    layer caches ``c_kv`` (kv_lora_rank) and ``k_rope``
    (qk_rope_head_dim) per token, independent of the head count, in the
    reference's shapes."""
    cfg = port_config(ARCH)
    cache = port_get_model(cfg).init_cache(1, 1024, device="meta")
    a = cfg.attention
    assert len(cache) == cfg.n_layers
    assert all(set(c) == {"c_kv", "k_rope", "pos"} for c in cache)
    assert cache[0]["c_kv"].shape == (1, 1024, a.kv_lora_rank)
    assert cache[0]["k_rope"].shape == (1, 1024, a.qk_rope_head_dim)
    ref = jax.eval_shape(lambda: ref_get_model(ref_config(ARCH)).init_cache(
        1, 1024))
    assert cache[0]["c_kv"].dtype == torch.bfloat16
    assert str(ref[0]["c_kv"].dtype) == "bfloat16"
    leaf_bytes = sum(t.numel() * t.element_size() for c in cache
                     for t in (c["c_kv"], c["k_rope"]))
    ref_bytes = sum(int(np.prod(l.shape)) * l.dtype.itemsize
                    for l in jax.tree.leaves(ref)
                    if l.shape[-1] in (a.kv_lora_rank, a.qk_rope_head_dim))
    assert leaf_bytes == ref_bytes
    per_token = (a.kv_lora_rank + a.qk_rope_head_dim) * 2      # bf16
    assert leaf_bytes == cfg.n_layers * 1024 * per_token
    gqa_equiv = cfg.n_layers * 1024 * a.n_heads * a.head_dim * 2 * 2
    assert leaf_bytes < gqa_equiv / 15                         # >15x smaller
