"""The port's LM stack (``repro_torch.models``), held against the JAX
reference on the same inputs.

Parameters come from the reference's own init (``jax.random``), carried
across as numpy with ``convert.lm_params_from_numpy``; activations and
tokens are made with numpy from fixed seeds.  Smoke configs, with
``compute_dtype="float32"``.  Tolerance: atol 2e-4, rtol 1e-3, the
reference's own serve-consistency tolerance (``tests/test_models.py``),
unless a test states another.  Where the reference runs a Pallas kernel,
it runs in interpret mode, as its own tests run it; the port's kernel
wrappers take their plain versions on these CPU tensors.

MoE configs are compared at a raised capacity (``capacity_factor=8``, no
token dropped): at the configs' own capacity the reference mis-routes one
token whenever a token is dropped (ROADMAP.md, C5) — that fault has its
own test below, and at the configs' capacity the port is held to an
explicit per-token dispatch instead.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm as ref_lm
from repro.configs import get_smoke_config as ref_smoke
from repro.models import get_model as ref_get_model
from repro.models import layers as ref_layers
from repro.models import mamba as ref_mamba
from repro.models import moe as ref_moe
from repro.models.config import MoEConfig, SSMConfig
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import selective_scan as SS
from repro_torch.models import get_model as port_get_model
from repro_torch.models import layers as port_layers
from repro_torch.models import lm as port_lm
from repro_torch.models import mamba as port_mamba
from repro_torch.models import moe as port_moe

TOL = dict(atol=2e-4, rtol=1e-3)
# the reference's functions under jit: one compile per call signature
# instead of one per eagerly dispatched op (the configs are static)
REF_ATTN = jax.jit(ref_layers.attention_block,
                   static_argnames=("cfg", "impl", "chunk"))
REF_MAMBA = jax.jit(ref_mamba.mamba_block, static_argnames=("cfg", "impl"))
REF_MOE = jax.jit(ref_moe.moe_block, static_argnames=("cfg", "group"))
REF_MLP = jax.jit(ref_layers.mlp_block, static_argnames=("activation",))
KERNEL_IMPLS = dict(attention_impl="flash_pallas", ssm_impl="pallas")
REF_KERNEL_IMPLS = dict(attention_impl="flash_pallas_interpret",
                        ssm_impl="pallas_interpret")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(
        x, torch.Tensor) else x.detach().float().numpy()


def _close(port, ref, **tol):
    np.testing.assert_allclose(_np(port), _np(ref), **(tol or TOL))


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_t(tree):
    """A reference parameter dict (jax arrays) as torch tensors."""
    return {k: _tree_t(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _configs(arch, **over):
    """(reference config, port config): float32 compute, MoE at ample
    capacity (see the module docstring), plus ``over``."""
    ref, port = ref_smoke(arch), port_smoke(arch)
    assert ref == port or vars(ref).keys() == vars(port).keys()
    out = []
    for cfg in (ref, port):
        cfg = replace(cfg, compute_dtype="float32", **over)
        if cfg.moe is not None:
            cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=8.0))
        out.append(cfg)
    return out


def _models(arch, seed=0, **over):
    rcfg, pcfg = _configs(arch, **over)
    params = jax.jit(ref_get_model(rcfg).init_params)(jax.random.key(seed))
    port = lm_params_from_numpy(pcfg, jax.tree.map(np.asarray, params),
                                device="cpu")
    return rcfg, pcfg, params, port


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


# ---------------------------------------------------------------------------
# norms, RoPE, attention cores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_norms_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    scale = rng.normal(size=(48,)).astype(np.float32)
    bias = rng.normal(size=(48,)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = _t(x).to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    tol = TOL if dtype == np.float32 else dict(atol=2e-2, rtol=2e-2)
    for kind, params in (("rmsnorm", {"scale": scale}),
                         ("layernorm", {"scale": scale, "bias": bias}),
                         ("nonparametric_ln", {})):
        ref = ref_layers.norm(kind, xj, {k: jnp.asarray(v)
                                         for k, v in params.items()})
        port = port_layers.norm(kind, xt, {k: _t(v)
                                           for k, v in params.items()})
        assert port.dtype == xt.dtype
        _close(port, np.asarray(ref, np.float32), **tol)


def test_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(5, 12)[None, :]
    ref = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    port = port_layers.apply_rope(_t(x), _t(pos), 10_000.0)
    _close(port, ref)


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 0, 0), (False, 0, 0), (True, 24, 0), (True, 0, 3)])
def test_attention_cores_match_reference(causal, window, q_offset):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)      # GQA
    v = rng.normal(size=(2, 64, 2, 8)).astype(np.float32)       # Dv != Dq
    args = dict(causal=causal, window=window, q_offset=q_offset)
    for name in ("dense_attention", "chunked_attention"):
        extra = {"chunk": 16} if name == "chunked_attention" else {}
        ref = getattr(ref_layers, name)(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), **args, **extra)
        port = getattr(port_layers, name)(_t(q), _t(k), _t(v), **args,
                                          **extra)
        _close(port, ref)


# ---------------------------------------------------------------------------
# attention block: no cache, prefill + decode, SWA ring buffer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,prefill,max_len", [
    ("h2o_danube3_4b", 40, 32),     # SWA window 16: prefill wraps the ring
    ("h2o_danube3_4b", 12, 32),     # prefill shorter than the ring
    ("olmo_1b", 12, 24)])           # full attention, plain buffer
def test_attention_block_matches_reference(arch, prefill, max_len):
    cfg = ref_smoke(arch).attention
    pcfg = port_smoke(arch).attention
    d = ref_smoke(arch).d_model
    params = ref_layers.init_attention(jax.random.key(3), cfg, d,
                                       jnp.float32)
    pp = _tree_t(params)
    rng = np.random.default_rng(4)
    b, steps = 2, 4
    x = rng.normal(size=(b, prefill + steps, d)).astype(np.float32)
    pos = np.arange(prefill)[None, :]
    # no cache: the plain impls (the kernel impl is held to the reference
    # through the whole-model tests and tests/test_torch_kernels.py)
    for impl in ("dense", "chunked"):
        ref, _ = REF_ATTN(
            params, jnp.asarray(x[:, :prefill]), cfg,
            positions=jnp.asarray(pos), impl=impl, chunk=4)
        port, none = port_layers.attention_block(
            pp, _t(x[:, :prefill]), pcfg, positions=_t(pos), impl=impl,
            chunk=4)
        assert none is None
        _close(port, ref)
    # prefill into a cache, then decode steps (the ring wraps for SWA)
    t = max_len if cfg.window == 0 else min(max_len, 128)
    rc = {"k": jnp.zeros((b, t, cfg.n_kv_heads, cfg.head_dim)),
          "v": jnp.zeros((b, t, cfg.n_kv_heads, cfg.head_dim)),
          "kpos": jnp.full((t,), -1, jnp.int32), "pos": jnp.zeros((),
                                                                  jnp.int32)}
    pc = {"k": torch.zeros((b, t, pcfg.n_kv_heads, pcfg.head_dim)),
          "v": torch.zeros((b, t, pcfg.n_kv_heads, pcfg.head_dim)),
          "kpos": torch.full((t,), -1, dtype=torch.int32), "pos": 0}
    ref, rc = REF_ATTN(params, jnp.asarray(x[:, :prefill]),
                                         cfg, positions=jnp.asarray(pos),
                                         cache=rc)
    port, pc = port_layers.attention_block(pp, _t(x[:, :prefill]), pcfg,
                                           positions=_t(pos), cache=pc)
    _close(port, ref)
    for i in range(prefill, prefill + steps):
        ref, rc = REF_ATTN(
            params, jnp.asarray(x[:, i:i + 1]), cfg,
            positions=jnp.full((1, 1), i), cache=rc)
        port, pc = port_layers.attention_block(
            pp, _t(x[:, i:i + 1]), pcfg, positions=torch.full((1, 1), i),
            cache=pc)
        _close(port, ref)
        assert pc["pos"] == int(rc["pos"]) == i + 1
        assert np.array_equal(pc["kpos"].numpy(), np.asarray(rc["kpos"]))
        _close(pc["k"], rc["k"])


# ---------------------------------------------------------------------------
# mamba block: kernel path, chunked scan with and without a cache, decode
# ---------------------------------------------------------------------------


def test_mamba_block_branches_match_reference():
    cfg = SSMConfig(d_state=4, d_conv=4, expand=2, chunk=8)
    d, b, s = 8, 2, 21                   # ragged: 21 = 2 chunks of 8 + 5
    params = ref_mamba.init_mamba(jax.random.key(0), cfg, d, jnp.float32)
    pp = _tree_t(params)
    x = np.random.default_rng(5).normal(size=(b, s + 3, d)).astype(
        np.float32) * 0.5
    xs = x[:, :s]
    # full pass: chunked scan and the kernel path
    ref, _ = REF_MAMBA(params, jnp.asarray(xs), cfg)
    for impl in ("chunked_scan", "pallas"):
        SS.reset_counts()
        port, none = port_mamba.mamba_block(pp, _t(xs), cfg, impl=impl)
        assert none is None
        assert SS.PLAIN_CALLS["selective_scan"] == (impl == "pallas")
        _close(port, ref)
    ref_k, _ = REF_MAMBA(params, jnp.asarray(xs), cfg,
                                     impl="pallas_interpret")
    _close(port, ref_k)
    # prefill with a cache (chunked scan even for impl="pallas"), then
    # three decode steps
    rc = ref_mamba.init_mamba_cache(cfg, d, b, jnp.float32)
    pc = port_mamba.init_mamba_cache(cfg, d, b, torch.float32, "cpu")
    ref, rc = REF_MAMBA(params, jnp.asarray(xs), cfg, cache=rc)
    SS.reset_counts()
    port, pc = port_mamba.mamba_block(pp, _t(xs), cfg, cache=pc,
                                      impl="pallas")
    assert SS.PLAIN_CALLS["selective_scan"] == 0
    _close(port, ref)
    _close(pc["h"], rc["h"])
    _close(pc["conv"], rc["conv"])
    for i in range(s, s + 3):
        ref, rc = REF_MAMBA(params, jnp.asarray(x[:, i:i + 1]),
                                        cfg, cache=rc)
        port, pc = port_mamba.mamba_block(pp, _t(x[:, i:i + 1]), cfg,
                                          cache=pc)
        _close(port, ref)
        _close(pc["h"], rc["h"])


# ---------------------------------------------------------------------------
# MoE block
# ---------------------------------------------------------------------------


def _moe_case(seed, n_experts=4, top_k=2, d=16, d_expert=24, tokens=64,
              capacity_factor=8.0, n_shared=0):
    cfg = MoEConfig(n_experts=n_experts, top_k=top_k, d_expert=d_expert,
                    capacity_factor=capacity_factor,
                    n_shared_experts=n_shared)
    params = ref_moe.init_moe(jax.random.key(seed), cfg, d, jnp.float32)
    x = np.random.default_rng(seed).normal(size=(1, tokens, d)).astype(
        np.float32)
    return cfg, params, x


def _explicit_dispatch(params, x, cfg):
    """Per-token top-k MoE in numpy: slot by slot, tokens in order, each
    expert takes at most ``capacity`` (token, slot) pairs; a kept pair adds
    gate x expert(token); a dropped one adds nothing."""
    p = {k: np.asarray(v, np.float64) for k, v in params.items()
         if k != "shared"}
    xt = x.reshape(-1, x.shape[-1]).astype(np.float64)
    logits = xt @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ids = np.argsort(-probs, axis=-1, kind="stable")[:, :cfg.top_k]
    gates = np.take_along_axis(probs, ids, -1)
    gates /= np.maximum(gates.sum(-1, keepdims=True), 1e-9)
    cap = port_moe.capacity(cfg, xt.shape[0])
    silu = lambda a: a / (1 + np.exp(-a))  # noqa: E731
    out = np.zeros_like(xt)
    used = np.zeros(cfg.n_experts, int)
    kept = np.zeros(ids.shape, bool)
    for slot in range(cfg.top_k):
        for t in range(xt.shape[0]):
            e = ids[t, slot]
            if used[e] < cap:
                kept[t, slot] = True
                h = silu(xt[t] @ p["w_gate"][e]) * (xt[t] @ p["w_up"][e])
                out[t] += gates[t, slot] * (h @ p["w_down"][e])
            used[e] += 1
    return out.reshape(x.shape), ids, kept


def test_moe_block_matches_reference_at_ample_capacity():
    """Two groups of 32 tokens, a shared expert beside the routed ones."""
    cfg, params, x = _moe_case(7, n_shared=1)
    ref, ref_aux = REF_MOE(params, jnp.asarray(x), cfg, group=32)
    port, port_aux = port_moe.moe_block(_tree_t(params), _t(x), cfg,
                                        group=32)
    _close(port, ref)
    _close(port_aux, ref_aux)
    # top-k ids and their order: torch.topk(sorted=True) as jax.lax.top_k
    probs = np.random.default_rng(0).random((3, 5, 6)).astype(np.float32)
    _, ref_ids = jax.lax.top_k(jnp.asarray(probs), 3)
    _, port_ids = torch.topk(_t(probs), 3, sorted=True)
    assert np.array_equal(port_ids.numpy(), np.asarray(ref_ids))


@pytest.mark.parametrize("capacity_factor", [0.5, 0.25, 1.25])
def test_moe_block_matches_explicit_dispatch_when_dropping(capacity_factor):
    cfg, params, x = _moe_case(11, capacity_factor=capacity_factor)
    want, _, kept = _explicit_dispatch(params, x, cfg)
    if capacity_factor < 1:
        assert not kept.all()          # tokens really are dropped
    port, _ = port_moe.moe_block(_tree_t(params), _t(x), cfg)
    _close(port, want)


def test_reference_moe_misroutes_expert0_slot0_when_dropping():
    """ROADMAP C5: in the reference, a dropped (token, slot) scatters the
    table's old value to flat index 0, the entry of the first token routed
    to expert 0 (capacity slot 0).  On the CPU that stale write wins, so
    exactly that token differs from the explicit dispatch; the port
    matches the dispatch everywhere."""
    cfg, params, x = _moe_case(3, capacity_factor=0.5)
    want, ids, kept = _explicit_dispatch(params, x, cfg)
    first_e0 = int(np.flatnonzero(ids[:, 0] == 0)[0])
    assert first_e0 != 0 and not kept[:, 0].all()   # the fault's conditions
    ref = np.asarray(REF_MOE(params, jnp.asarray(x), cfg)[0])[0]
    port = port_moe.moe_block(_tree_t(params), _t(x), cfg)[0].numpy()[0]
    _close(port, want[0])
    others = np.arange(x.shape[1]) != first_e0
    _close(ref[others], want[0][others])
    assert np.abs(ref[first_e0] - want[0][first_e0]).max() > 1e-2


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jamba():
    return _models("jamba_v01_52b")


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_jamba_forward_matches_reference(jamba, kernels):
    """Both impl pairs: chunked/chunked_scan, and the kernel path
    (flash_pallas/pallas), whose reference runs the Pallas kernels in
    interpret mode; the port's wrappers ran their plain versions (CPU) —
    once for the attention layer, seven times for the mamba layers."""
    rcfg, pcfg, params, port = jamba
    if kernels:
        rcfg = replace(rcfg, **REF_KERNEL_IMPLS)
        pcfg = replace(pcfg, **KERNEL_IMPLS)
    toks = _tokens(rcfg, 2, 16)
    ref, ref_aux = ref_lm.forward_with_aux(params, rcfg, jnp.asarray(toks))
    FA.reset_counts()
    SS.reset_counts()
    out, aux = port_lm.forward_with_aux(port, pcfg, toks)
    assert FA.PLAIN_CALLS["flash_attention"] == int(kernels)
    assert SS.PLAIN_CALLS["selective_scan"] == 7 * int(kernels)
    _close(out, ref)
    _close(aux, ref_aux)


def _bf16_close(port, ref, what):
    """bf16 outputs of the same module on the same bf16 input: RMS of the
    difference within 2^-7 of the reference's RMS (one unit in the last
    place of bf16, relative), the largest within 2^-6 of its largest."""
    a, b = _np(port), _np(ref)
    rms = lambda t: float(np.sqrt(np.mean(np.square(t))))  # noqa: E731
    d = a - b
    assert rms(d) <= 2.0 ** -7 * rms(b), (what, rms(d) / rms(b))
    assert np.abs(d).max() <= 2.0 ** -6 * np.abs(b).max(), (
        what, np.abs(d).max() / np.abs(b).max())


def test_jamba_bf16_modules_match_reference(jamba):
    """The serving dtype, module by module: every mixer of jamba's smoke
    stack (attention with both impls, mamba with both impls) and every MoE
    block runs in bfloat16 in both packages on the same bf16 input -- the
    reference's own activations at that layer, with the layer's parameters
    cast as ``cast_tree`` casts them.  The cache branches are held to the
    reference in float32 by the tests above.

    Whole-model bf16 logits are not compared: each package rounds its bf16
    ops at different points (XLA fuses elementwise chains in float32), and
    the MoE router turns such differences into a different expert for a
    few tokens, which the next layers spread; the reference's own two impl
    pairs differ in bf16 by as much as bf16 differs from float32."""
    rcfg, pcfg, params, port = jamba
    rcfg = replace(rcfg, compute_dtype="bfloat16")
    pcfg = replace(pcfg, compute_dtype="bfloat16")
    b, s = 2, 64
    toks = _tokens(rcfg, b, s)
    P = ref_lm.pattern_period(rcfg)
    kinds, moes = rcfg.layer_kinds(), rcfg.moe_layers()
    x = ref_lm._embed(params, rcfg, jnp.asarray(toks), None, jnp.bfloat16)
    rpos, ppos = jnp.arange(s)[None], torch.arange(s)[None]
    t16 = lambda a: _t(a.astype(jnp.float32)).bfloat16()  # noqa: E731
    layers = list(port_lm._layers(port, torch.bfloat16))
    for i, (layer, plp) in enumerate(layers):
        rep, pos = divmod(i, P)
        rlp = ref_lm.cast_tree(jax.tree.map(lambda a: a[rep],
                                            params["blocks"][pos]),
                               jnp.bfloat16)
        h = ref_layers.norm(rcfg.norm, x, rlp["ln1"])
        if kinds[i] == "attn":
            impls = (("chunked", "chunked"),
                     ("flash_pallas_interpret", "flash_pallas"))

            def mix(lib, lp, hh, impl):
                if lib == "ref":
                    return REF_ATTN(lp["mix"], hh, rcfg.attention,
                                    positions=rpos, impl=impl)
                return port_layers.attention_block(
                    lp["mix"], hh, pcfg.attention, positions=ppos,
                    impl=impl)
        else:
            impls = (("chunked_scan", "chunked_scan"),
                     ("pallas_interpret", "pallas"))

            def mix(lib, lp, hh, impl):
                if lib == "ref":
                    return REF_MAMBA(lp["mix"], hh, rcfg.ssm, impl=impl)
                return port_mamba.mamba_block(lp["mix"], hh, pcfg.ssm,
                                              impl=impl)
        for rimpl, pimpl in impls:
            ref = mix("ref", rlp, h, rimpl)[0]
            out = mix("port", plp, t16(h), pimpl)[0]
            assert out.dtype == torch.bfloat16
            _bf16_close(out, ref, (i, pimpl))
            if rimpl == impls[0][0]:
                mixed = ref                  # the plain impl
        # the rest of the reference's _layer_apply, for the next layer
        x = x + mixed
        h2 = ref_layers.norm(rcfg.norm, x, rlp["ln2"])
        if moes[i]:
            ff = REF_MOE(rlp["ffn"], h2, rcfg.moe)[0]
            out = port_moe.moe_block(plp["ffn"], t16(h2), pcfg.moe)[0]
            _bf16_close(out, ff, (i, "moe"))
        else:
            ff = REF_MLP(rlp["ffn"], h2, activation=rcfg.activation)
        x = x + ff


def test_jamba_prefill_and_decode_match_reference(jamba):
    """``lm.prefill`` (with the kernel impl, as the serving path calls it)
    and 4 greedy decode steps: logits and tokens."""
    rcfg, pcfg, params, port = jamba
    rm, pm = ref_get_model(rcfg), port_get_model(pcfg)
    ref_decode = jax.jit(rm.decode_step)      # one trace for the 4 steps
    toks = _tokens(rcfg, 2, 12)
    rc, pc = rm.init_cache(2, 20), pm.init_cache(2, 20, device="cpu")
    ref, rc = ref_lm.prefill(params, rcfg, jnp.asarray(toks), rc,
                             impl="flash_pallas_interpret")
    out, pc = port_lm.prefill(port, pcfg, toks, pc, impl="flash_pallas")
    _close(out, ref)
    for _ in range(4):
        rt = np.asarray(jnp.argmax(ref[:, -1], -1))[:, None]
        pt = out[:, -1].argmax(-1)[:, None]
        assert np.array_equal(pt.numpy(), rt)
        ref, rc = ref_decode(params, jnp.asarray(rt), rc)
        out, pc = pm.decode_step(port, pt, pc)
        _close(out, ref)


SMOKE_ARCHS = ["olmo_1b", "falcon_mamba_7b", "h2o_danube3_4b",
               "deepseek_moe_16b", "mistral_large_123b", "phi3_vision_4b"]


def _smoke_batch(cfg, b, s):
    """Tokens, and for a VLM the precomputed patch embeddings."""
    batch = {"tokens": _tokens(cfg, b, s)}
    if cfg.n_patches:
        batch["patches"] = np.random.default_rng(2).normal(
            size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_smoke_forward_matches_reference(arch):
    """Through ``Model.logits``, then ``Model.prefill`` and 3 greedy
    ``Model.decode_step``s.  olmo-1b: non-parametric LayerNorm, tied
    embeddings; falcon-mamba: mamba-only layers without an FFN;
    h2o-danube3: sliding-window attention (window 16: the decode steps
    mask the oldest keys);
    deepseek-moe: shared + routed experts (capacity 8, C5); mistral-large:
    bfloat16 masters, GQA 8/2; phi3-vision: patch embeddings prepended."""
    rcfg, pcfg, params, port = _models(arch)
    b, s = 2, 16
    batch = _smoke_batch(rcfg, b, s)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rm, pm = ref_get_model(rcfg), port_get_model(pcfg)
    ref = rm.logits(params, jb)
    out = pm.logits(port, batch)
    total = s + rcfg.n_patches
    assert out.shape == (b, total, rcfg.vocab_size)
    _close(out, ref)
    assert torch.equal(port(batch["tokens"], batch.get("patches")), out)
    ref_decode = jax.jit(rm.decode_step)      # one trace for the 3 steps
    rc, pc = rm.init_cache(b, total + 4), pm.init_cache(b, total + 4,
                                                          device="cpu")
    ref, rc = rm.prefill(params, jb, rc)
    out, pc = pm.prefill(port, batch, pc)
    _close(out, ref)
    for _ in range(3):
        rt = np.asarray(jnp.argmax(ref[:, -1], -1))[:, None]
        pt = out[:, -1].argmax(-1)[:, None]
        assert np.array_equal(pt.numpy(), rt)
        ref, rc = ref_decode(params, jnp.asarray(rt), rc)
        out, pc = pm.decode_step(port, pt, pc)
        _close(out, ref)


def test_cast_tree_keeps_float32_leaves(jamba):
    _, pcfg, _, port = jamba
    cast = port_lm.cast_tree(port.layers[1].tree(), torch.bfloat16)
    assert cast["mix"]["in_proj"].dtype == torch.bfloat16
    assert cast["ffn"]["w_gate"].dtype == torch.bfloat16
    for name in ("A_log", "D", "dt_bias"):
        assert cast["mix"][name].dtype == torch.float32
    assert cast["ffn"]["router"].dtype == torch.float32
    same = port_lm.cast_tree(port.layers[1].tree(), torch.float32)
    assert same["mix"]["in_proj"] is port.layers[1].mix.in_proj
