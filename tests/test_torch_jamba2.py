"""AI21-Jamba2-Mini's path through the port on the CPU, against the plain
float32 reference ``plain_jamba.py`` on seeded weights, at a small size
of one period (8 layers, attention at 4, experts at the odd layers, 4
experts of which 2 are held): the forward, a prefill and decode steps
through the cache, the expert shares against the whole layer, dropless
dispatch under forced imbalance, the scan's state under a cache, the
un-renormalised gates; and the configurations that keep the defaults
computing the bits they computed before these options existed."""

import hashlib
from dataclasses import replace

import numpy as np
import pytest
import torch

import plain_jamba as ref
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import selective_scan as SS
from repro_torch.models import lm, mamba, moe

HELD = (0, 1)
PROMPT, STEPS = 12, 4
TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes,
    and the pinned digests below were taken with one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(held=HELD, ssm_impl="chunked_scan"):
    cfg = get_smoke_config("jamba2-mini")
    return replace(cfg, ssm_impl=ssm_impl,
                   moe=replace(cfg.moe, held_experts=held))


def _params(cfg, seed=0):
    """The port's initial weights with every gain and bias moved off its
    initial value, so that each one shows in the output."""
    params = lm.init_params(cfg, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in params.named_parameters():
            if p.dim() == 1:
                p.add_(0.3 * torch.randn(p.shape, generator=g))
    return params


def _detached(t):
    if isinstance(t, dict):
        return {k: _detached(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_detached(v) for v in t]
    return t.detach()


def _tokens(cfg, b, s, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))


def _reference(cfg, params, tokens, states=None):
    tree = {"embed": params.embed, "unembed": params.unembed,
            "final_norm": params.final_norm.tree(),
            "layers": [layer.tree() for layer in params.layers]}
    with torch.no_grad():
        return ref.forward(_detached(tree), ref.spec_of(cfg), tokens,
                           states)


def test_the_config_loads_by_name_and_stays_out_of_the_arch_list():
    cfg = get_config("jamba2-mini")
    assert "jamba2_mini" not in ARCH_IDS
    assert cfg.layer_kinds().count("attn") == 4
    assert [i for i, k in enumerate(cfg.layer_kinds()) if k == "attn"] == \
        [4, 12, 20, 28]
    assert cfg.moe_layers() == [i % 2 == 1 for i in range(32)]
    assert not cfg.attention.rope and cfg.ssm.inner_norms
    assert cfg.moe.dropless and not cfg.moe.renormalize
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert,
            cfg.ssm.dt_rank) == (16, 2, 14336, 256)


@pytest.mark.parametrize("ssm_impl", ["chunked_scan", "pallas"])
def test_forward_matches_the_reference(ssm_impl):
    cfg = _config(ssm_impl=ssm_impl)
    params = _params(cfg)
    toks = _tokens(cfg, 2, PROMPT + STEPS)
    with torch.no_grad():
        got = lm.forward(params, cfg, toks)
    torch.testing.assert_close(got, _reference(cfg, params, toks), **TOL)


@pytest.mark.parametrize("ssm_impl,impl", [("chunked_scan", "chunked"),
                                           ("pallas", "flash_pallas")])
def test_prefill_then_decode_matches_the_full_forward(ssm_impl, impl):
    """Prefill 12 tokens into the cache, then 4 greedy-free decode steps
    of the reference's own next tokens: each step's logits equal the
    reference's full forward at that position."""
    cfg = _config(ssm_impl=ssm_impl)
    params = _params(cfg)
    toks = _tokens(cfg, 2, PROMPT + STEPS)
    want = _reference(cfg, params, toks)
    mamba.CHUNKED_SCAN_CALLS = 0
    cache = lm.init_cache(cfg, 2, PROMPT + STEPS, "cpu")
    logits, cache = lm.prefill(params, cfg, toks[:, :PROMPT], cache,
                               impl=impl)
    torch.testing.assert_close(logits[:, -1], want[:, PROMPT - 1], **TOL)
    for t in range(PROMPT, PROMPT + STEPS):
        logits, cache = lm.decode_step(params, cfg, toks[:, t:t + 1], cache)
        torch.testing.assert_close(logits[:, 0], want[:, t], **TOL)
    n_mamba = cfg.layer_kinds().count("mamba")
    assert mamba.CHUNKED_SCAN_CALLS == (n_mamba if ssm_impl ==
                                        "chunked_scan" else 0)


def test_the_prefill_leaves_the_states_the_reference_ends_with():
    cfg = _config(ssm_impl="pallas")
    params = _params(cfg)
    toks = _tokens(cfg, 2, PROMPT)
    states = []
    _reference(cfg, params, toks, states)
    cache = lm.init_cache(cfg, 2, PROMPT, "cpu")
    _, cache = lm.prefill(params, cfg, toks, cache, impl="flash_pallas")
    got = [c for c, k in zip(cache, cfg.layer_kinds()) if k == "mamba"]
    assert len(got) == len(states)
    for c, (h, tail) in zip(got, states):
        torch.testing.assert_close(c["h"], h, **TOL)
        torch.testing.assert_close(c["conv"], tail, **TOL)


def _moe_params(cfg, seed=3):
    g = torch.Generator().manual_seed(seed)
    return moe.init_moe(g, cfg.moe, cfg.d_model, torch.float32, "cpu")


def _held_share(p, held):
    return {"router": p["router"],
            **{k: p[k][list(held)] for k in ("w_gate", "w_up", "w_down")}}


def test_the_held_shares_of_all_cards_sum_to_the_whole_layer():
    """Two cards of an EP-2 deployment, experts (0, 1) and (2, 3): their
    parts add up to the uncut reference layer."""
    cfg = _config(held=())
    whole = _moe_params(cfg)
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    parts = []
    for held in ((0, 1), (2, 3)):
        m = replace(cfg.moe, held_experts=held)
        parts.append(moe.moe_block(_held_share(whole, held), x, m)[0])
    spec = ref.spec_of(cfg)
    want = ref.experts(x, whole, spec)
    torch.testing.assert_close(parts[0] + parts[1], want, **TOL)
    torch.testing.assert_close(moe.moe_block(whole, x, cfg.moe)[0], want,
                               **TOL)
    assert not torch.allclose(parts[0], want, **TOL)


def test_dropless_keeps_every_slot_under_forced_imbalance():
    """Every token routed to experts 0 and 1: the dropless layer gives
    each its two experts' outputs; the capacity path drops most slots."""
    cfg = _config(held=())
    p = _moe_params(cfg)
    x = torch.rand(2, 16, cfg.d_model,
                   generator=torch.Generator().manual_seed(5)) + 0.1
    router = torch.full_like(p["router"], -1.0)
    router[:, 0], router[:, 1] = 1.0, 0.5
    p["router"] = router
    spec = ref.spec_of(cfg)
    ids = torch.topk(x @ router, 2, dim=-1).indices
    assert bool((ids == torch.tensor([0, 1])).all())
    moe.HELD_ROWS, dropped = 0, moe.dropped_slots()
    for held in ((), (0, 1), (0,)):
        m = replace(cfg.moe, held_experts=held)
        share = _held_share(p, held or range(4))
        got = moe.moe_block(share, x, m)[0]
        torch.testing.assert_close(
            got, ref.experts(x, p, dict(spec, held=list(held or range(4)))),
            **TOL)
    assert moe.HELD_ROWS == 2 * 32 + 2 * 32 + 32
    assert moe.dropped_slots() == dropped
    capacity = replace(cfg.moe, dropless=False, capacity_factor=1.0)
    moe.moe_block(p, x, capacity, group=32)
    # capacity 16 a group of 32 tokens: 16 of expert 0's and 16 of 1's
    assert moe.dropped_slots() == dropped + 32


def test_the_gates_are_not_renormalised():
    cfg = _config(held=())
    p = _moe_params(cfg)
    x = torch.randn(1, 8, cfg.d_model,
                    generator=torch.Generator().manual_seed(6))
    probs = torch.softmax(x @ p["router"], dim=-1)
    gates, ids = torch.topk(probs, 2, dim=-1)
    assert float(gates.sum(-1).max()) < 0.99
    outs = torch.stack([ref.swiglu(x, p["w_gate"][e], p["w_up"][e],
                                   p["w_down"][e]) for e in range(4)])
    picked = outs.permute(1, 2, 0, 3).gather(
        2, ids[..., None].expand(*ids.shape, cfg.d_model))

    def mix(g):
        return (picked * g[..., None]).sum(2)

    got = moe.moe_block(p, x, cfg.moe)[0]
    torch.testing.assert_close(got, mix(gates), **TOL)
    renorm = moe.moe_block(p, x, replace(cfg.moe, renormalize=True))[0]
    torch.testing.assert_close(
        renorm, mix(gates / gates.sum(-1, keepdim=True)), **TOL)


def test_the_routes_are_recorded_as_taken_and_serving_skips_the_aux_loss():
    """``moe.ROUTES``, when a list, gets each dropless layer's top-k ids
    (tokens, k) in layer order; the load-balancing loss is computed only
    where a gradient may want it."""
    cfg = _config(held=(0, 1))
    p = _moe_params(cfg)
    x = torch.randn(2, 8, cfg.d_model,
                    generator=torch.Generator().manual_seed(7))
    want_ids = torch.topk(torch.softmax(x.reshape(16, -1) @ p["router"],
                                        dim=-1), 2, dim=-1).indices
    share = _held_share(p, (0, 1))
    moe.ROUTES = []
    try:
        out, aux = moe.moe_block(share, x, cfg.moe)
        moe.moe_block(share, x, cfg.moe)
        routes = moe.ROUTES
    finally:
        moe.ROUTES = None
    assert len(routes) == 2 and routes[0].shape == (16, 2)
    assert torch.equal(routes[0], want_ids) and torch.equal(routes[1],
                                                            want_ids)
    assert float(aux) > 0
    with torch.no_grad():
        out2, aux2 = moe.moe_block(share, x, cfg.moe)
    assert float(aux2) == 0.0 and torch.equal(out2, out.detach())
    moe.moe_block(share, x, cfg.moe)
    assert moe.ROUTES is None


def test_the_plain_scans_state_equals_the_chunked_scans():
    """``mamba_block`` under a cache holding a state: the kernel route's
    plain version (``selective_scan_state_torch``) leaves the h_S and conv
    tail that the chunked scan leaves, and the same output."""
    cfg = _config()
    g = torch.Generator().manual_seed(7)
    p = mamba.init_mamba(g, cfg.ssm, cfg.d_model, torch.float32, "cpu")
    with torch.no_grad():
        for k in ("conv_b", "dt_norm", "b_norm", "c_norm", "D"):
            p[k].add_(0.3 * torch.randn(p[k].shape, generator=g))
    x = torch.randn(2, 13, cfg.d_model, generator=g)
    cache = mamba.init_mamba_cache(cfg.ssm, cfg.d_model, 2, torch.float32,
                                   "cpu")
    cache["h"].normal_(generator=g)
    plain_calls = SS.PLAIN_CALLS["selective_scan"]
    out_k, new_k = mamba.mamba_block(p, x, cfg.ssm, cache=cache,
                                     impl="pallas")
    assert SS.PLAIN_CALLS["selective_scan"] == plain_calls + 1
    out_c, new_c = mamba.mamba_block(p, x, cfg.ssm, cache=cache,
                                     impl="chunked_scan")
    torch.testing.assert_close(out_k, out_c, **TOL)
    torch.testing.assert_close(new_k["h"], new_c["h"], **TOL)
    assert torch.equal(new_k["conv"], new_c["conv"])
    assert not torch.allclose(new_k["h"], cache["h"])


def test_selective_scan_state_carries_the_state_across_a_split():
    g = torch.Generator().manual_seed(8)
    B, S, D, N = 2, 21, 12, 5
    x = torch.randn(B, S, D, generator=g)
    dt = 0.1 * torch.rand(B, S, D, generator=g)
    b, c = torch.randn(B, S, N, generator=g), torch.randn(B, S, N, generator=g)
    a, d = -torch.rand(D, N, generator=g) - 0.1, torch.randn(D, generator=g)
    y = SS.selective_scan(x, dt, b, c, a, d)
    h = torch.zeros(B, D, N)
    ys = []
    for lo, hi in ((0, 7), (7, 8), (8, S)):
        part, h = SS.selective_scan_state(x[:, lo:hi], dt[:, lo:hi],
                                          b[:, lo:hi], c[:, lo:hi], a, d, h)
        ys.append(part)
    torch.testing.assert_close(torch.cat(ys, 1), y, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="h0"):
        SS.selective_scan_state(x, dt, b, c, a, d, torch.zeros(B, D, N + 1))


# sha256 (first 16 hex) of the float32 bytes of each smoke config's
# forward logits and of its prefill + 3 decode steps' logits, one thread,
# as the port computed them before the jamba options existed
PINNED = {"olmo-1b": ("b0ae873be33d3c24", "b9b23f70091a25ca"),
          "phi3-vision-4b": ("27cdba58640cfd54", "9063478a6df4e8be"),
          "jamba-v0.1-52b": ("c95868861ff6bcad", "b4cc1cee1914c4fe")}


def _digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().float().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("arch", sorted(PINNED))
def test_the_defaults_compute_the_bits_they_computed_before(arch):
    """RoPE on, no inner norms, renormalised gates, capacity dispatch over
    every expert: the defaults of the new options leave these paths
    bit-equal."""
    cfg = get_smoke_config(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))
    patches = (torch.from_numpy(rng.normal(
        size=(2, cfg.n_patches, cfg.d_model)).astype(np.float32))
        if cfg.n_patches else None)
    with torch.no_grad():
        fwd = lm.forward(params, cfg, toks, patches)
        cache = lm.init_cache(cfg, 2, 24 + cfg.n_patches + 4, "cpu")
        logits, cache = lm.prefill(params, cfg, toks, cache,
                                   patches=patches)
        outs = [logits]
        tok = logits[:, -1].argmax(-1)[:, None]
        for _ in range(3):
            logits, cache = lm.decode_step(params, cfg, tok, cache)
            outs.append(logits)
            tok = logits[:, -1].argmax(-1)[:, None]
    assert (_digest(fwd), _digest(*outs)) == PINNED[arch]
