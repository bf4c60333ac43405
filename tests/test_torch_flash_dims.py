"""B2 at the head dims of h2o-danube3-4b (120, 120: GQA 32 / 8 with a
4096-key window) and phi3-vision-4b (96, 96), on the CPU.

On the card these take the ``wgmma_120`` and ``wgmma_96`` instances of the
TMA + ``wgmma`` kernel (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 16); here the wrapper takes the plain version.  Held here:

* the plain version against the reference's Pallas kernel in interpret
  mode (``flash_attention_pallas(..., interpret=True)``) at both head dims
  -- 120 with GQA 4 and a window shorter than S, 96 causal -- in float32
  (the reference's kernel-test tolerance, atol 2e-4, rtol 1e-3) and in
  bfloat16 (within ``FA.bf16_error_bound``, the limit the card's kernel is
  held to: the Pallas kernel rounds its probabilities to bf16 as the card's
  kernel does);
* both archs' smoke configs widened to their real head dims (120 with a
  window below S, so that the prefill outgrows the ring cache; 96 with
  patch embeddings prepended), the port's ``flash_pallas`` against the
  reference's ``flash_pallas_interpret`` from the same converted weights:
  logits, then a prefill and greedy decode steps (float32, atol 2e-4,
  rtol 1e-3, as ``tests/test_torch_lm.py``).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm as ref_lm
from repro.configs import get_smoke_config as ref_smoke
from repro.kernels import ops as ref_ops
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import get_model as ref_get_model
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import get_model as port_get_model
from repro_torch.models import lm as port_lm

F32_TOL = dict(atol=2e-4, rtol=1e-3)   # tests/test_kernels.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

# (head dim, query heads, KV heads, S, causal, window): h2o-danube3's heads
# with GQA 4 and a window of 100 keys (the window's edge inside a 128-key
# block), phi3-vision's MHA heads under the causal mask
CASES = [(120, 8, 2, 256, True, 100),
         (96, 4, 4, 256, True, 0)]


def _pallas(q, k, v, group, causal, window, dtype):
    """The reference's Pallas kernel, interpret mode, over KV heads
    repeated to the query heads (it takes one KV head a query head)."""
    to = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    out = flash_attention_pallas(
        to(q), to(np.repeat(k, group, 0)), to(np.repeat(v, group, 0)),
        bq=128, bk=128, causal=causal, window=window, interpret=True)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("d,bh,bkv,s,causal,window", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_matches_pallas_at_new_head_dims(d, bh, bkv, s, causal,
                                                     window, dtype):
    rng = np.random.default_rng(d + bh + window)
    q = rng.normal(size=(bh, s, d)).astype(np.float32)
    k, v = (rng.normal(size=(bkv, s, d)).astype(np.float32)
            for _ in range(2))
    tdtype = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdtype) for a in (q, k, v))
    before = FA.PLAIN_CALLS["flash_attention"]
    out = FA.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert FA.PLAIN_CALLS["flash_attention"] == before + 1
    assert out.dtype == tdtype and out.shape == (bh, s, d)
    ref = _pallas(q, k, v, bh // bkv, causal, window, getattr(jnp, dtype))
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)
        return
    bound = FA.bf16_error_bound(tq, tk, tv, causal=causal, window=window)
    err = (torch.from_numpy(ref) - out.float()).abs()
    assert bool((err <= bound).all()), float((err / bound).max())


def test_plain_flash_matches_pallas_ragged_window_at_120():
    """A ragged S (200: the reference pads to its blocks) with the window
    (64) cutting every row past it, GQA 4, float32."""
    rng = np.random.default_rng(120)
    q = rng.normal(size=(4, 200, 120)).astype(np.float32)
    k, v = (rng.normal(size=(1, 200, 120)).astype(np.float32)
            for _ in range(2))
    ref = ref_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(np.repeat(k, 4, 0)),
        jnp.asarray(np.repeat(v, 4, 0)), causal=True, window=64, bq=64,
        bk=64)
    out = FA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=True, window=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


# ---------------------------------------------------------------------------
# the two archs at their real head dims, kernel impl against the reference
# ---------------------------------------------------------------------------

# (arch, attention fields, text tokens of the prompt): h2o-danube3 at head
# dim 120 with a window of 16 and a prompt of 136 tokens (past the ring
# cache's 128 slots, so the prefill keeps the last 128 positions and the
# decode steps wrap around); phi3-vision at head dim 96, its 8 patch
# positions before 24 tokens
ARCHS = [("h2o_danube3_4b", dict(head_dim=120, window=16), 136),
         ("phi3_vision_4b", dict(head_dim=96), 24)]
DECODE_STEPS = 3


def _models(arch, attention):
    """(reference config, port config, reference params, port params):
    the smoke config at float32 with the attention fields replaced, the
    port's weights converted from the reference's."""
    cfgs = []
    for cfg in (ref_smoke(arch), port_smoke(arch)):
        cfgs.append(replace(cfg, compute_dtype="float32",
                            attention=replace(cfg.attention, **attention)))
    rcfg, pcfg = cfgs
    params = jax.jit(ref_get_model(rcfg).init_params)(jax.random.key(0))
    port = lm_params_from_numpy(pcfg, jax.tree.map(np.asarray, params),
                                device="cpu")
    return rcfg, pcfg, params, port


def _close(port, ref):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **F32_TOL)


@pytest.mark.parametrize("arch,attention,s", ARCHS)
def test_arch_at_real_head_dims_kernel_impl_matches_reference(arch,
                                                              attention, s):
    rcfg, pcfg, params, port = _models(arch, attention)
    a = pcfg.attention
    assert FA.plan(a.head_dim, a.head_dim, torch.bfloat16, True) == (
        {120: "wgmma_120", 96: "wgmma_96"}[a.head_dim])
    b = 2
    rng = np.random.default_rng(1)
    toks = rng.integers(0, rcfg.vocab_size, (b, s))
    patches = None
    if rcfg.n_patches:
        patches = rng.normal(size=(b, rcfg.n_patches, rcfg.d_model)).astype(
            np.float32)
    jp = None if patches is None else jnp.asarray(patches)
    tp = None if patches is None else torch.from_numpy(patches)
    total = s + rcfg.n_patches

    FA.reset_counts()
    ref = ref_lm.forward(params, rcfg, jnp.asarray(toks), jp,
                         impl="flash_pallas_interpret")
    out = port_lm.forward(port, pcfg, torch.from_numpy(toks), tp,
                          impl="flash_pallas")
    assert out.shape == (b, total, rcfg.vocab_size)
    assert FA.PLAIN_CALLS["flash_attention"] == rcfg.n_layers
    _close(out, ref)

    rm, pm = ref_get_model(rcfg), port_get_model(pcfg)
    rc = rm.init_cache(b, total + DECODE_STEPS)
    pc = pm.init_cache(b, total + DECODE_STEPS, device="cpu")
    if a.window:
        assert pc[0]["k"].shape[1] < total      # the prefill fills the ring
    ref, rc = ref_lm.prefill(params, rcfg, jnp.asarray(toks), rc, patches=jp,
                             impl="flash_pallas_interpret")
    out, pc = port_lm.prefill(port, pcfg, torch.from_numpy(toks), pc,
                              patches=tp, impl="flash_pallas")
    _close(out, ref)
    ref_decode = jax.jit(rm.decode_step)
    for _ in range(DECODE_STEPS):
        rt = np.asarray(jnp.argmax(ref[:, -1], -1))[:, None]
        pt = out[:, -1].argmax(-1)[:, None]
        assert np.array_equal(pt.numpy(), rt)
        ref, rc = ref_decode(params, jnp.asarray(rt), rc)
        out, pc = pm.decode_step(port, pt, pc)
        _close(out, ref)
