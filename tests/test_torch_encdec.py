"""The encoder-decoder family (whisper-small) in the port, held against the
JAX reference on the same inputs.

Parameters come from the reference's own init, carried across with
``convert``; tokens and frame embeddings are made with numpy from fixed
seeds; the reference runs jitted, one compile per function and batch
shape.  Smoke config (2 + 2 layers, d 64, 16 frames),
``compute_dtype="float32"``.  Tolerances, as ``tests/test_torch_mla.py``:
outputs and logits atol 2e-4, rtol 1e-3; the loss rtol 1e-5; every
gradient leaf within 1e-5 of that leaf's largest reference magnitude.
No kernel lies on this path (the reference fixes ``impl="dense"`` and
``"chunked"`` here).
"""

import functools
import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import save_pytree as ref_save
from repro.configs import get_smoke_config as ref_smoke
from repro.launch import steps as ref_steps
from repro.models import encdec as ref_encdec
from repro.models import get_model as ref_get_model
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.ckpt import latest_checkpoint, save_pytree
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.convert import (lm_params_from_numpy, load_train_state,
                                 train_state_from_numpy, train_state_tree)
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import steps as port_steps
from repro_torch.launch.train import main as port_main
from repro_torch.launch.train import train_loop as port_train_loop
from repro_torch.models import encdec as port_encdec
from repro_torch.models import get_model as port_get_model
from repro_torch.models import lm as port_lm

ARCH = "whisper_small"
TOL = dict(atol=2e-4, rtol=1e-3)
F32_LOSS_RTOL, F32_GRAD = 1e-5, 1e-5
B, S = 2, 12


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


def _configs():
    return [replace(cfg, compute_dtype="float32")
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


def _batch(cfg, b=B, s=S, seed=1):
    """Tokens, next-token labels and precomputed frame embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    frames = rng.normal(size=(b, cfg.enc_dec.encoder_len,
                              cfg.d_model)).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "frames": frames}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_model_dispatches_on_is_encdec():
    whisper = port_get_model(port_smoke(ARCH))
    olmo = port_get_model(port_smoke("olmo_1b"))
    assert whisper.is_encdec and not olmo.is_encdec
    assert isinstance(whisper.init_params(0, device="cpu"),
                      port_encdec.EncDec)
    assert isinstance(olmo.init_params(0, device="cpu"), port_lm.LM)
    cache = whisper.init_cache(2, 8, device="cpu")
    assert set(cache) == {"self", "cross_k", "cross_v"}
    assert len(cache["self"]) == port_smoke(ARCH).n_layers


def test_sinusoidal_positions_equal_reference():
    assert np.array_equal(port_encdec._sinusoidal(1500, 768),
                          ref_encdec._sinusoidal(1500, 768))


def test_encode_matches_reference():
    rcfg, pcfg, params, port = _models()
    frames = _batch(rcfg)["frames"]
    ref = jax.jit(ref_encdec.encode, static_argnums=1)(
        params, rcfg, jnp.asarray(frames))
    out = port_encdec.encode(port, pcfg, frames)
    assert out.shape == (B, rcfg.enc_dec.encoder_len, rcfg.d_model)
    _close(out, ref)


def test_whisper_smoke_matches_reference():
    """``Model.logits`` (teacher-forced), ``Model.prefill`` (encode + the
    prompt, filling self- and cross-attention caches) and 4 greedy decode
    steps: logits, tokens and the caches; no flash kernel nor its plain
    version runs."""
    rcfg, pcfg, params, port = _models()
    rm, pm = ref_get_model(rcfg), port_get_model(pcfg)
    batch = _batch(rcfg)
    FA.reset_counts()
    ref = jax.jit(rm.logits)(params, _jax(batch))
    out = pm.logits(port, batch)
    assert out.shape == (B, S, rcfg.vocab_size)
    _close(out, ref)
    assert torch.equal(port(batch["tokens"], batch["frames"]), out)
    inputs = {k: batch[k] for k in ("tokens", "frames")}
    rc = rm.init_cache(B, S + 4)
    ref, rc = jax.jit(rm.prefill)(params, _jax(inputs), rc)
    pc = pm.init_cache(B, S + 4, device="cpu")
    cross_k = pc["cross_k"][0]
    out, pc = pm.prefill(port, inputs, pc)
    assert pc["cross_k"][0] is cross_k             # filled in place
    _close(out, ref)
    ref_decode = jax.jit(rm.decode_step)
    for _ in range(4):
        rt = np.asarray(jnp.argmax(ref[:, -1], -1))[:, None]
        pt = out[:, -1].argmax(-1)[:, None]
        assert np.array_equal(pt.numpy(), rt)
        ref, rc = ref_decode(params, jnp.asarray(rt), rc)
        out, pc = pm.decode_step(port, pt, pc)
        _close(out, ref)
    for i in range(pcfg.n_layers):
        _close(pc["cross_k"][i], rc["cross_k"][i])
        _close(pc["cross_v"][i], rc["cross_v"][i])
        _close(pc["self"][i]["k"], rc["self"]["k"][i])
        assert pc["self"][i]["pos"] == int(rc["self"]["pos"][i]) == S + 4
    assert FA.PLAIN_CALLS["flash_attention"] == 0
    assert FA.LAUNCHES["flash_attention"] == 0


def test_whisper_loss_and_grads_match_reference():
    """The loss and every gradient leaf (encoder, decoder with
    cross-attention, both position tables), in the reference's layout
    (``convert.train_state_tree``)."""
    rcfg, pcfg = _configs()
    params = _ref_params()
    f = jax.jit(jax.value_and_grad(ref_steps.make_loss_fn(rcfg),
                                   has_aux=True))
    (r_total, r_m), r_grads = f(jax.tree.map(jnp.asarray, params),
                                _jax(_batch(rcfg)))
    opt = jax.tree.map(np.asarray, ref_adamw_init(params))
    model, _ = train_state_from_numpy(pcfg, params, opt, device="cpu")
    total, m = port_steps.make_loss_fn(pcfg)(model, _batch(pcfg))
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(total,
                                                list(named.values()))))
    np.testing.assert_allclose(float(total.detach()), float(r_total),
                               rtol=F32_LOSS_RTOL)
    np.testing.assert_allclose(float(m["loss"].detach()),
                               float(r_m["loss"]), rtol=F32_LOSS_RTOL)
    tree = train_state_tree(model, {"step": 0, "m": grads, "v": grads})
    leaves = jax.tree_util.tree_flatten_with_path(r_grads)[0]
    assert len(leaves) == len(jax.tree.leaves(tree["opt"]["m"]))
    for path, r in leaves:
        node = tree["opt"]["m"]
        for k in path:
            node = node[k.key]
        r = np.asarray(r)
        np.testing.assert_allclose(node.numpy(), r, rtol=0,
                                   atol=F32_GRAD * np.abs(r).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_whisper_checkpoint_is_the_references_byte_for_byte(tmp_path):
    """The reference's training state carried into the port and back
    (``train_state_from_numpy``, ``train_state_tree``) saves to the same
    files, byte for byte, as the reference's own save; the port reads it
    back to the same module."""
    rcfg, pcfg = _configs()
    params = _ref_params()
    opt = jax.tree.map(np.asarray, ref_adamw_init(params))
    model, state = train_state_from_numpy(pcfg, params, opt, device="cpu")
    rpath = ref_save({"params": params, "opt": opt}, tmp_path / "ref", 1)
    ppath = save_pytree(train_state_tree(model, state), tmp_path / "port", 1)
    rindex = json.loads((rpath / "manifest.json").read_text())["index"]
    pindex = json.loads((ppath / "manifest.json").read_text())["index"]
    assert rindex == pindex
    for e in rindex:
        assert (rpath / e["file"]).read_bytes() == \
            (ppath / e["file"]).read_bytes(), e
    back, _ = load_train_state(pcfg, ppath, device="cpu")
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 back.named_parameters()):
        assert torch.equal(a, b), name


def quiet(*a, **k):
    pass


def test_whisper_trains_and_resumes(tmp_path):
    """``train_loop`` gives whisper its frames (zeros, as the reference's
    loop does): 4 steps with a checkpoint every 2, then a restart to 6
    resumes at step 4; the loss falls; the CLI trains it too."""
    cfg = port_smoke(ARCH)
    kw = dict(batch=4, seq=16, ckpt_dir=str(tmp_path / "run"), ckpt_every=2,
              lr=1e-3, print_fn=quiet, device="cpu")
    _, a = port_train_loop(cfg, steps=4, **kw)
    _, b = port_train_loop(cfg, steps=6, **kw)
    assert [r["step"] for r in b.rows] == [4, 5]
    losses = [r["loss"] for r in a.rows + b.rows]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    rc = port_main(["--arch", "whisper-small", "--smoke", "--steps", "2",
                    "--batch", "2", "--seq", "8", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path / "cli")])
    assert rc == 0
    assert latest_checkpoint(tmp_path / "cli").name == "step_000000002"
