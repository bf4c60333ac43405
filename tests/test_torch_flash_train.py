"""The training flash attention's plain versions and dispatch, on the
CPU: ``flash_attention_train_torch`` (o and the log-sum-exp) and
``flash_attention_train_backward_torch`` (FlashAttention's equations),
composed as ``layers._flash_train`` composes the kernels, against autograd
of ``dense_attention``, in float32 and in bf16, MHA and GQA expanded as
``layers._attend`` expands it; and ``layers.flash_train_applies``, the
rule that sends a chunked-route call to the kernels, condition by
condition.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 13)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as L

BF16 = torch.bfloat16


def _qkv(b, s, h, kv, dtype, seed):
    rng = np.random.default_rng(seed)
    make = lambda heads: torch.from_numpy(  # noqa: E731
        rng.normal(size=(b, s, heads, 128)).astype(np.float32)).to(dtype)
    q, k, v = make(h), make(kv), make(kv)
    g = make(h)
    return [t.requires_grad_() for t in (q, k, v)], g


def _grads(fn, q, k, v, g):
    out = fn(q, k, v)
    q.grad = k.grad = v.grad = None
    out.backward(g)
    return out.detach(), [t.grad.clone() for t in (q, k, v)]


def _dense(q, k, v):
    return L.dense_attention(q, k, v, causal=True)


class _PlainTrain(torch.autograd.Function):
    """``flash_attention_train`` at scale 1 with the plain versions in
    place of the kernels: the forward saves o and the log-sum-exp, the
    backward applies the FlashAttention equations to them."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = FA.flash_attention_train_torch(q, k, v, scale=1.0)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return FA.flash_attention_train_backward_torch(
            *ctx.saved_tensors, do, scale=1.0)


def _train(q, k, v):
    """What ``_attend`` runs for a qualifying call (``layers._flash_train``:
    q scaled in its dtype, k and v expanded, (B, S, H, D) -> (B*H, S, D)
    and back), with the plain versions in place of the kernels."""
    b, s, h, d = q.shape
    qh, kh, vh = (x.movedim(2, 1).reshape(b * h, s, d)
                  for x in (L._scaled(q, d), L._expand_kv(k, h),
                            L._expand_kv(v, h)))
    return _PlainTrain.apply(qh, kh, vh).reshape(b, h, s, d).movedim(1, 2)


HEADS = [pytest.param(4, 4, id="mha"), pytest.param(4, 2, id="gqa2"),
         pytest.param(6, 2, id="gqa3")]


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("h,kv", HEADS)
def test_plain_train_attention_matches_dense_autograd_f32(s, h, kv):
    """float32: o and dq, dk, dv (GQA: summed over each group by
    ``repeat_interleave``'s backward) equal dense attention's within
    float32 summation order."""
    (q, k, v), g = _qkv(2, s, h, kv, torch.float32, seed=s + h + kv)
    want, want_g = _grads(_dense, q, k, v, g)
    out, got_g = _grads(_train, q, k, v, g)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    for name, a, b in zip("qkv", got_g, want_g):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()),
                                   msg=f"d{name}")


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("h,kv", HEADS)
def test_plain_train_attention_matches_dense_autograd_bf16(s, h, kv):
    """bf16: within 2^-6 of the largest element (four units in the last
    place of bf16 there).  The route rounds q / sqrt(128), P (for P v and
    dV) and dS (for dQ, dK) to bf16, where dense attention divides in
    float32 and keeps P and dS in float32; both round the results."""
    (q, k, v), g = _qkv(2, s, h, kv, BF16, seed=7 * s + h + kv)
    want, want_g = _grads(_dense, q, k, v, g)
    out, got_g = _grads(_train, q, k, v, g)
    assert out.dtype == BF16 and all(t.dtype == BF16 for t in got_g)
    for name, a, b in zip(("o", "dq", "dk", "dv"), [out, *got_g],
                          [want, *want_g]):
        err = float((a.float() - b.float()).abs().max())
        assert err <= 2.0 ** -6 * float(b.float().abs().max()), (name, err)


@pytest.mark.parametrize("s", [128, 256])
def test_plain_forward_returns_the_log_sum_exp(s):
    """lse is each row's natural log-sum-exp of the scaled causal
    scores; o is dense attention's."""
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(rng.normal(size=(3, s, 128))
                                .astype(np.float32)) for _ in range(3))
    o, lse = FA.flash_attention_train_torch(q, k, v)
    scores = q @ k.transpose(1, 2) / np.sqrt(128)
    scores = scores.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1),
                                float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1),
                               rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(
        o, FA.flash_attention_torch(q, k, v, causal=True), rtol=1e-5,
        atol=1e-6)


@pytest.mark.parametrize("s", [128, 256])
def test_plain_backward_is_the_flash_equations_of_autograd(s):
    """The backward from o and lse equals autograd through the plain
    forward (float32), with the scale applied to dq and dk."""
    rng = np.random.default_rng(3 * s)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, s, 128))
                                    .astype(np.float32)) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, _ = FA.flash_attention_train_torch(*leaves, scale=0.3)
    o.backward(do)
    o, lse = FA.flash_attention_train_torch(q, k, v, scale=0.3)
    got = FA.flash_attention_train_backward_torch(q, k, v, o, lse, do,
                                                  scale=0.3)
    for a, t in zip(got, leaves):
        torch.testing.assert_close(a, t.grad, rtol=1e-5,
                                   atol=1e-5 * float(t.grad.abs().max()))


def test_train_attention_runs_without_autograd_the_same():
    """A pass with autograd off takes the same function: no_grad and
    inference mode give the recorded pass's o."""
    (q, k, v), _ = _qkv(1, 128, 2, 2, BF16, seed=1)
    want = _train(q, k, v).detach()
    with torch.no_grad():
        assert torch.equal(_train(q, k, v), want)
    with torch.inference_mode():
        assert torch.equal(_train(q, k, v), want)


def test_flash_train_refuses_unexpanded_kv():
    q = torch.zeros((4, 128, 128))
    with pytest.raises(ValueError, match="GQA expanded"):
        FA.flash_attention_train(q, q[:2], q[:2])


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_flash_train_takes_only_the_kernels(dtype):
    """``flash_attention_train`` has no CPU branch: CPU tensors, even at a
    shape the kernels take, raise (``_attend`` never sends them)."""
    q = torch.zeros((2, 128, 128), dtype=dtype)
    with pytest.raises(TypeError, match="CUDA"):
        FA.flash_attention_train(q, q, q)


# the dispatch rule, condition by condition, on stand-ins that carry what
# it reads (device, dtype, shape): the sandbox has no CUDA tensors


def _t(shape, cuda=True, dtype=BF16):
    return SimpleNamespace(is_cuda=cuda, dtype=dtype, shape=tuple(shape))


def _olmo(s=4096, t=None, dq=128, dv=128, cuda=(True, True, True),
          dtypes=(BF16, BF16, BF16), kv=16):
    t = s if t is None else t
    return (_t((4, s, 16, dq), cuda[0], dtypes[0]),
            _t((4, t, kv, dq), cuda[1], dtypes[1]),
            _t((4, t, kv, dv), cuda[2], dtypes[2]))


@pytest.mark.parametrize("window", [0, 4096, 8192])
def test_dispatch_takes_the_kernel_on_olmo_training_shape(window):
    """olmo-1b's training layer (B 4 x 4096, 16 x 128 heads, causal), with
    no window or one that cuts nothing; GQA too (k/v expanded later)."""
    assert L.flash_train_applies(*_olmo(), causal=True, window=window)
    assert L.flash_train_applies(*_olmo(kv=8), causal=True, window=window)
    assert L.flash_train_applies(*_olmo(s=128), causal=True, window=0)


@pytest.mark.parametrize("case,kw", [
    pytest.param(dict(cuda=(False, True, True)), {}, id="q-on-cpu"),
    pytest.param(dict(cuda=(True, True, False)), {}, id="v-on-cpu"),
    pytest.param(dict(dtypes=(torch.float32,) * 3), {}, id="float32"),
    pytest.param(dict(dtypes=(BF16, torch.float32, BF16)), {},
                 id="k-float32"),
    pytest.param(dict(dq=96, dv=96), {}, id="head-dim-96"),
    pytest.param(dict(dq=120, dv=120), {}, id="head-dim-120"),
    pytest.param(dict(dq=128, dv=64), {}, id="dv-64"),
    pytest.param(dict(dq=96, dv=64), {}, id="mla-96-64"),
    pytest.param({}, dict(causal=False), id="not-causal"),
    pytest.param({}, dict(window=4095), id="window-cuts"),
    pytest.param({}, dict(window=1024), id="window-1024"),
    pytest.param({}, dict(q_offset=1), id="q-offset"),
    pytest.param(dict(s=2048, t=4096), {}, id="s-ne-t"),
    pytest.param(dict(s=1000), {}, id="s-ragged"),
    pytest.param(dict(s=4160), {}, id="s-multiple-of-64-only"),
])
def test_dispatch_refuses_each_unmet_condition(case, kw):
    args = dict(causal=True, window=0)
    args.update(kw)
    assert not L.flash_train_applies(*_olmo(**case), **args)


def test_cpu_tensors_never_take_the_kernel_nor_count_as_chunked_cuda(
        monkeypatch):
    """Real CPU tensors at a qualifying shape: the chunked route runs
    ``chunked_attention`` as before, and neither the training kernels'
    counters nor ``layers.CHUNKED_CUDA_CALLS`` move."""
    FA.reset_counts()
    monkeypatch.setattr(L, "CHUNKED_CUDA_CALLS", 0)
    (q, k, v), _ = _qkv(1, 256, 2, 2, BF16, seed=5)
    assert not L.flash_train_applies(q, k, v, causal=True, window=0)
    with torch.no_grad():
        out = L._attend(q, k, v, causal=True, window=0, impl="chunked",
                        chunk=128)
        want = L.chunked_attention(q, k, v, causal=True, chunk=128)
    assert torch.equal(out, want)
    assert L.CHUNKED_CUDA_CALLS == 0
    assert all(n == 0 for n in FA.VARIANT_LAUNCHES.values())
    assert FA.LAUNCHES == {"flash_attention": 0}
