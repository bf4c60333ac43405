"""The port's max-plus kernel module, held against the reference's Pallas
kernel.

On the CPU the wrappers take the plain PyTorch version; it must equal the
Pallas kernel (run in interpret mode, as the reference's own tests run it)
BIT FOR BIT: ⊗ is one float32 add then a max, so no tolerance applies —
including ragged shapes and NEG (-1e18, the max-plus -inf) entries.

The kernel itself, on the card, is held against the plain version in
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aidg import maxplus as ref_mp
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.kernels.maxplus import maxplus_matvec_pallas
from repro_torch.core.aidg import maxplus as port_mp
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import maxplus as K
from repro_torch.kernels import selective_scan as SS

NEG = -1e18


def _operand(rng, shape, neg_frac=0.2):
    """float32 values in [-500, 500] with a ``neg_frac`` share of NEG."""
    x = rng.uniform(-500, 500, size=shape).astype(np.float32)
    x[rng.random(shape) < neg_frac] = NEG
    return x


# ---------------------------------------------------------------------------
# plain version vs the Pallas kernel (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (100, 70, 130),
                                   (33, 17, 5), (1, 8, 1), (64, 3, 40)])
def test_plain_matmul_equals_pallas_bitwise(m, k, n):
    rng = np.random.default_rng(m * 10007 + k * 101 + n)
    A, B = _operand(rng, (m, k)), _operand(rng, (k, n))
    ref = np.asarray(ref_ops.maxplus_matmul(jnp.asarray(A), jnp.asarray(B)))
    out = K.maxplus_matmul(torch.from_numpy(A)[None],
                           torch.from_numpy(B)[None])[0].numpy()
    assert out.dtype == np.float32
    assert np.array_equal(out, ref)


def test_plain_matmul_batched_equals_pallas_per_item():
    rng = np.random.default_rng(1)
    A, B = _operand(rng, (3, 40, 24)), _operand(rng, (3, 24, 56))
    out = K.maxplus_matmul(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    for i in range(3):
        ref = np.asarray(ref_ops.maxplus_matmul(jnp.asarray(A[i]),
                                                jnp.asarray(B[i])))
        assert np.array_equal(out[i], ref)


@pytest.mark.parametrize("m,k", [(128, 128), (16, 16), (70, 33)])
def test_plain_matvec_equals_pallas_bitwise(m, k):
    rng = np.random.default_rng(m + k)
    A, v = _operand(rng, (m, k)), _operand(rng, (k,))
    mult = lambda x: -(-x // 8) * 8     # Pallas blocks: pad to (8, .) tiles
    Ap = np.full((mult(m), mult(k)), NEG, np.float32)
    Ap[:m, :k] = A
    vp = np.full((mult(k),), NEG, np.float32)
    vp[:k] = v
    ref = np.asarray(maxplus_matvec_pallas(jnp.asarray(Ap),
                                           jnp.asarray(vp)))[:m]
    out = K.maxplus_matvec(torch.from_numpy(A)[None],
                           torch.from_numpy(v)[None])[0].numpy()
    assert np.array_equal(out, ref)


def test_closure_equals_reference_closure():
    """Kleene closure by repeated squaring: the port's batched closure
    (one ⊗ per squaring for the whole batch) equals the reference's
    ``maxplus_closure`` per matrix, bit for bit."""
    rng = np.random.default_rng(2)
    M = _operand(rng, (3, 32, 32), neg_frac=0.8)
    out = port_mp.maxplus_closure(torch.from_numpy(M), 5).numpy()
    for i in range(3):
        ref = np.asarray(ref_mp.maxplus_closure(jnp.asarray(M[i]), 5))
        assert np.array_equal(out[i], ref)


# ---------------------------------------------------------------------------
# wrapper dispatch and checks (CPU)
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_count_it():
    K.reset_counts()
    A = torch.zeros((2, 4, 4))
    v = torch.zeros((2, 4))
    K.maxplus_matmul(A, A)
    K.maxplus_matvec(A, v)
    K.maxplus_closure(A, 2, variant="closure_lower")
    K.maxplus_matvec_lower(A, v)
    K.maxplus_matvec_folded(A[0], v, v, v)
    names = ("maxplus_matmul", "maxplus_matvec", "maxplus_closure",
             "maxplus_matvec_lower", "maxplus_matvec_folded")
    assert K.PLAIN_CALLS == {k: 1 for k in names}
    assert K.LAUNCHES == {k: 0 for k in names}
    assert K.VARIANT_LAUNCHES == {"closure_lower": 0, "closure_full": 0}
    K.reset_counts()
    assert K.PLAIN_CALLS == {k: 0 for k in names}


def test_wrappers_reject_bad_shapes():
    A = torch.zeros((2, 4, 5))
    with pytest.raises(ValueError, match="maxplus_matmul"):
        K.maxplus_matmul(A, torch.zeros((2, 4, 3)))
    with pytest.raises(ValueError, match="maxplus_matmul"):
        K.maxplus_matmul(A[0], torch.zeros((5, 3)))
    with pytest.raises(ValueError, match="maxplus_matvec"):
        K.maxplus_matvec(A, torch.zeros((2, 4)))


def test_plain_version_never_builds_the_cube():
    """The plain version reduces k in K_STEP slabs, as the TPU kernel does:
    its largest intermediate is (M, K_STEP, N), not (M, K, N)."""
    assert K.K_STEP == 8
    A = torch.zeros((1, 16, 128))
    B = torch.zeros((1, 128, 16))
    assert torch.equal(K.maxplus_matmul_torch(A, B), torch.zeros((1, 16, 16)))


# ---------------------------------------------------------------------------
# flash attention and the selective scan: plain versions vs the Pallas
# kernels (interpret mode), with the reference's own tolerances
# (tests/test_kernels.py: flash f32 atol 2e-4 rtol 1e-3, bf16 3e-2; scan
# atol/rtol 1e-4)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,s,d,causal,window", [
    (1, 2, 128, 64, True, 0),
    (2, 2, 256, 64, True, 0),
    (1, 1, 160, 64, True, 0),       # ragged -> padded in the reference
    (1, 2, 128, 64, False, 0),
    (1, 2, 256, 64, True, 64),      # sliding window
    (1, 2, 256, 128, True, 0),
])
def test_plain_flash_attention_matches_pallas(b, h, s, d, causal, window):
    rng = np.random.default_rng(b * 1000 + h * 100 + s + d + window)
    q, k, v = (rng.normal(size=(b * h, s, d)).astype(np.float32)
               for _ in range(3))
    ref = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, bq=64, bk=64)
    out = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("s,d,causal,window", [
    (128, 64, True, 0), (256, 128, True, 0), (256, 128, True, 64),
    (128, 128, False, 0)])
def test_plain_flash_attention_bf16_and_gqa_match_pallas(s, d, causal,
                                                         window):
    """bf16 inputs; GQA: 4 query heads over 2 KV heads equal the Pallas
    kernel over expanded (repeated) KV heads.  The Pallas kernel rounds its
    probabilities to bf16 before the product with v, as the port's CUDA
    kernel does, so it is held within ``bf16_error_bound`` of the plain
    version -- the limit the CUDA kernel is held to on the card."""
    rng = np.random.default_rng(5 + s + d + window)
    q = rng.normal(size=(4, s, d)).astype(np.float32)
    kv = rng.normal(size=(2, 2, s, d)).astype(np.float32)
    to_bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    ref = ref_ops.flash_attention(to_bf(q), to_bf(np.repeat(kv[0], 2, 0)),
                                  to_bf(np.repeat(kv[1], 2, 0)),
                                  causal=causal, window=window, bq=64, bk=64)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    q, k, v = tb(q), tb(kv[0]), tb(kv[1])
    out = FA.flash_attention(q, k, v, causal=causal, window=window)
    assert out.dtype == torch.bfloat16
    bound = FA.bf16_error_bound(q, k, v, causal=causal, window=window)
    err = (torch.from_numpy(np.asarray(ref, np.float32)) - out.float()).abs()
    assert bool((err <= bound).all()), float((err / bound).max())


def test_plain_flash_attention_dv_differs_from_dq():
    """Dv != Dq (ROADMAP C1: the Pallas kernel returns NaN there), held
    against ``ref.flash_attention_ref``; non-causal ragged Sk too."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 128, 64)).astype(np.float32)
    k = rng.normal(size=(2, 128, 64)).astype(np.float32)
    v = rng.normal(size=(2, 128, 32)).astype(np.float32)
    for causal, sk in ((True, 128), (False, 77)):
        ref = ref_kernels.flash_attention_ref(
            jnp.asarray(q)[None], jnp.asarray(k[:, :sk])[None],
            jnp.asarray(v[:, :sk])[None], causal=causal)[0]
        out = FA.flash_attention(torch.from_numpy(q),
                                 torch.from_numpy(k[:, :sk]).contiguous(),
                                 torch.from_numpy(v[:, :sk]).contiguous(),
                                 causal=causal)
        assert out.shape == (2, 128, 32)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("B,S,D,N,bd", [(2, 16, 32, 4, 16),
                                        (1, 64, 128, 16, 64),
                                        (2, 33, 48, 8, 16),
                                        (1, 20, 100, 8, 64)])
def test_plain_selective_scan_matches_pallas(B, S, D, N, bd):
    rng = np.random.default_rng(B * S + D + N)
    x = (rng.normal(size=(B, S, D)) * 0.5).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, S, D))) * 0.1).astype(np.float32)
    b = rng.normal(size=(B, S, N)).astype(np.float32)
    c = rng.normal(size=(B, S, N)).astype(np.float32)
    a = -(np.abs(rng.normal(size=(D, N))) + 0.1).astype(np.float32)
    d = rng.normal(size=(D,)).astype(np.float32)
    ref = ref_ops.selective_scan(*map(jnp.asarray, (x, dt, b, c, a, d)),
                                 bd=bd)
    out = SS.selective_scan(*map(torch.from_numpy, (x, dt, b, c, a, d)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_new_wrappers_count_plain_calls_and_check_shapes():
    for m in (K, FA, SS):
        m.reset_counts()
    q = torch.zeros((2, 8, 16))
    FA.flash_attention(q, q[:1], q[:1])                   # GQA group 2
    x = torch.zeros((1, 4, 8))
    s = torch.zeros((1, 4, 2))
    SS.selective_scan(x, x, s, s, torch.zeros((8, 2)), torch.zeros(8))
    assert FA.PLAIN_CALLS == {"flash_attention": 1}
    assert SS.PLAIN_CALLS == {"selective_scan": 1}
    assert sum(K.PLAIN_CALLS.values()) == 0
    assert FA.LAUNCHES == {"flash_attention": 0}
    assert SS.LAUNCHES == {"selective_scan": 0}
    FA.reset_counts()
    SS.reset_counts()
    assert FA.PLAIN_CALLS["flash_attention"] == 0
    assert SS.PLAIN_CALLS["selective_scan"] == 0
    with pytest.raises(ValueError, match="divid"):
        FA.flash_attention(q, q[:1].expand(3, 8, 16), q[:1].expand(3, 8, 16))
    with pytest.raises(ValueError, match="Sq == Sk"):
        FA.flash_attention(q, q[:, :4], q[:, :4], causal=True)
    with pytest.raises(ValueError, match="selective_scan"):
        SS.selective_scan(x, x, s, s, torch.zeros((7, 2)), torch.zeros(8))
