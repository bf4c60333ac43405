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
from repro.kernels.maxplus import maxplus_matvec_pallas
from repro_torch.core.aidg import maxplus as port_mp
from repro_torch.kernels import maxplus as K

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
    K.maxplus_matmul(A, A)
    K.maxplus_matvec(A, torch.zeros((2, 4)))
    assert K.PLAIN_CALLS == {"maxplus_matmul": 1, "maxplus_matvec": 1}
    assert K.LAUNCHES == {"maxplus_matmul": 0, "maxplus_matvec": 0}
    K.reset_counts()
    assert K.PLAIN_CALLS == {"maxplus_matmul": 0, "maxplus_matvec": 0}


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
