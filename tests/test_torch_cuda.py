"""Card-only tests of the port: the hand-written max-plus kernel against its
plain PyTorch version on the card, and the blocked Explorer path on the
card.  Every test is marked ``cuda`` and skips where no card is present.

This file imports neither ``jax`` nor ``repro``, so it runs on a machine
that has only PyTorch:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, whose fixtures load the JAX
package.)  Max-plus ⊗ is exact — one float32 add, then a max — so the
kernel must equal the plain version bit for bit (``torch.equal``).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.aidg import explorer as port_ex
from repro_torch.kernels import maxplus as K

NEG = -1e18
GOLDEN_THETA1_CYCLES = [3832.0, 1187.0, 2954.0, 980.0, 2753.0, 91.0, 91.0,
                        3881.0, 225.0, 613.0]

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _operand(rng, shape, neg_frac=0.2):
    """float32 values in [-500, 500] with a ``neg_frac`` share of NEG."""
    x = rng.uniform(-500, 500, size=shape).astype(np.float32)
    x[rng.random(shape) < neg_frac] = NEG
    return torch.from_numpy(x)


@pytest.mark.parametrize("b,m,k,n", [(64, 128, 128, 128), (3, 100, 70, 130),
                                     (5, 33, 17, 5), (2, 1, 1, 1),
                                     (1, 200, 300, 65)])
def test_kernel_matmul_equals_plain(card, b, m, k, n):
    rng = np.random.default_rng(b + m + k + n)
    A, B = _operand(rng, (b, m, k)), _operand(rng, (b, k, n))
    launches = K.LAUNCHES["maxplus_matmul"]
    out = K.maxplus_matmul(A.to(card), B.to(card))
    torch.cuda.synchronize()
    assert K.LAUNCHES["maxplus_matmul"] == launches + 1
    assert torch.equal(out.cpu(), K.maxplus_matmul_torch(A, B))


@pytest.mark.parametrize("b,m,k", [(64, 128, 128), (3, 70, 33), (2, 1, 1),
                                   (1, 9, 300)])
def test_kernel_matvec_equals_plain(card, b, m, k):
    rng = np.random.default_rng(b * m + k)
    A, v = _operand(rng, (b, m, k)), _operand(rng, (b, k))
    launches = K.LAUNCHES["maxplus_matvec"]
    out = K.maxplus_matvec(A.to(card), v.to(card))
    torch.cuda.synchronize()
    assert K.LAUNCHES["maxplus_matvec"] == launches + 1
    assert torch.equal(out.cpu(), K.maxplus_matvec_torch(A, v))


def test_kernel_rejects_what_it_cannot_take(card):
    A = torch.zeros((2, 4, 4), device=card)
    with pytest.raises(TypeError):
        K.maxplus_matmul(A.double(), A.double())
    with pytest.raises(ValueError, match="contiguous"):
        K.maxplus_matmul(A.transpose(1, 2), A)
    with pytest.raises(ValueError, match="devices"):
        K.maxplus_matmul(A, A.cpu())


def test_blocked_explorer_on_card_matches_cpu(card):
    """The default matrix on the card: θ = 1 equals the golden cycles, the
    kernels ran and the plain versions did not, and a few random
    candidates equal the same path on the CPU (rtol 1e-6: the kernel is
    exact, the surrounding sums may round in another order)."""
    cand = port_ex.random_candidates(port_ex.DEFAULT_SPACE, 8, seed=3)
    K.reset_counts()
    ex = port_ex.Explorer(engine="blocked", device=card)
    res = ex.explore(cand)
    assert K.LAUNCHES["maxplus_matmul"] > 0
    assert K.LAUNCHES["maxplus_matvec"] > 0
    assert sum(K.PLAIN_CALLS.values()) == 0
    assert ex.baselines.tolist() == GOLDEN_THETA1_CYCLES
    cpu = port_ex.Explorer(engine="blocked", device="cpu").explore(cand)
    assert np.array_equal(res.cycles[0], cpu.cycles[0])
    np.testing.assert_allclose(res.cycles, cpu.cycles, rtol=1e-6)
