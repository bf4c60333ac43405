"""Card-only tests of the port: each hand-written kernel (max-plus,
flash attention, selective scan, systolic GEMM) against its plain PyTorch
version on the card, the blocked and packed Explorer paths and the
packed soft gradients, the ``kernels.ops`` wrappers, a small LM
forward through the kernels, training (a train step against the CPU's,
crash-resume), MLA through the flash kernel at Dq != Dv and whisper's
encoder.
Every test is marked ``cuda`` and skips where no card is present.

This file imports neither ``jax`` nor ``repro``, so it runs on a machine
that has only PyTorch:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, whose fixtures load the JAX
package.)  Max-plus ⊗ is exact — one float32 add, then a max — so the
kernel must equal the plain version bit for bit (``torch.equal``); the
attention and scan kernels are held to the reference's own kernel-test
tolerances, with TF32 off for the float32 plain versions; the GEMM is
held element by element within ``systolic_gemm.error_bound`` (float32
summation order, and one bf16 rounding each side for bf16 outputs).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.aidg import explorer as port_ex
from repro_torch.core.aidg import maxplus as port_mp
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import maxplus as K
from repro_torch.kernels import ops
from repro_torch.kernels import selective_scan as SS
from repro_torch.kernels import systolic_gemm as SG
from repro_torch.models import get_model
from repro_torch.models import lm as port_lm

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
    closure kernel ran in lower mode with both propagation matvecs, the
    general matmul and matvec and the plain versions did not, and a few
    random candidates equal the same path on the CPU (rtol 1e-6: the
    kernels are exact, the surrounding sums may round in another order)."""
    cand = port_ex.random_candidates(port_ex.DEFAULT_SPACE, 8, seed=3)
    K.reset_counts()
    ex = port_ex.Explorer(engine="blocked", device=card)
    res = ex.explore(cand)
    assert K.LAUNCHES["maxplus_closure"] > 0
    assert K.VARIANT_LAUNCHES["closure_lower"] == K.LAUNCHES["maxplus_closure"]
    assert K.LAUNCHES["maxplus_matvec_lower"] > 0
    assert K.LAUNCHES["maxplus_matvec_folded"] > 0
    assert K.LAUNCHES["maxplus_matmul"] == 0
    assert K.LAUNCHES["maxplus_matvec"] == 0
    assert sum(K.PLAIN_CALLS.values()) == 0
    assert ex.baselines.tolist() == GOLDEN_THETA1_CYCLES
    cpu = port_ex.Explorer(engine="blocked", device="cpu").explore(cand)
    assert np.array_equal(res.cycles[0], cpu.cycles[0])
    np.testing.assert_allclose(res.cycles, cpu.cycles, rtol=1e-6)


# ---------------------------------------------------------------------------
# the blocked engine's closure and propagation kernels
# ---------------------------------------------------------------------------


def _structure(rng, shape, lower, neg_frac=0.6):
    """Edge delays in [0, 64) with a ``neg_frac`` share of NEG; strictly
    lower-triangular blocks when ``lower`` (lower mode's input), dense
    (values in [-500, 500], the diagonal too) otherwise."""
    n = shape[-1]
    if lower:
        x = rng.uniform(0, 64, size=shape).astype(np.float32)
        x[rng.random(shape) < neg_frac] = NEG
        x[..., ~np.tril(np.ones((n, n), bool), -1)] = NEG
        return torch.from_numpy(x)
    return _operand(rng, shape, neg_frac)


@pytest.mark.parametrize("n", [16, 32, 77, 128])
@pytest.mark.parametrize("variant", ["closure_lower", "closure_full"])
@pytest.mark.parametrize("form", ["structure + work", "whole"])
def test_kernel_closure_equals_plain(card, n, variant, form):
    """One launch for the batch, lower and full mode, with the work folded
    in (3 structure blocks x 5 items) or whole blocks (7): bit for bit the
    plain squaring loop; batches far below one wave of the grid."""
    rng = np.random.default_rng(n + len(variant) + len(form))
    steps = int(np.ceil(np.log2(n)))
    lower = variant == "closure_lower"
    if form == "whole":
        D, w = _structure(rng, (7, n, n), lower), None
    else:
        D = _structure(rng, (3, n, n), lower)
        w = torch.from_numpy(rng.uniform(1, 500, (3, 5, n))
                             .astype(np.float32))
    launches = K.LAUNCHES["maxplus_closure"]
    mode = K.VARIANT_LAUNCHES[variant]
    args = (D.to(card), steps, None if w is None else w.to(card))
    out = K.maxplus_closure(*args, variant=variant)
    again = K.maxplus_closure(*args, variant=variant)
    torch.cuda.synchronize()
    assert K.LAUNCHES["maxplus_closure"] == launches + 2
    assert K.VARIANT_LAUNCHES[variant] == mode + 2
    want = K.maxplus_closure_torch(D, steps, w)
    assert out.shape == want.shape
    assert torch.equal(out.cpu(), want)
    assert torch.equal(out, again)              # deterministic


@pytest.mark.parametrize("lower", [False, True])
def test_public_closure_takes_full_mode(card, lower):
    """``core.aidg.maxplus.maxplus_closure`` sends n <= 128 to the closure
    kernel in full mode, one launch, whatever the structure of M: bit for
    bit the plain squaring loop."""
    rng = np.random.default_rng(11 + lower)
    M = _structure(rng, (2, 3, 40, 40), lower)
    before = dict(K.VARIANT_LAUNCHES)
    out = port_mp.maxplus_closure(M.to(card), 6)
    torch.cuda.synchronize()
    assert K.VARIANT_LAUNCHES["closure_full"] == before["closure_full"] + 1
    assert K.VARIANT_LAUNCHES["closure_lower"] == before["closure_lower"]
    assert out.shape == M.shape
    assert torch.equal(out.cpu(), K.maxplus_closure_torch(
        M.reshape(6, 40, 40), 6).reshape(M.shape))


@pytest.mark.parametrize("n,b", [(16, 5), (32, 300), (77, 33), (128, 5),
                                 (128, 4096)])
def test_kernel_matvec_lower_equals_plain(card, n, b):
    """Closure blocks from lower mode times vectors with NEG entries and
    entries past 2^35: bit for bit the general matvec on the whole block."""
    rng = np.random.default_rng(n * b)
    D = _structure(rng, (1, n, n), True)
    w = torch.from_numpy(rng.uniform(1, 500, (1, b, n)).astype(np.float32))
    C = K.maxplus_closure(D.to(card), int(np.ceil(np.log2(n))), w.to(card),
                          variant="closure_lower")[0]
    h = rng.uniform(-1, 1, (b, n)) * np.where(rng.random((b, n)) < 0.5,
                                              4096.0, 2.0 ** 40)
    h[rng.random((b, n)) < 0.2] = NEG
    h = torch.from_numpy(h.astype(np.float32)).to(card)
    launches = K.LAUNCHES["maxplus_matvec_lower"]
    out = K.maxplus_matvec_lower(C, h)
    again = K.maxplus_matvec_lower(C, h)
    torch.cuda.synchronize()
    assert K.LAUNCHES["maxplus_matvec_lower"] == launches + 2
    assert torch.equal(out.cpu(), K.maxplus_matvec_torch(C.cpu(), h.cpu()))
    assert torch.equal(out, again)


@pytest.mark.parametrize("n,b", [(16, 5), (32, 300), (77, 33), (128, 17),
                                 (128, 4096)])
@pytest.mark.parametrize("all_neg", [False, True])
def test_kernel_matvec_folded_equals_plain(card, n, b, all_neg):
    """max(h0, (D + w) ⊗ prev) without writing D + w, also with block 0's
    all-NEG structure: bit for bit the plain two-step version."""
    rng = np.random.default_rng(n + b + all_neg)
    D = (torch.full((n, n), NEG) if all_neg
         else _structure(rng, (n, n), False, 0.8))
    w, prev, h0 = (torch.from_numpy(rng.uniform(lo, hi, (b, n))
                                    .astype(np.float32))
                   for lo, hi in ((1, 500), (0, 8000), (0, 8000)))
    prev[torch.from_numpy(rng.random((b, n)) < 0.1)] = NEG
    launches = K.LAUNCHES["maxplus_matvec_folded"]
    args = [t.to(card) for t in (D, w, prev, h0)]
    out = K.maxplus_matvec_folded(*args)
    again = K.maxplus_matvec_folded(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["maxplus_matvec_folded"] == launches + 2
    assert torch.equal(out.cpu(), K.maxplus_matvec_folded_torch(D, w, prev,
                                                                h0))
    assert torch.equal(out, again)


def test_closure_kernels_reject_what_they_cannot_take(card):
    big = torch.zeros((2, 129, 129), device=card)
    A = torch.zeros((2, 8, 8), device=card)
    v = torch.zeros((2, 8), device=card)
    with pytest.raises(ValueError, match="outside"):
        K.maxplus_closure(big, 1)
    with pytest.raises(ValueError, match="outside"):
        K.maxplus_matvec_lower(big, torch.zeros((2, 129), device=card))
    with pytest.raises(ValueError, match="outside"):
        K.maxplus_matvec_folded(big[0], *(torch.zeros((2, 129),
                                                      device=card),) * 3)
    with pytest.raises(TypeError):
        K.maxplus_closure(A.double(), 1)
    with pytest.raises(TypeError):
        K.maxplus_matvec_lower(A, v.double())
    with pytest.raises(ValueError, match="contiguous"):
        K.maxplus_closure(A.transpose(1, 2), 1)
    with pytest.raises(ValueError, match="contiguous"):
        K.maxplus_matvec_folded(A[0].t(), v, v, v)
    with pytest.raises(ValueError, match="devices"):
        K.maxplus_closure(A, 1, torch.zeros((2, 3, 8)))
    with pytest.raises(ValueError, match="devices"):
        K.maxplus_matvec_lower(A, v.cpu())
    with pytest.raises(ValueError, match="variant"):
        K.maxplus_closure(A, 1, variant="closure_upper")


# ---------------------------------------------------------------------------
# flash attention and selective scan (the LM path's kernels)
# ---------------------------------------------------------------------------


# float32: the tolerances of the reference's own kernel tests
# (tests/test_kernels.py); bfloat16: element by element within
# FA.bf16_error_bound, which follows from bf16 rounding (see its docstring)
FLASH_F32_TOL = dict(atol=2e-4, rtol=1e-3)
SCAN_TOL = dict(atol=1e-4, rtol=1e-4)


def assert_flash_close(out, q, k, v, causal=True, window=0):
    want = FA.flash_attention_torch(q, k, v, causal=causal, window=window)
    if q.dtype == torch.float32:
        torch.testing.assert_close(out, want, **FLASH_F32_TOL)
        return
    bound = FA.bf16_error_bound(q, k, v, causal=causal, window=window)
    err = (out.float() - want.float()).abs()
    assert bool((err <= bound).all()), (
        f"{int((err > bound).sum())} elements beyond the bf16 bound, max "
        f"|err| / bound {float((err / bound).max()):.3f}")


@pytest.fixture
def exact_f32():
    """Full float32 matmuls for the plain versions (no TF32)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


@pytest.mark.parametrize("bh,bkv,sq,sk,dq,dv,causal,window,dtype", [
    (2, 2, 128, 128, 64, 64, True, 0, torch.float32),
    (4, 4, 256, 256, 64, 64, True, 0, torch.float32),
    (1, 1, 160, 160, 64, 64, True, 0, torch.float32),       # ragged
    (2, 2, 128, 128, 64, 64, False, 0, torch.float32),      # non-causal
    (2, 2, 256, 256, 64, 64, True, 64, torch.float32),      # window
    (2, 2, 256, 256, 128, 128, True, 0, torch.float32),
    (8, 2, 200, 200, 128, 128, True, 0, torch.float32),     # GQA
    (2, 2, 128, 128, 128, 64, True, 0, torch.float32),      # Dv != Dq
    (3, 1, 100, 77, 16, 16, False, 0, torch.float32),       # Sq != Sk
    (2, 2, 300, 300, 120, 120, True, 100, torch.float32),   # h2o-danube
    # bf16, Dq == Dv == 128: the wgmma kernel
    (8, 2, 256, 256, 128, 128, True, 0, torch.bfloat16),
    (1, 1, 160, 160, 128, 128, True, 0, torch.bfloat16),    # ragged
    (2, 2, 256, 256, 128, 128, True, 64, torch.bfloat16),   # window
    (3, 1, 100, 77, 128, 128, False, 0, torch.bfloat16),    # Sq != Sk
    (1, 1, 128, 128, 128, 128, True, 0, torch.bfloat16),    # one tile
    (8, 2, 2048, 2048, 128, 128, True, 0, torch.bfloat16),  # group 4
    (2, 2, 2048, 2048, 128, 128, True, 0, torch.bfloat16),  # group 1
    (4, 1, 1000, 1000, 128, 128, True, 0, torch.bfloat16),  # ragged
    (2, 1, 77, 77, 128, 128, True, 0, torch.bfloat16),      # Sk < 128
    (2, 2, 77, 77, 128, 128, False, 0, torch.bfloat16),     # Sk < 128
    (4, 2, 1024, 1024, 128, 128, True, 256, torch.bfloat16),  # window
    (4, 2, 512, 512, 128, 128, True, 100, torch.bfloat16),  # window edge
    (3, 3, 1000, 1000, 128, 128, False, 0, torch.bfloat16),  # BH 3
    # bf16 elsewhere: the CUDA-core kernel
    (2, 2, 128, 128, 64, 64, True, 0, torch.bfloat16),
    (2, 2, 256, 256, 64, 64, True, 64, torch.bfloat16),     # window
    (3, 1, 100, 77, 64, 64, False, 0, torch.bfloat16),      # Sq != Sk
    (2, 2, 128, 128, 128, 64, True, 0, torch.bfloat16),     # Dv != Dq
    (2, 2, 96, 96, 32, 32, True, 0, torch.bfloat16),
    # h2o-danube's 120: the wgmma_120 instance
    (2, 2, 200, 200, 120, 120, True, 0, torch.bfloat16),
])
def test_kernel_flash_attention_matches_plain(card, exact_f32, bh, bkv, sq,
                                              sk, dq, dv, causal, window,
                                              dtype):
    rng = np.random.default_rng(bh * sq + dq + dv + window)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(dtype).to(card)
               for shape in ((bh, sq, dq), (bkv, sk, dq), (bkv, sk, dv)))
    launches = FA.LAUNCHES["flash_attention"]
    variant = FA.plan(dq, dv, dtype, True)
    assert variant == (FA.WGMMA_INSTANCES.get((dq, dv), "cuda_core")
                       if dtype == torch.bfloat16 else "cuda_core")
    before = FA.VARIANT_LAUNCHES[variant]
    out = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention"] == launches + 1
    assert FA.VARIANT_LAUNCHES[variant] == before + 1
    assert out.dtype == dtype and out.shape == (bh, sq, dv)
    assert_flash_close(out, q, k, v, causal=causal, window=window)


def _bf16_qkv(card, bh, bkv, sq, sk, seed, head_offset=0.0, dq=128, dv=128):
    """bf16 q, k, v (Dq, Dv = 128 unless given) from a seed; v of head h
    shifted by ``head_offset`` * h, so rows that land in another head's
    output stand out."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((bh, sq, dq), (bkv, sk, dq), (bkv, sk, dv)))
    v += head_offset * torch.arange(bkv, dtype=torch.float32)[:, None, None]
    return tuple(t.to(torch.bfloat16).to(card) for t in (q, k, v))


@pytest.mark.parametrize("bh,bkv,s,causal", [(3, 3, 200, True),
                                             (3, 3, 1000, False),
                                             (6, 3, 333, True)])
def test_wgmma_flash_keeps_each_head_to_itself(card, bh, bkv, s, causal):
    """Ragged S with several heads, each head's v offset by 8 h: the
    ragged query tile's TMA store is clipped at Sq of its own head (a 2-D
    map over heads x S would overwrite the next head's first rows, and a
    load past Sk would read the next head's keys).  Every head is held
    separately."""
    q, k, v = _bf16_qkv(card, bh, bkv, s, s, seed=bh + s, head_offset=8.0)
    assert FA.plan(128, 128, torch.bfloat16, FA._aligned16(q, k, v)) == "wgmma"
    out = FA.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = FA.flash_attention_torch(q, k, v, causal=causal).float()
    bound = FA.bf16_error_bound(q, k, v, causal=causal)
    for h in range(bh):
        err = (out[h].float() - want[h]).abs()
        assert bool((err <= bound[h]).all()), (
            f"head {h}: {int((err > bound[h]).sum())} elements beyond the "
            f"bf16 bound, max |err| {float(err.max()):.3e}")


@pytest.mark.parametrize("bh,bkv,s,causal,window", [
    (8, 2, 1000, True, 0), (4, 2, 512, True, 100), (3, 1, 77, False, 0)])
def test_wgmma_flash_is_deterministic(card, bh, bkv, s, causal, window):
    """Two calls on the same inputs give bit-equal outputs."""
    q, k, v = _bf16_qkv(card, bh, bkv, s, s, seed=11)
    before = FA.VARIANT_LAUNCHES["wgmma"]
    x = FA.flash_attention(q, k, v, causal=causal, window=window)
    y = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.VARIANT_LAUNCHES["wgmma"] == before + 2
    assert torch.equal(x, y)


@pytest.mark.parametrize("bh,bkv,sq,sk,causal,window", [
    (8, 2, 256, 256, True, 0), (1, 1, 160, 160, True, 0),
    (2, 2, 256, 256, True, 64), (3, 1, 100, 77, False, 0)])
def test_mma_sync_flash_kernel_still_matches_plain(card, bh, bkv, sq, sk,
                                                   causal, window):
    """The PR 12 tensor-core kernel, reached through the private launcher
    (the yardstick ``chip_smoke.py`` times beside the wgmma kernel)."""
    q, k, v = _bf16_qkv(card, bh, bkv, sq, sk, seed=bh * sq + window)
    before = FA.VARIANT_LAUNCHES["mma_sync"]
    out = FA._launch(q, k, v, causal, window, None, "mma_sync")
    torch.cuda.synchronize()
    assert FA.VARIANT_LAUNCHES["mma_sync"] == before + 1
    assert_flash_close(out, q, k, v, causal=causal, window=window)


def _scan_inputs(card, B, S, D, N, offset=0):
    """Scan inputs from a seed; ``offset`` > 0 makes x and dt contiguous
    views that start ``offset`` floats into their storage (misaligned for
    TMA when offset % 4 != 0)."""
    rng = np.random.default_rng(B * S + D + N)

    def f(a):
        flat = np.zeros(a.size + offset, np.float32)
        flat[offset:] = a.ravel()
        return torch.from_numpy(flat).to(card)[offset:].view(a.shape)
    x = f(rng.normal(size=(B, S, D)) * 0.5)
    dt = f(np.abs(rng.normal(size=(B, S, D))) * 0.1)
    b, c = f(rng.normal(size=(B, S, N))), f(rng.normal(size=(B, S, N)))
    a = f(-(np.abs(rng.normal(size=(D, N))) + 0.1))
    d = f(rng.normal(size=(D,)))
    return x, dt, b, c, a, d


@pytest.mark.parametrize("B,S,D,N,offset", [
    (2, 16, 32, 4, 0), (1, 64, 128, 16, 0), (2, 33, 48, 8, 0),
    (1, 20, 100, 8, 0), (2, 33, 100, 8, 0), (1, 130, 260, 16, 0),
    (2, 40, 64, 1, 0), (1, 50, 96, 3, 0), (2, 17, 36, 5, 0),  # N 1, 3, 5
    (3, 1, 128, 16, 0), (1, 1, 100, 5, 0),                  # S = 1
    (2, 47, 512, 16, 0), (1, 100, 200, 8, 0),  # S not a multiple of 16
    (1, 70, 8192, 16, 0),                                   # D 8192, B 1
    (2, 33, 100, 8, 1), (1, 64, 128, 16, 3),                # misaligned
])
def test_kernel_selective_scan_matches_plain(card, B, S, D, N, offset):
    """The kernel ``plan`` picks (the ring, or the PR 12 kernel for a
    misaligned view or D % 4 != 0) against the plain version; two calls
    equal bit for bit; the PR 12 kernel on the same inputs within the
    same tolerance."""
    x, dt, b, c, a, d = ins = _scan_inputs(card, B, S, D, N, offset)
    p = SS.plan(B, S, D, N, SS._aligned16(x, dt))
    assert p.variant == ("pr12" if offset % 4 else "ring")
    launches = SS.LAUNCHES["selective_scan"]
    before = dict(SS.VARIANT_LAUNCHES)
    out = SS.selective_scan(*ins)
    again = SS.selective_scan(*ins)
    torch.cuda.synchronize()
    assert SS.LAUNCHES["selective_scan"] == launches + 2
    assert {v: SS.VARIANT_LAUNCHES[v] - before[v] for v in SS.VARIANTS} == {
        v: 2 * (v == p.variant) for v in SS.VARIANTS}
    assert torch.equal(out, again)
    want = SS.selective_scan_torch(*ins)
    torch.testing.assert_close(out, want, **SCAN_TOL)
    torch.testing.assert_close(SS._launch(*ins, "pr12"), want, **SCAN_TOL)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_ring_kernel_every_lane_count_matches_plain(card, lanes):
    """Every lane split the library has, at a ragged D and S (the sweep
    ``tools/scan_breakdown.py`` times), and the library's shared memory
    as ``ring_smem_bytes`` mirrors it."""
    x, dt, b, c, a, d = ins = _scan_inputs(card, 2, 37, 200, 16)
    before = SS.VARIANT_LAUNCHES["ring"]
    out = SS._launch(*ins, SS.ring_plan(2, 200, lanes))
    torch.cuda.synchronize()
    assert SS.VARIANT_LAUNCHES["ring"] == before + 1
    torch.testing.assert_close(out, SS.selective_scan_torch(*ins), **SCAN_TOL)
    lib = SS._build.load(SS.SOURCE, SS._bind)
    assert lib.selective_scan_ring_steps() == SS.RING_STEPS
    for n in (1, 5, 16):
        if lanes <= SS.padded_states(n):
            assert (lib.selective_scan_ring_smem_bytes(
                lanes, SS.padded_states(n)) == SS.ring_smem_bytes(lanes, n))


def test_flash_attention_unaligned_bf16_matches_plain(card):
    """bf16 tensors that are contiguous but not 16-byte aligned (a storage
    offset of one element) take the CUDA-core kernel; same function."""
    before = FA.VARIANT_LAUNCHES["cuda_core"]
    rng = np.random.default_rng(9)
    views = []
    for shape in ((4, 128, 128), (2, 128, 128), (2, 128, 128)):
        flat = torch.from_numpy(rng.normal(size=int(np.prod(shape)) + 1)
                                .astype(np.float32)).to(torch.bfloat16)
        views.append(flat.to(card)[1:].view(shape))
    q, k, v = views
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    assert_flash_close(FA.flash_attention(q, k, v, causal=True), q, k, v)
    assert FA.VARIANT_LAUNCHES["cuda_core"] == before + 1


def test_new_kernels_reject_what_they_cannot_take(card):
    q = torch.zeros((2, 8, 16), device=card)
    with pytest.raises(TypeError):
        FA.flash_attention(q, q.half(), q)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           q, q)
    wide = torch.zeros((2, 8, FA.MAX_HEAD_DIM + 8), device=card)
    with pytest.raises(ValueError, match="head dims"):
        FA.flash_attention(wide, wide, wide)
    x = torch.zeros((1, 4, 8), device=card)
    s = torch.zeros((1, 4, 2), device=card)
    with pytest.raises(TypeError):
        SS.selective_scan(x.double(), x, s, s, torch.zeros((8, 2),
                                                           device=card),
                          torch.zeros(8, device=card))
    n = SS.MAX_STATE + 1
    s = torch.zeros((1, 4, n), device=card)
    with pytest.raises(ValueError, match="N <="):
        SS.selective_scan(x, x, s, s, torch.zeros((8, n), device=card),
                          torch.zeros(8, device=card))


def test_lm_forward_on_card_goes_through_the_kernels(card, exact_f32):
    """jamba's smoke config on the card, float32: the kernel impls agree
    with the plain impls (the reference's integration tolerance), flash
    attention launched once and the scan 7 times, no plain version ran."""
    cfg = replace(get_smoke_config("jamba_v01_52b"), compute_dtype="float32")
    model = get_model(cfg)
    params = model.init_params(0, device=card)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64))).to(card)
    FA.reset_counts()
    SS.reset_counts()
    with torch.no_grad():       # the kernels have no backward
        kern = port_lm.forward(params, replace(
            cfg, attention_impl="flash_pallas", ssm_impl="pallas"), toks)
    assert FA.LAUNCHES["flash_attention"] == 1
    assert SS.LAUNCHES["selective_scan"] == 7
    assert SS.VARIANT_LAUNCHES["ring"] == 7
    assert FA.PLAIN_CALLS["flash_attention"] == 0
    assert SS.PLAIN_CALLS["selective_scan"] == 0
    with torch.no_grad():
        plain = port_lm.forward(params, cfg, toks)
    torch.testing.assert_close(kern, plain, atol=3e-4, rtol=1e-3)


@pytest.mark.parametrize("m,k,n", [(37, 53, 29), (64, 200, 96),
                                   (300, 256, 264)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", [0, 1])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernel_systolic_gemm_matches_plain(card, m, k, n, dtype, activation,
                                            out_dtype):
    """Ragged shapes and 16-byte-aligned ones, one and several output
    tiles: float32 on the f32 kernel (element-by-element and vector
    loads); bf16 37x53x29 on mma_sync, 64x200x96 on split-K (M <= 64),
    300x256x264 on wgmma (ragged M and N)."""
    rng = np.random.default_rng(m * k + n)
    a, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(dtype).to(card) for s in ((m, k), (k, n)))
    launches = SG.LAUNCHES["systolic_gemm"]
    out = SG.systolic_gemm(a, b, activation=activation, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert SG.LAUNCHES["systolic_gemm"] == launches + 1
    assert out.dtype == out_dtype and out.shape == (m, n)
    want = SG.systolic_gemm_torch(a, b, activation=activation,
                                  out_dtype=out_dtype)
    err = (out.float() - want.float()).abs()
    bound = SG.error_bound(a, b, want)
    assert bool((err <= bound).all()), (
        f"{int((err > bound).sum())} elements beyond the bound, max |err| "
        f"{float(err.max()):.3e}")
    if activation == 1:
        assert float(out.float().min()) >= 0.0


def test_systolic_gemm_rejects_what_it_cannot_take(card):
    a = torch.zeros((8, 16), device=card)
    b = torch.zeros((16, 4), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        SG.systolic_gemm(a, torch.zeros((4, 16), device=card).t())
    with pytest.raises(ValueError, match="one CUDA device"):
        SG.systolic_gemm(a, b.cpu())
    with pytest.raises(TypeError):
        SG.systolic_gemm(a, b.bfloat16())
    with pytest.raises(TypeError):
        SG.systolic_gemm(a.double(), b.double())
    with pytest.raises(ValueError, match="not \\(M, K\\)"):
        SG.systolic_gemm(a, a)
    with pytest.raises(ValueError, match="activation"):
        SG.systolic_gemm(a, b, activation=2)


def _gemm_inputs(card, m, k, n, dtype=torch.bfloat16, seed=None):
    rng = np.random.default_rng(m * k + n if seed is None else seed)
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(dtype).to(card) for s in ((m, k), (k, n)))


def _assert_gemm_close(out, a, b, activation, out_dtype):
    assert out.dtype == out_dtype and out.shape == (a.shape[0], b.shape[1])
    want = SG.systolic_gemm_torch(a, b, activation=activation,
                                  out_dtype=out_dtype)
    err = (out.float() - want.float()).abs()
    bound = SG.error_bound(a, b, want)
    assert bool((err <= bound).all()), (
        f"{int((err > bound).sum())} elements beyond the bound, max |err| "
        f"{float(err.max()):.3e}, max |err| / bound "
        f"{float((err / bound).max()):.3f}")


GEMM_VARIANT_CASES = (
    [("wgmma", 128, 64, 256), ("wgmma", 300, 256, 264),
     ("wgmma", 8192, 2048, 2048)]
    + [("splitk", m, 2048, n) for m in (1, 8, 17, 64) for n in (2048, 264)])


@pytest.mark.parametrize("variant,m,k,n", GEMM_VARIANT_CASES)
@pytest.mark.parametrize("activation", [0, 1])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_systolic_gemm_variants_match_plain(card, variant, m, k, n,
                                            activation, out_dtype):
    """The wgmma kernel (a single 128 x 256 tile, ragged M and N, a
    persistent grid of many tiles) and the split-K kernel (M from 1 to 64,
    N a whole and a ragged number of 128-column panels) against the plain
    version, each reached through ``plan`` and counted."""
    a, b = _gemm_inputs(card, m, k, n)
    p = SG.plan(m, k, n, torch.bfloat16, True,
                sms=torch.cuda.get_device_properties(card)
                .multi_processor_count)
    assert p.variant == variant
    before = dict(SG.VARIANT_LAUNCHES)
    out = SG.systolic_gemm(a, b, activation=activation, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert SG.VARIANT_LAUNCHES[variant] == before[variant] + 1
    assert sum(SG.VARIANT_LAUNCHES.values()) == sum(before.values()) + 1
    _assert_gemm_close(out, a, b, activation, out_dtype)


@pytest.mark.parametrize("m,k,n", [(37, 53, 29), (64, 200, 96),
                                   (300, 256, 264)])
def test_mma_sync_kernel_keeps_ragged_shapes(card, m, k, n):
    """The mma.sync kernel, through the private launcher with its
    own plan, at the ragged shapes of the test above; and a 64x200x96
    product whose views start 2 bytes past a 16-byte boundary reaches it
    through the public path."""
    a, b = _gemm_inputs(card, m, k, n)
    p = SG.plan(m, k, n, torch.bfloat16, False)
    assert p.variant == "mma_sync"
    before = SG.VARIANT_LAUNCHES["mma_sync"]
    out = SG._launch(a, b, 1, torch.float32, p)
    torch.cuda.synchronize()
    assert SG.VARIANT_LAUNCHES["mma_sync"] == before + 1
    _assert_gemm_close(out, a, b, 1, torch.float32)
    if (m, k, n) == (64, 200, 96):
        a1 = torch.empty(m * k + 1, dtype=a.dtype, device=card)[1:]
        a1.copy_(a.reshape(-1))
        a1 = a1.view(m, k)
        out = SG.systolic_gemm(a1, b)
        torch.cuda.synchronize()
        assert SG.VARIANT_LAUNCHES["mma_sync"] == before + 2
        _assert_gemm_close(out, a1, b, 0, torch.float32)


@pytest.mark.parametrize("m,k,n,variant", [(8, 2048, 2048, "splitk"),
                                           (1, 2048, 264, "splitk"),
                                           (300, 256, 264, "wgmma"),
                                           (37, 53, 29, "mma_sync")])
def test_systolic_gemm_is_deterministic(card, m, k, n, variant):
    """Two calls on the same inputs give bit-equal outputs -- split-K's
    partial sums included (added in split order, no float atomics)."""
    a, b = _gemm_inputs(card, m, k, n, seed=7)
    before = SG.VARIANT_LAUNCHES[variant]
    x = SG.systolic_gemm(a, b, activation=1)
    y = SG.systolic_gemm(a, b, activation=1)
    torch.cuda.synchronize()
    assert SG.VARIANT_LAUNCHES[variant] == before + 2
    assert torch.equal(x, y)


def test_ops_wrappers_launch_kernels_on_card(card, exact_f32):
    """``kernels.ops`` on CUDA tensors launches the kernels, never a plain
    version -- non-causal ragged keys included (the reference drops to its
    plain version there)."""
    rng = np.random.default_rng(5)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)
                                    ).to(card)
    for mod in (K, FA, SS, SG):
        mod.reset_counts()
    a, b = f(37, 53), f(53, 29)
    assert torch.equal(ops.maxplus_matmul(a, b).cpu(),
                       K.maxplus_matmul_torch(a.cpu()[None], b.cpu()[None])[0])
    g = ops.gemm(a, b, activation=1)
    assert bool((g - SG.systolic_gemm_torch(a, b, activation=1)).abs().le(
        SG.error_bound(a, b, g)).all())
    q, kk, v = f(2, 3, 100, 64), f(2, 3, 77, 64), f(2, 3, 77, 32)
    o = ops.flash_attention(q, kk, v, causal=False)
    assert o.shape == (2, 3, 100, 32)
    want = FA.flash_attention_torch(q.reshape(6, 100, 64),
                                    kk.reshape(6, 77, 64),
                                    v.reshape(6, 77, 32), causal=False)
    torch.testing.assert_close(o.reshape(6, 100, 32), want, atol=2e-4,
                               rtol=1e-3)
    x, dt = f(2, 33, 100) * 0.5, f(2, 33, 100).abs() * 0.1
    bb, cc = f(2, 33, 8), f(2, 33, 8)
    aa, dd = -(f(100, 8).abs() + 0.1), f(100)
    torch.testing.assert_close(ops.selective_scan(x, dt, bb, cc, aa, dd),
                               SS.selective_scan_torch(x, dt, bb, cc, aa, dd),
                               **SCAN_TOL)
    for mod, name in ((K, "maxplus_matmul"), (FA, "flash_attention"),
                      (SS, "selective_scan"), (SG, "systolic_gemm")):
        assert mod.LAUNCHES[name] == 1, name
        assert mod.PLAIN_CALLS[name] == 0, name


def test_packed_explorer_on_card_matches_golden(card):
    """The default Explorer (engine "packed") on the card: θ = 1 equals the
    golden cycles exactly, and random candidates agree with the CPU run of
    the same code."""
    ex = port_ex.Explorer(device=card)
    assert ex.engine == "packed"
    assert ex.baselines.tolist() == GOLDEN_THETA1_CYCLES
    cand = port_ex.random_candidates(port_ex.DEFAULT_SPACE, 16, seed=3)
    gpu = ex.evaluate(cand)
    cpu = port_ex.Explorer(device="cpu").evaluate(cand)
    np.testing.assert_allclose(gpu, cpu, rtol=1e-5)


@pytest.mark.parametrize("B", [8, 13])
def test_sharded_split_on_card_is_bit_for_bit(card, B):
    """The sharded evaluator's split, with one card standing in for four:
    padded to a multiple of 4, cut into 4 slices, gathered in order — bit
    for bit the unsharded evaluation, with and without ``chunk``."""
    ex = port_ex.Explorer(port_ex.default_scenarios()[:4], device=card)
    pm = ex.packed_matrix()
    cand = port_ex.random_candidates(port_ex.DEFAULT_SPACE, B, seed=5)
    cycles, energy = pm.evaluate_full(cand)
    for chunk in (None, 5):
        c, e = pm._evaluate_split(cand, chunk, [card] * 4)
        assert np.array_equal(c, cycles) and np.array_equal(e, energy)
    assert pm.n_shards() == torch.cuda.device_count()
    c, e = pm.evaluate_full(cand, sharded=True)
    assert np.array_equal(c, cycles) and np.array_equal(e, energy)


def test_small_service_answers_on_card(card):
    """A 2-cell DSEService on the card: packed answers equal to the CPU
    service's designs, a surrogate trained on the card routes queries, and
    the sharded service answers as the unsharded one."""
    from repro_torch.serve import DSEService, Query
    from repro_torch.surrogate import SurrogateConfig, train_surrogate

    scs = port_ex.default_scenarios()[:2]
    q = Query.make(workload="gemm", top_k=3)
    with DSEService(scenarios=scs, pool=16, seed=1, device=card) as svc, \
            DSEService(scenarios=scs, pool=16, seed=1, sharded=True,
                       device=card) as shard, \
            DSEService(scenarios=scs, pool=16, seed=1, device="cpu") as cpu:
        a, b = svc.query(q), cpu.query(q)
        assert svc.explorer.device.type == "cuda"
        assert a.tier == "packed" and a.cells == b.cells
        assert [d.theta for d in a.designs] == [d.theta for d in b.designs]
        np.testing.assert_allclose([d.latency for d in a.designs],
                                   [d.latency for d in b.designs],
                                   rtol=1e-5)
        assert shard.query(q) == a
        bundle = train_surrogate(svc.explorer,
                                 SurrogateConfig(n_samples=48, steps=250))
    with DSEService(svc.explorer, pool=16, seed=1, surrogate=bundle,
                    surrogate_max_err=10.0) as fast:
        assert fast.query(q).tier == "surrogate"


def _fd_rows(k0: np.ndarray, eps: float) -> np.ndarray:
    """Central-difference rows around each knob of ``k0`` (1, K)."""
    K_ = k0.shape[1]
    rows = np.repeat(k0, 2 * K_, axis=0)
    rows[np.arange(0, 2 * K_, 2), np.arange(K_)] += eps
    rows[np.arange(1, 2 * K_, 2), np.arange(K_)] -= eps
    return rows


def test_packed_grad_fn_on_card_matches_cpu(card):
    """The soft packed gradient on the card against the same code on the
    CPU, on 4 cells at two random knob rows: values rtol 1e-5 (float32
    exp/log1p of the two devices differ by an ulp or two, and sums of the
    soft reductions run in another order); gradients within 2e-3 — the
    bound the CPU port keeps to central differences of the reference's
    values (``tests/test_torch_gradient.py``), since a near-tie that the
    CPU splits evenly may break one way on the card; and the card's
    gradient within 5% of its own central differences at τ = 0.2 (the
    reference's finite-difference gate)."""
    scs = port_ex.default_scenarios()[:4]
    gpu = port_ex.Explorer(scs, device=card)
    cpu = port_ex.Explorer(scs, device="cpu")
    rng = np.random.default_rng(11)
    k = np.exp(rng.uniform(-0.5, 0.5, (2, 5))).astype(np.float32)
    fg = gpu.packed_matrix().grad_fn(gpu.baselines)
    fc = cpu.packed_matrix().grad_fn(cpu.baselines)
    for tau in (0.5, 0.05):
        vg, gg = fg(k, tau)
        vc, gc = fc(k, tau)
        assert vg.device.type == "cuda" and gg.shape == (2, 5)
        np.testing.assert_allclose(vg.cpu().numpy(), vc.numpy(), rtol=1e-5)
        assert np.abs(gg.cpu().numpy() - gc.numpy()).max() <= 2e-3, tau
    eps = 1e-2
    v, g = fg(np.concatenate([k[:1], _fd_rows(k[:1], eps)]), 0.2)
    v = v.cpu().numpy().astype(np.float64)
    fd = (v[1::2] - v[2::2]) / (2 * eps)
    g = g.cpu().numpy()[0]
    assert np.all(np.abs(fd - g) <= 5e-2 * np.maximum(1.0, np.abs(fd)))


def test_soft_gradients_finite_on_card_at_small_tau(card):
    """τ = 0.01 (NEG/τ = -1e20, still finite in float32): every packed
    gradient and Jacobian entry, and a network cell's stacked gradient,
    finite on the card; the gradient search returns an in-box design."""
    from repro_torch.core.network import NetworkScenario
    ex = port_ex.Explorer(port_ex.default_scenarios()[:4], device=card)
    pm = ex.packed_matrix()
    k = np.ones((2, 5), np.float32)
    k[1] = 0.6
    _, g = pm.grad_fn(ex.baselines)(k, 0.01)
    _, j = pm.grad3_fn(ex.baselines, ex.energy_baselines)(k, 0.01)
    assert torch.isfinite(g).all() and torch.isfinite(j).all()
    cn = NetworkScenario("tpu_v5e", "olmo_1b", mode="pipelined").compile()
    fn = cn.grad_fn(cn.projection(port_ex.DEFAULT_SPACE), device=card)
    v, g = fn(k, 0.01)
    assert torch.isfinite(v).all() and torch.isfinite(g).all()
    theta = ex.refine(method="grad", starts=2, steps=3)
    lo = np.asarray([kn.lo for kn in ex.space.knobs])
    hi = np.asarray([kn.hi for kn in ex.space.knobs])
    assert np.all(theta >= lo - 1e-6) and np.all(theta <= hi + 1e-6)


# ---------------------------------------------------------------------------
# training (autograd through the LM; no kernel on this path)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmo_1b", "jamba_v01_52b"])
def test_train_step_on_card_matches_cpu(card, exact_f32, arch):
    """One ``make_train_step`` step of a smoke config (float32 compute,
    jamba with its 8 microbatches) on the card against the same step on
    the CPU from the same weights: loss and gradient norm within rtol
    1e-5; the first moments (after one step, the gradient, scaled) within
    1e-5 of each leaf's largest magnitude, the second (its square) within
    twice that; parameters within 2 lr of
    each other element by element (Adam's first step is sign-like, so an
    element whose gradient lies within rounding of zero may step the other
    way)."""
    import copy
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = replace(get_smoke_config(arch), compute_dtype="float32")
    cpu_model, cpu_state = init_train_state(
        cfg, torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to(card)
    gpu_state = adamw_init(dict(gpu_model.named_parameters()))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (8, 33))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = AdamWConfig(lr=1e-2)
    step = make_train_step(cfg, opt)
    _, cpu_state, cm = step(cpu_model, cpu_state, batch)
    _, gpu_state, gm = step(gpu_model, gpu_state, batch)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(gm[key]), float(cm[key]), rtol=1e-5)
    for (name, c), (_, g) in zip(cpu_model.named_parameters(),
                                 gpu_model.named_parameters()):
        d = g.detach().cpu() - c.detach()
        assert float(d.abs().max()) <= 2 * opt.lr, name
        for k, tol in (("m", 1e-5), ("v", 2e-5)):
            want = cpu_state[k][name]
            got = gpu_state[k][name].cpu()
            assert float((got - want).abs().max()) <= \
                tol * float(want.abs().max()), (k, name)


def test_crash_resume_on_card_is_exact(card, tmp_path):
    """``tests/test_train_e2e.py``'s contract on the card: 16 steps
    straight against a crash at step 12 after the step-8 checkpoint and a
    restart; step 15's loss within rtol 1e-5."""
    from repro_torch.launch.train import train_loop
    cfg = get_smoke_config("olmo_1b")
    kw = dict(steps=16, batch=4, seq=32, ckpt_every=8,
              print_fn=lambda *a: None, device=card)
    _, m_a = train_loop(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    with pytest.raises(RuntimeError, match="injected failure"):
        train_loop(cfg, ckpt_dir=str(tmp_path / "b"), fail_at_step=12, **kw)
    _, m_b = train_loop(cfg, ckpt_dir=str(tmp_path / "b"), **kw)
    last_a = [r for r in m_a.rows if r["step"] == 15][0]
    last_b = [r for r in m_b.rows if r["step"] == 15][0]
    np.testing.assert_allclose(last_a["loss"], last_b["loss"], rtol=1e-5)


def test_recorded_pass_refuses_the_kernels_on_card(card):
    """The kernels have no backward: a pass recorded by autograd with the
    kernel impls raises on the card (with autograd off it runs them)."""
    cfg = replace(get_smoke_config("jamba_v01_52b"),
                  attention_impl="flash_pallas")
    params = get_model(cfg).init_params(0, device=card)
    toks = torch.zeros((1, 16), dtype=torch.long, device=card)
    with pytest.raises(NotImplementedError, match="no backward"):
        port_lm.forward(params, cfg, toks)
    with torch.no_grad():
        assert torch.isfinite(port_lm.forward(params, cfg, toks)).all()


# ---------------------------------------------------------------------------
# MLA (minicpm3-4b) and the enc-dec family (whisper-small)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,dtype", [(1, 256, torch.float32),
                                       (1, 333, torch.float32),
                                       (1, 1000, torch.bfloat16),
                                       (2, 333, torch.bfloat16)])
def test_cuda_core_flash_at_mla_head_dims_matches_plain(card, exact_f32, b,
                                                        s, dtype):
    """MLA's prefill shape: 40 heads a batch row, Dq = dn + dr = 96,
    Dv = 64, causal, ragged S: float32 on the ``cuda_core`` kernel, bf16 on
    the ``wgmma_dv`` instance (the test keeps its name from when both took
    ``cuda_core``)."""
    rng = np.random.default_rng(b * s)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(dtype).to(card)
               for shape in ((40 * b, s, 96), (40 * b, s, 96),
                             (40 * b, s, 64)))
    variant = "wgmma_dv" if dtype == torch.bfloat16 else "cuda_core"
    assert FA.plan(96, 64, dtype, True) == variant
    before = dict(FA.VARIANT_LAUNCHES)
    out = FA.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    ran = {n: FA.VARIANT_LAUNCHES[n] - before[n] for n in FA.VARIANTS}
    assert ran == {n: int(n == variant) for n in FA.VARIANTS}
    assert out.dtype == dtype and out.shape == (40 * b, s, 64)
    assert_flash_close(out, q, k, v, causal=True)


@pytest.mark.parametrize("bh,bkv,sq,sk,causal,window", [
    (40, 40, 2016, 2016, True, 0),     # MLA's prefill of 2016 tokens
    (40, 40, 2048, 2048, True, 0),     # MLA's scoring shape
    (3, 3, 77, 77, True, 0),           # one ragged tile, Sk < 128
    (4, 4, 1000, 1000, True, 0),       # ragged
    (4, 4, 640, 640, False, 0),        # non-causal
    (3, 1, 100, 300, False, 0),        # Sq != Sk, GQA 3
    (4, 4, 1024, 1024, True, 256),     # window
    (4, 2, 512, 512, True, 100),       # window edge inside a tile, GQA 2
    (80, 40, 1000, 1000, True, 0),     # GQA: 80 query heads over 40
])
def test_wgmma_dv_flash_matches_plain(card, bh, bkv, sq, sk, causal,
                                      window):
    """The ``wgmma_dv`` instance (Dq 96, Dv 64) against the plain version,
    element by element within ``FA.bf16_error_bound``; exactly one launch,
    on that kernel."""
    q, k, v = _bf16_qkv(card, bh, bkv, sq, sk, seed=bh + sq + window,
                        dq=96, dv=64)
    assert FA.plan(96, 64, torch.bfloat16, FA._aligned16(q, k, v)) == (
        "wgmma_dv")
    before = dict(FA.VARIANT_LAUNCHES)
    out = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ran = {n: FA.VARIANT_LAUNCHES[n] - before[n] for n in FA.VARIANTS}
    assert ran == {n: int(n == "wgmma_dv") for n in FA.VARIANTS}
    assert out.dtype == torch.bfloat16 and out.shape == (bh, sq, 64)
    assert_flash_close(out, q, k, v, causal=causal, window=window)


@pytest.mark.parametrize("bh,bkv,s,causal", [(3, 3, 200, True),
                                             (3, 3, 1000, False),
                                             (6, 3, 333, True),
                                             (40, 40, 2016, True)])
def test_wgmma_dv_flash_keeps_each_head_to_itself(card, bh, bkv, s, causal):
    """As ``test_wgmma_flash_keeps_each_head_to_itself``, at Dq 96, Dv 64:
    the 192-byte q/k rows and 128-byte v/o rows of a ragged S stay in
    their own head (loads past Sk read zeros, the o store is clipped at
    Sq); every head is held separately."""
    q, k, v = _bf16_qkv(card, bh, bkv, s, s, seed=bh + s, head_offset=8.0,
                        dq=96, dv=64)
    before = FA.VARIANT_LAUNCHES["wgmma_dv"]
    out = FA.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.VARIANT_LAUNCHES["wgmma_dv"] == before + 1
    want = FA.flash_attention_torch(q, k, v, causal=causal).float()
    bound = FA.bf16_error_bound(q, k, v, causal=causal)
    for h in range(bh):
        err = (out[h].float() - want[h]).abs()
        assert bool((err <= bound[h]).all()), (
            f"head {h}: {int((err > bound[h]).sum())} elements beyond the "
            f"bf16 bound, max |err| {float(err.max()):.3e}")


@pytest.mark.parametrize("bh,bkv,s,causal,window", [
    (40, 40, 2016, True, 0), (4, 2, 512, True, 100), (3, 1, 77, False, 0)])
def test_wgmma_dv_flash_is_deterministic(card, bh, bkv, s, causal, window):
    """Two calls on the same inputs give bit-equal outputs."""
    q, k, v = _bf16_qkv(card, bh, bkv, s, s, seed=13, dq=96, dv=64)
    before = FA.VARIANT_LAUNCHES["wgmma_dv"]
    x = FA.flash_attention(q, k, v, causal=causal, window=window)
    y = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.VARIANT_LAUNCHES["wgmma_dv"] == before + 2
    assert torch.equal(x, y)


@pytest.mark.parametrize("bh,bkv,s,causal", [(40, 40, 2016, True),
                                             (3, 1, 333, False)])
def test_cuda_core_flash_still_matches_plain_at_mla_head_dims(card, bh, bkv,
                                                              s, causal):
    """The ``cuda_core`` kernel at 96 / 64 in bf16, through its own entry
    point (the private launcher: the yardstick ``chip_smoke.py`` times
    beside ``wgmma_dv``)."""
    q, k, v = _bf16_qkv(card, bh, bkv, s, s, seed=bh * s, dq=96, dv=64)
    before = dict(FA.VARIANT_LAUNCHES)
    out = FA._launch(q, k, v, causal, 0, None, "cuda_core")
    torch.cuda.synchronize()
    ran = {n: FA.VARIANT_LAUNCHES[n] - before[n] for n in FA.VARIANTS}
    assert ran == {n: int(n == "cuda_core") for n in FA.VARIANTS}
    assert_flash_close(out, q, k, v, causal=causal)


def test_wgmma_dv_entry_refuses_other_head_dims(card):
    """The ``wgmma_dv`` entry point takes (96, 64) only, and its ring is
    3 stages deep in the shared memory the library reports."""
    lib = FA._build.load(FA.SOURCE, FA._bind)
    assert lib.flash_attention_wgmma_dv_stages() == 3
    assert lib.flash_attention_wgmma_dv_smem_bytes() <= 232448
    q, k, v = _bf16_qkv(card, 2, 2, 128, 128, seed=3, dq=96, dv=96)
    with pytest.raises(RuntimeError, match="wgmma_dv"):
        FA._launch(q, k, v, True, 0, None, "wgmma_dv")


# the instances at equal head dims other than 128: h2o-danube3-4b's 120
# (GQA 32 / 8, window 4096) and phi3-vision-4b's 96
NEW_INSTANCES = [(120, "wgmma_120"), (96, "wgmma_96")]


@pytest.mark.parametrize("d,variant", NEW_INSTANCES)
@pytest.mark.parametrize("bh,bkv,sq,sk,causal,window", [
    (32, 8, 2048, 2048, True, 512),    # GQA 4, S past the window
    (8, 2, 1000, 1000, True, 300),     # ragged, window edge inside a tile
    (4, 1, 333, 333, True, 0),         # ragged, GQA 4
    (3, 3, 77, 77, True, 0),           # one ragged tile, Sk < 128
    (8, 8, 2048, 2048, True, 0),       # MHA, phi3-vision's S
    (4, 4, 640, 640, False, 0),        # non-causal
    (4, 4, 1000, 1000, False, 100),    # non-causal with a window
    (3, 1, 100, 300, False, 0),        # Sq != Sk, GQA 3
])
def test_new_wgmma_instances_match_plain(card, d, variant, bh, bkv, sq, sk,
                                         causal, window):
    """The ``wgmma_120`` and ``wgmma_96`` instances against the plain
    version, element by element within ``FA.bf16_error_bound``; exactly
    one launch, on the planned instance."""
    q, k, v = _bf16_qkv(card, bh, bkv, sq, sk, seed=bh + sq + window + d,
                        dq=d, dv=d)
    assert FA.plan(d, d, torch.bfloat16, FA._aligned16(q, k, v)) == variant
    before = dict(FA.VARIANT_LAUNCHES)
    out = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ran = {n: FA.VARIANT_LAUNCHES[n] - before[n] for n in FA.VARIANTS}
    assert ran == {n: int(n == variant) for n in FA.VARIANTS}
    assert out.dtype == torch.bfloat16 and out.shape == (bh, sq, d)
    assert_flash_close(out, q, k, v, causal=causal, window=window)


@pytest.mark.parametrize("d,variant", NEW_INSTANCES)
@pytest.mark.parametrize("bh,bkv,s,causal,window", [(3, 3, 200, True, 0),
                                                    (3, 3, 1000, False, 0),
                                                    (8, 2, 333, True, 100)])
def test_new_wgmma_instances_keep_each_head_to_itself(card, d, variant, bh,
                                                      bkv, s, causal,
                                                      window):
    """As ``test_wgmma_flash_keeps_each_head_to_itself``, at 120 and 96:
    the 240- and 192-byte rows of a ragged S stay in their own head (loads
    past Sk and past D read zeros, the o store is clipped at Sq and at D);
    every head is held separately."""
    q, k, v = _bf16_qkv(card, bh, bkv, s, s, seed=bh + s + d,
                        head_offset=8.0, dq=d, dv=d)
    before = FA.VARIANT_LAUNCHES[variant]
    out = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.VARIANT_LAUNCHES[variant] == before + 1
    want = FA.flash_attention_torch(q, k, v, causal=causal,
                                    window=window).float()
    bound = FA.bf16_error_bound(q, k, v, causal=causal, window=window)
    for h in range(bh):
        err = (out[h].float() - want[h]).abs()
        assert bool((err <= bound[h]).all()), (
            f"head {h}: {int((err > bound[h]).sum())} elements beyond the "
            f"bf16 bound, max |err| {float(err.max()):.3e}")


@pytest.mark.parametrize("d,variant", NEW_INSTANCES)
def test_new_wgmma_instances_write_nothing_past_d(card, d, variant):
    """The o store clips at column D: an output view inside a wider buffer
    filled with a sentinel keeps the sentinel in the padding (the kernel
    is launched through its entry point on that view, rows D apart)."""
    q, k, v = _bf16_qkv(card, 4, 1, 333, 333, seed=d, dq=d, dv=d)
    lib = FA._build.load(FA.SOURCE, FA._bind)
    flat = torch.full((4 * 333 * d + 64,), 7.0, dtype=torch.bfloat16,
                      device=card)
    out = flat[:4 * 333 * d].view(4, 333, d)
    err = getattr(lib, FA.ENTRY_POINTS[variant])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 4, 4, 333,
        333, d, d, 1, 0, d ** -0.5, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert bool((flat[4 * 333 * d:] == 7.0).all())
    assert_flash_close(out, q, k, v, causal=True)


@pytest.mark.parametrize("d,variant", NEW_INSTANCES)
@pytest.mark.parametrize("bh,bkv,s,causal,window", [
    (32, 8, 2048, True, 512), (4, 2, 512, True, 100), (3, 1, 77, False, 0)])
def test_new_wgmma_instances_are_deterministic(card, d, variant, bh, bkv, s,
                                               causal, window):
    """Two calls on the same inputs give bit-equal outputs."""
    q, k, v = _bf16_qkv(card, bh, bkv, s, s, seed=17, dq=d, dv=d)
    before = FA.VARIANT_LAUNCHES[variant]
    x = FA.flash_attention(q, k, v, causal=causal, window=window)
    y = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.VARIANT_LAUNCHES[variant] == before + 2
    assert torch.equal(x, y)


@pytest.mark.parametrize("d,variant", NEW_INSTANCES)
def test_new_wgmma_entries_refuse_other_head_dims_and_unaligned(card, d,
                                                                variant):
    """Each new entry point takes its own (D, D) only, with 16-byte
    aligned pointers; its ring is 2 stages deep in the shared memory the
    library reports."""
    lib = FA._build.load(FA.SOURCE, FA._bind)
    assert getattr(lib, f"flash_attention_{variant}_stages")() == 2
    assert getattr(lib, f"flash_attention_{variant}_smem_bytes")() <= 232448
    other = 96 if d == 120 else 120
    q, k, v = _bf16_qkv(card, 2, 2, 128, 128, seed=3, dq=other, dv=other)
    with pytest.raises(RuntimeError, match=variant):
        FA._launch(q, k, v, True, 0, None, variant)
    q, k, v = _bf16_qkv(card, 2, 2, 128, 128, seed=3, dq=d, dv=d)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)
    flat[1:].copy_(q.flatten())
    q1 = flat[1:].view(q.shape)
    assert not FA._aligned16(q1, k, v)
    assert FA.plan(d, d, torch.bfloat16, FA._aligned16(q1, k, v)) == (
        "cuda_core")
    with pytest.raises(RuntimeError, match=variant):
        FA._launch(q1, k, v, True, 0, None, variant)


@pytest.mark.parametrize("d,variant", NEW_INSTANCES)
def test_cuda_core_flash_still_matches_plain_at_new_head_dims(card, d,
                                                              variant):
    """The ``cuda_core`` kernel at (D, D) in bf16 through the private
    launcher: the yardstick ``chip_smoke.py`` phase 16 times beside the new
    instance."""
    q, k, v = _bf16_qkv(card, 8, 2, 1000, 1000, seed=d, dq=d, dv=d)
    before = dict(FA.VARIANT_LAUNCHES)
    out = FA._launch(q, k, v, True, 300, None, "cuda_core")
    torch.cuda.synchronize()
    ran = {n: FA.VARIANT_LAUNCHES[n] - before[n] for n in FA.VARIANTS}
    assert ran == {n: int(n == "cuda_core") for n in FA.VARIANTS}
    assert_flash_close(out, q, k, v, causal=True, window=300)


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant,i", [("wgmma", 0), ("wgmma", 1),
                                       ("wgmma_dv", 0), ("wgmma_dv", 1)])
def test_wgmma_128_and_dv_instances_keep_their_bits(card, variant, i):
    """The template's generalisation to partial boxes leaves the 128 / 128
    and 96 / 64 instances' code as it was: their outputs on the pinned
    inputs (``chip_smoke.PINNED_FLASH``) are bit for bit the earlier
    source's (the SHA-256 in ``chip_smoke.PINNED_DIGESTS``)."""
    cs = _chip_smoke()
    case = cs.PINNED_FLASH[variant][i]
    q, k, v = cs.pinned_flash_inputs(case, card)
    causal, window = case[5:]
    assert FA.plan(case[3], case[4], torch.bfloat16, True) == variant
    out = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert cs.output_digest(out) == cs.PINNED_DIGESTS[(variant, i)]


def test_mla_block_on_card_kernel_matches_chunked(card, exact_f32):
    """One MLA block at minicpm3-4b's attention widths (d 2560, 40 heads,
    q_lora 768, kv_lora 256, dn 64, dr 32, dv 64), float32, S = 300: the
    kernel impl (one ``cuda_core`` launch) against the chunked impl."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = get_config("minicpm3_4b")
    gen = torch.Generator(device=card).manual_seed(0)
    params = L.init_mla(gen, cfg.attention, cfg.d_model, torch.float32,
                        card)
    x = torch.randn((1, 300, cfg.d_model), generator=gen, device=card)
    pos = torch.arange(300, device=card)[None]
    before = dict(FA.VARIANT_LAUNCHES)
    with torch.no_grad():
        kern, _ = L.mla_block(params, x, cfg.attention, positions=pos,
                              impl="flash_pallas")
        plain, _ = L.mla_block(params, x, cfg.attention, positions=pos,
                               impl="chunked", chunk=100)
    assert FA.VARIANT_LAUNCHES["cuda_core"] == before["cuda_core"] + 1
    assert FA.VARIANT_LAUNCHES["wgmma"] == before["wgmma"]
    torch.testing.assert_close(kern, plain, atol=3e-4, rtol=1e-3)


def test_minicpm3_forward_on_card_goes_through_the_kernel(card, exact_f32):
    """minicpm3-4b's smoke config on the card, float32: scoring with the
    kernel impl launches ``cuda_core`` once per layer (no plain version)
    and agrees with the chunked impl; the absorbed decode follows a
    prefill on the kernel impl."""
    cfg = replace(get_smoke_config("minicpm3_4b"), compute_dtype="float32")
    model = get_model(cfg)
    params = model.init_params(0, device=card)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64))).to(card)
    FA.reset_counts()
    with torch.no_grad():
        kern = port_lm.forward(params, cfg, toks, impl="flash_pallas")
        plain = port_lm.forward(params, cfg, toks)
    assert FA.VARIANT_LAUNCHES["cuda_core"] == cfg.n_layers
    assert FA.PLAIN_CALLS["flash_attention"] == 0
    torch.testing.assert_close(kern, plain, atol=3e-4, rtol=1e-3)
    last, cache = port_lm.prefill(params, cfg, toks[:, :48],
                                  model.init_cache(2, 64, device=card),
                                  impl="flash_pallas")
    torch.testing.assert_close(last[:, 0], plain[:, 47], atol=3e-4,
                               rtol=1e-3)
    for i in range(48, 52):
        out, cache = model.decode_step(params, toks[:, i:i + 1], cache)
        torch.testing.assert_close(out[:, 0], plain[:, i], atol=3e-4,
                                   rtol=1e-3)


def test_minicpm3_bf16_forward_on_card_goes_through_wgmma_dv(card):
    """minicpm3-4b's smoke config with MLA's full head dims (dn 64, dr 32,
    dv 64: Dq 96, Dv 64), bf16: scoring with the kernel impl launches
    ``wgmma_dv`` once per layer and ``cuda_core`` never (no plain
    version), and its logits lie as near the float32 chunked logits as
    the bf16 chunked impl's do."""
    base = get_smoke_config("minicpm3_4b")
    att = replace(base.attention, qk_nope_head_dim=64, qk_rope_head_dim=32,
                  v_head_dim=64)
    cfg = replace(base, attention=att, compute_dtype="bfloat16")
    params = get_model(cfg).init_params(0, device=card)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 200))).to(card)
    FA.reset_counts()
    with torch.no_grad():
        kern = port_lm.forward(params, cfg, toks, impl="flash_pallas")
    assert FA.VARIANT_LAUNCHES == {n: cfg.n_layers * (n == "wgmma_dv")
                                   for n in FA.VARIANTS}
    assert FA.PLAIN_CALLS["flash_attention"] == 0
    with torch.no_grad():
        plain = port_lm.forward(params, cfg, toks)
        f32 = port_lm.forward(params, replace(cfg, compute_dtype="float32"),
                              toks)
    rms = lambda t: float(t.float().square().mean().sqrt())  # noqa: E731
    assert torch.isfinite(kern).all()
    assert rms(kern.float() - f32) <= 1.5 * rms(plain.float() - f32)


def test_whisper_encode_on_card_matches_cpu(card, exact_f32):
    """whisper-small's smoke config, float32: the encoder's output and the
    teacher-forced logits on the card equal the CPU's within the LM tests'
    tolerance; no kernel launches (dense and chunked impls)."""
    from repro_torch.models import encdec
    cfg = replace(get_smoke_config("whisper_small"), compute_dtype="float32")
    model = get_model(cfg)
    cpu = model.init_params(0, device="cpu")
    params = model.init_params(0, device="cpu").to(card)
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.normal(size=(
        2, cfg.enc_dec.encoder_len, cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    FA.reset_counts()
    with torch.no_grad():
        enc = encdec.encode(params, cfg, frames.to(card))
        assert enc.is_cuda
        torch.testing.assert_close(enc.cpu(),
                                   encdec.encode(cpu, cfg, frames),
                                   atol=2e-4, rtol=1e-3)
        logits = model.logits(params, {"tokens": toks.to(card),
                                       "frames": frames.to(card)})
        want = model.logits(cpu, {"tokens": toks, "frames": frames})
    torch.testing.assert_close(logits.cpu(), want, atol=2e-4, rtol=1e-3)
    assert FA.LAUNCHES["flash_attention"] == 0


def test_sharded_train_step_on_card_matches_plain(card, exact_f32):
    """The (1, 1) NCCL mesh: two ``make_train_step`` steps of olmo-1b's
    smoke config with parameters, AdamW state and batches as DTensors
    placed by ``param_specs`` / ``input_specs_sharding`` under
    ``pspec.activation_mesh``, against the same steps on plain tensors from
    the same weights: losses, gradient norms and parameters equal (every
    placement is a replica on one rank: the same kernels on the same
    data), but for the tied embedding: its lookup's gradient is
    ``F.embedding``'s on a mesh and indexing's off it, which on the card
    add a token's rows in another order, so it is held within rtol 1e-6
    (float32 rounding: 2 of 16384 weights 1e-7 apart)."""
    import copy
    import socket
    import torch.distributed as dist
    from repro_torch import pspec
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.sharding import (distribute, distribute_params,
                                             input_specs_sharding)
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim import adamw_init
    if dist.is_initialized():
        pytest.skip("a process group is already open in this process")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_local_mesh(1, 1)
        cfg = replace(get_smoke_config("olmo_1b"), compute_dtype="float32")
        plain, _ = init_train_state(cfg, torch.Generator().manual_seed(0),
                                    card)
        sharded = distribute_params(copy.deepcopy(plain), mesh)
        rng = np.random.default_rng(1)
        batches = []
        for _ in range(2):
            toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 33)))
            batches.append({"tokens": toks[:, :-1].to(card),
                            "labels": toks[:, 1:].to(card)})
        step = make_train_step(cfg)
        p_state = adamw_init(dict(plain.named_parameters()))
        s_state = adamw_init(dict(sharded.named_parameters()))
        placed = input_specs_sharding(mesh, batches[0])
        for batch in batches:
            _, p_state, pm = step(plain, p_state, batch)
            with pspec.activation_mesh(mesh):
                _, s_state, sm = step(sharded, s_state, {
                    k: distribute(v, mesh, placed[k])
                    for k, v in batch.items()})
            for key in ("loss", "grad_norm"):
                got = sm[key].full_tensor() if pspec.is_dtensor(sm[key]) \
                    else sm[key]
                assert float(got) == float(pm[key]), key
        for (name, p), (_, q) in zip(plain.named_parameters(),
                                     sharded.named_parameters()):
            if name == "embed":
                torch.testing.assert_close(q.full_tensor(), p, rtol=1e-6,
                                           atol=0)
            else:
                assert torch.equal(q.full_tensor(), p), name
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# training attention: train_fwd, train_dq, train_dkdv
# ---------------------------------------------------------------------------


def _train_inputs(card, bh, s, seed):
    """bf16 q, k, v and dO (BH, S, 128) from a seed."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(bh, s, 128))
                                  .astype(np.float32))
                 .to(torch.bfloat16).to(card) for _ in range(4))


def _within_bf16(got, want, what):
    """Within 2^-6 of the largest element (four bf16 units in the last
    place there): the kernels and the plain version round P and dS to bf16
    alike, and differ in the exponentials' approximation and the order of
    float32 sums."""
    got, want = got.detach().float(), want.detach().float()
    err = float((got - want).abs().max())
    top = float(want.abs().max())
    assert err <= 2.0 ** -6 * top, f"{what}: max |err| {err:.3e} of {top:.3e}"


@pytest.mark.parametrize("bh,s,chunk", [
    pytest.param(4, 256, 4, id="small"),
    pytest.param(6, 384, 6, id="three-tiles"),
    pytest.param(64, 4096, 8, id="olmo-1b-layer"),   # B 4 x 16 heads
])
def test_train_flash_kernels_match_plain(card, exact_f32, bh, s, chunk):
    """o (within ``bf16_error_bound``), the log-sum-exp, dq, dk and dv of
    the three kernels against ``flash_attention_train_torch`` and
    ``flash_attention_train_backward_torch`` on the same inputs (the plain
    versions run ``chunk`` heads at a time); one launch of each kernel."""
    q, k, v, do = _train_inputs(card, bh, s, seed=bh + s)
    scale = 128 ** -0.5
    before = dict(FA.VARIANT_LAUNCHES)
    o, lse = FA._train_forward(q, k, v, scale)
    dq, dk, dv = FA._train_backward(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    ran = {n: FA.VARIANT_LAUNCHES[n] - before[n] for n in FA.VARIANTS}
    assert ran == {n: int(n in ("train_fwd", "train_dq", "train_dkdv"))
                   for n in FA.VARIANTS}
    for h in range(0, bh, chunk):
        sl = slice(h, h + chunk)
        po, plse = FA.flash_attention_train_torch(q[sl], k[sl], v[sl],
                                                  scale=scale)
        bound = FA.bf16_error_bound(q[sl], k[sl], v[sl], causal=True)
        assert bool(((o[sl].float() - po.float()).abs() <= bound).all())
        torch.testing.assert_close(lse[sl], plse, rtol=1e-5, atol=1e-5)
        want = FA.flash_attention_train_backward_torch(
            q[sl], k[sl], v[sl], o[sl], lse[sl], do[sl], scale=scale)
        for name, got, w in zip(("dq", "dk", "dv"), (dq[sl], dk[sl],
                                                    dv[sl]), want):
            _within_bf16(got, w, f"{name}, heads {h}..")


def test_train_flash_gqa_group_matches_dense_autograd(card, exact_f32):
    """jamba's group (32 query heads over 8 KV heads) at a small S through
    ``layers._flash_train`` (k and v expanded, the groups' gradients summed
    by ``repeat_interleave``'s backward) against autograd of
    ``dense_attention`` in float32 on the same bf16 inputs."""
    from repro_torch.models import layers as L
    rng = np.random.default_rng(32)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(1, 512, h, 128))
                                   .astype(np.float32))
                  .to(torch.bfloat16).to(card)
                  for h in (32, 8, 8, 32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    assert L.flash_train_applies(*leaves, causal=True, window=0)
    before = dict(FA.VARIANT_LAUNCHES)
    out = L._flash_train(*leaves)
    out.backward(g)
    torch.cuda.synchronize()
    assert {n: FA.VARIANT_LAUNCHES[n] - before[n]
            for n in ("train_fwd", "train_dq", "train_dkdv")} == {
        "train_fwd": 1, "train_dq": 1, "train_dkdv": 1}
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = L.dense_attention(*ref, causal=True)
    want.backward(g.float())
    _within_bf16(out, want, "o")
    for name, a, b in zip("qkv", leaves, ref):
        _within_bf16(a.grad, b.grad, f"d{name}")


@pytest.mark.parametrize("bh,s", [(8, 1024), (64, 4096)])
def test_train_flash_backward_is_bit_equal_run_to_run(card, bh, s):
    """No atomics: two backward passes on the same inputs give the same
    bits; the forward's o is the ``wgmma`` instance's, bit for bit (the
    training instance only adds the log-sum-exp's stores)."""
    q, k, v, do = _train_inputs(card, bh, s, seed=7)
    scale = 128 ** -0.5
    o, lse = FA._train_forward(q, k, v, scale)
    first = FA._train_backward(q, k, v, o, lse, do, scale)
    second = FA._train_backward(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert torch.equal(o, FA.flash_attention(q, k, v, causal=True))


def test_train_flash_entries_refuse_what_they_cannot_take(card):
    """S not a multiple of 128, other head dims, float32: the wrapper
    raises before any launch; the backward's ring fits the shared memory
    the library reports."""
    lib = FA._build.load(FA.SOURCE, FA._bind)
    assert lib.flash_attention_train_bwd_smem_bytes() <= 232448
    assert lib.flash_attention_train_bwd_stages() >= 2
    q = torch.zeros((2, 200, 128), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="multiple of 128"):
        FA.flash_attention_train(q, q, q)
    q = torch.zeros((2, 256, 96), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="D = 128"):
        FA.flash_attention_train(q, q, q)
    q = torch.zeros((2, 256, 128), device=card)
    with pytest.raises(TypeError, match="bf16"):
        FA.flash_attention_train(q, q, q)


def test_train_flash_takes_strided_inputs(card):
    """q, k, v as strided views (every row 256 wide, the first 128 taken):
    the function works on aligned contiguous copies, saved for the
    backward, and gives the contiguous inputs' o and gradients bit for
    bit."""
    rng = np.random.default_rng(21)
    wide = [torch.from_numpy(rng.normal(size=(8, 256, 256))
                             .astype(np.float32)).to(torch.bfloat16).to(card)
            .requires_grad_() for _ in range(3)]
    views = [t[..., :128] for t in wide]
    assert not views[0].is_contiguous()
    flat = [t.detach().contiguous().requires_grad_() for t in views]
    g = torch.from_numpy(rng.normal(size=(8, 256, 128)).astype(
        np.float32)).to(torch.bfloat16).to(card)
    out = FA.flash_attention_train(*views)
    want = FA.flash_attention_train(*flat)
    out.backward(g)
    want.backward(g)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    for a, b in zip(wide, flat):
        assert torch.equal(a.grad[..., :128], b.grad)
        assert not bool(a.grad[..., 128:].any())
