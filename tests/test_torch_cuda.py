"""Card-only tests of the port: each hand-written kernel (max-plus,
flash attention, selective scan, systolic GEMM) against its plain PyTorch
version on the card, the blocked and packed Explorer paths, the
``kernels.ops`` wrappers and a small LM forward through the kernels.
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
    (2, 2, 200, 200, 120, 120, True, 0, torch.bfloat16),    # h2o-danube
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
    assert variant == ("wgmma" if dtype == torch.bfloat16 and dq == dv == 128
                       else "cuda_core")
    before = FA.VARIANT_LAUNCHES[variant]
    out = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention"] == launches + 1
    assert FA.VARIANT_LAUNCHES[variant] == before + 1
    assert out.dtype == dtype and out.shape == (bh, sq, dv)
    assert_flash_close(out, q, k, v, causal=causal, window=window)


def _bf16_qkv(card, bh, bkv, sq, sk, seed, head_offset=0.0):
    """bf16 q, k, v (D = 128) from a seed; v of head h shifted by
    ``head_offset`` * h, so rows that land in another head's output stand
    out."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((bh, sq, 128), (bkv, sk, 128), (bkv, sk, 128)))
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
    kern = port_lm.forward(params, replace(cfg, attention_impl="flash_pallas",
                                           ssm_impl="pallas"), toks)
    assert FA.LAUNCHES["flash_attention"] == 1
    assert SS.LAUNCHES["selective_scan"] == 7
    assert SS.VARIANT_LAUNCHES["ring"] == 7
    assert FA.PLAIN_CALLS["flash_attention"] == 0
    assert SS.PLAIN_CALLS["selective_scan"] == 0
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
