"""The port's ``kernels.ops`` and ``kernels.ref`` held against the
reference's, on the CPU (the reference's Pallas kernels in interpret mode,
as its own tests run them).  Inputs are made with numpy from a seed.

Contracts:

* ``ops.gemm`` (the systolic GEMM's plain version on CPU tensors) at the
  shapes x activations of ``tests/test_kernels.py::test_systolic_gemm``:
  float32 within atol 1e-4 of the reference's ``ops.gemm``; bfloat16
  within atol 2e-2 of ``ref.gemm_ref`` (both sum exact bf16 products in
  float32, so they differ by float32 summation order only).
* ``ops.maxplus_matmul``: bit for bit (max-plus is exact), ragged shapes
  included.
* ``ops.flash_attention``: atol 2e-4 / rtol 1e-3 (the reference's kernel
  test tolerance) at ragged, windowed and non-causal shapes; non-causal
  ragged keys and 4-D with Dv != Dq against ``ref.flash_attention_ref``
  (the reference's own wrapper raises in both cases).
* ``ops.selective_scan``: atol/rtol 1e-4 (the reference's), ragged D.
* ``ref.*``: the port's oracles equal the reference's to float32
  summation order (atol 1e-5), the max-plus one bit for bit.
"""

import jax  # noqa: F401  (both frameworks in one process; JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import maxplus as K
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as SS
from repro_torch.kernels import systolic_gemm as SG


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x, np.float32), dtype)


@pytest.mark.parametrize("m,k,n,dt", [
    (128, 128, 128, "float32"),
    (64, 200, 96, "bfloat16"),
    (37, 53, 29, "float32"),
    (256, 128, 64, "bfloat16"),
])
@pytest.mark.parametrize("act", [0, 1])
def test_gemm_matches_reference(m, k, n, dt, act):
    a, b = _np(m + k, m, k), _np(k + n, k, n)
    SG.reset_counts()
    if dt == "float32":
        out = ops.gemm(_t(a), _t(b), activation=act)
        want = ref_ops.gemm(_j(a), _j(b), activation=act, bm=32, bk=64,
                            bn=32)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
    else:
        out = ops.gemm(_t(a, torch.bfloat16), _t(b, torch.bfloat16),
                       activation=act)
        want = ref_ref.gemm_ref(_j(a, jnp.bfloat16), _j(b, jnp.bfloat16),
                                activation=act)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-2,
                                   rtol=0)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    assert SG.PLAIN_CALLS["systolic_gemm"] == 1
    assert SG.LAUNCHES["systolic_gemm"] == 0
    if act:
        assert float(out.min()) >= 0.0


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gemm_out_dtype_and_mixed_inputs(out_dtype):
    """``out_dtype`` as the reference's; mixed float32 x bfloat16 inputs
    promote to float32, as JAX promotes them."""
    a, b = _np(1, 37, 53), _np(2, 53, 29)
    out = ops.gemm(_t(a), _t(b, torch.bfloat16), activation=1,
                   out_dtype=out_dtype)
    want = ref_ops.gemm(_j(a), _j(b, jnp.bfloat16), activation=1,
                        out_dtype=jnp.bfloat16 if out_dtype ==
                        torch.bfloat16 else jnp.float32)
    assert out.dtype == out_dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-4 if out_dtype == torch.float32
                               else 2e-2, rtol=2 ** -8)


@pytest.mark.parametrize("m,k,n", [(32, 32, 32), (100, 77, 130),
                                   (256, 64, 192), (8, 8, 8), (5, 1, 3)])
def test_maxplus_matmul_matches_reference(m, k, n):
    a, b = _np(m, m, k), _np(n, k, n)
    a[0, :] = -1e18                 # a row with no path
    out = ops.maxplus_matmul(_t(a), _t(b))
    want = ref_ops.maxplus_matmul(_j(a), _j(b), bm=32, bk=32, bn=32)
    assert np.array_equal(out.numpy(), np.asarray(want))
    assert np.array_equal(ref.maxplus_matmul_ref(_t(a), _t(b)).numpy(),
                          np.asarray(ref_ref.maxplus_matmul_ref(_j(a),
                                                                _j(b))))


@pytest.mark.parametrize("b,h,sq,sk,d,causal,window", [
    (1, 2, 128, 128, 64, True, 0),
    (1, 1, 160, 160, 64, True, 0),       # ragged
    (1, 2, 256, 256, 64, True, 64),      # sliding window
    (1, 2, 128, 128, 32, False, 0),      # non-causal
])
def test_flash_attention_matches_reference(b, h, sq, sk, d, causal, window):
    q, k, v = _np(1, b, h, sq, d), _np(2, b, h, sk, d), _np(3, b, h, sk, d)
    FA.reset_counts()
    out = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window)
    want = ref_ops.flash_attention(_j(q), _j(k), _j(v), causal=causal,
                                   window=window, bq=64, bk=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-3)
    # the 3-D layout gives the same
    out3 = ops.flash_attention(*(_t(x).reshape(b * h, x.shape[2], d)
                                 for x in (q, k, v)), causal=causal,
                               window=window)
    assert torch.equal(out3.reshape(out.shape), out)
    assert FA.PLAIN_CALLS["flash_attention"] == 2


def test_flash_attention_noncausal_ragged_keys():
    """Non-causal attention over a key count that is no multiple of the
    reference's key block: the reference's wrapper drops to its plain
    oracle there and fails (it hands the 4-D oracle 3-D arrays, ROADMAP
    C6); the port's kernel masks the keys past the true length.  Held
    against the reference's oracle."""
    q, k, v = (_np(1, 1, 2, 100, 32), _np(2, 1, 2, 77, 32),
               _np(3, 1, 2, 77, 32))
    out = ops.flash_attention(_t(q), _t(k), _t(v), causal=False)
    want = ref_ref.flash_attention_ref(_j(q), _j(k), _j(v), causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-3)
    with pytest.raises(ValueError, match="subscript"):
        ref_ops.flash_attention(_j(q), _j(k), _j(v), causal=False, bq=64,
                                bk=64)


def test_flash_attention_4d_dv_differs_from_dq():
    """The reference's 4-D path cannot reshape Dv != Dq (ROADMAP C1); the
    port's works and equals the reference's plain oracle."""
    q, k, v = (_np(4, 2, 3, 96, 64), _np(5, 2, 3, 96, 64),
               _np(6, 2, 3, 96, 32))
    out = ops.flash_attention(_t(q), _t(k), _t(v), causal=True)
    assert out.shape == (2, 3, 96, 32)
    want = ref_ref.flash_attention_ref(_j(q), _j(k), _j(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-3)
    with pytest.raises(TypeError):
        ref_ops.flash_attention(_j(q), _j(k), _j(v), causal=True, bq=32,
                                bk=32)


@pytest.mark.parametrize("causal,sq,sk", [(True, 64, 64), (True, 40, 72),
                                          (False, 50, 70)])
def test_flash_attention_ref_matches_reference(causal, sq, sk):
    """The plain oracle, causal mask aligned at the sequence ends."""
    q, k, v = _np(7, 2, 2, sq, 16), _np(8, 2, 2, sk, 16), _np(9, 2, 2, sk, 8)
    out = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal)
    want = ref_ref.flash_attention_ref(_j(q), _j(k), _j(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("B,S,D,N,bd", [(2, 16, 32, 4, 16),
                                        (1, 20, 100, 8, 64),
                                        (2, 33, 100, 8, 128)])
def test_selective_scan_matches_reference(B, S, D, N, bd):
    x = _np(10, B, S, D, scale=0.5)
    dt = np.abs(_np(11, B, S, D, scale=0.1))
    b, c = _np(12, B, S, N), _np(13, B, S, N)
    a = -(np.abs(_np(14, D, N)) + 0.1)
    d = _np(15, D)
    SS.reset_counts()
    out = ops.selective_scan(*(_t(z) for z in (x, dt, b, c, a, d)), bd=bd)
    want = ref_ops.selective_scan(*(_j(z) for z in (x, dt, b, c, a, d)),
                                  bd=bd)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    oracle = ref.selective_scan_ref(*(_t(z) for z in (x, dt, b, c, a, d)))
    np.testing.assert_allclose(
        oracle.numpy(),
        np.asarray(ref_ref.selective_scan_ref(*(_j(z) for z in
                                                (x, dt, b, c, a, d)))),
        atol=1e-5, rtol=1e-5)
    assert SS.PLAIN_CALLS["selective_scan"] == 1   # the oracle is uncounted


def test_gemm_ref_and_plain_version_match_reference_oracle():
    a, b = _np(20, 48, 40), _np(21, 40, 24)
    for act in (0, 1):
        np.testing.assert_allclose(
            ref.gemm_ref(_t(a), _t(b), activation=act).numpy(),
            np.asarray(ref_ref.gemm_ref(_j(a), _j(b), activation=act)),
            atol=1e-5, rtol=0)
    bf = ref.gemm_ref(_t(a), _t(b), out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, SG.systolic_gemm_torch(_t(a), _t(b)).bfloat16())


def test_systolic_gemm_checks_its_arguments():
    a = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="not \\(M, K\\)"):
        SG.systolic_gemm(a, a)
    with pytest.raises(ValueError, match="activation"):
        SG.systolic_gemm(a, a.t(), activation=2)
    with pytest.raises(TypeError, match="out_dtype"):
        SG.systolic_gemm(a, a.t(), out_dtype=torch.float16)
    assert SG.systolic_gemm(a, torch.zeros((8, 0))).shape == (4, 0)


def test_error_bound_is_float32_summation_order_plus_roundings():
    """The stated bound: K 2^-22 |A||B| + 1e-6, plus 2^-7 |C| for a bf16
    output; the float32 plain version's own reordering stays inside it."""
    a, b = _t(_np(30, 16, 300)), _t(_np(31, 300, 12))
    c = SG.systolic_gemm_torch(a, b)
    bnd = SG.error_bound(a, b, c)
    mag = a.abs() @ b.abs()
    torch.testing.assert_close(bnd, mag * 300 * 2.0 ** -22 + 1e-6)
    cb = SG.systolic_gemm_torch(a, b, out_dtype=torch.bfloat16)
    torch.testing.assert_close(SG.error_bound(a, b, cb) - bnd,
                               cb.float().abs() * 2.0 ** -7)
    # a different float32 summation order (blocks of 32 over k)
    blocked = sum(a[:, s:s + 32] @ b[s:s + 32] for s in range(0, 300, 32))
    assert bool(((blocked - c).abs() <= bnd).all())


def test_ops_on_cpu_take_the_plain_versions_only():
    for mod in (K, FA, SS, SG):
        mod.reset_counts()
    x = _t(_np(40, 8, 8))
    ops.maxplus_matmul(x, x)
    ops.gemm(x, x)
    ops.flash_attention(x[None], x[None], x[None])
    ops.selective_scan(x[None], x[None].abs(), x[None], x[None],
                       -x.abs() - 0.1, x[0])
    for mod, name in ((K, "maxplus_matmul"), (FA, "flash_attention"),
                      (SS, "selective_scan"), (SG, "systolic_gemm")):
        assert mod.PLAIN_CALLS[name] == 1, name
        assert mod.LAUNCHES[name] == 0, name
