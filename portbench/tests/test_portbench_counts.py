"""The frozen counts against values worked out by hand."""

import pytest

from portbench import counts, manifest


def test_causal_pairs_by_hand():
    assert counts.mask_pairs(16384, 16384, True) == 134_225_920
    assert counts.mask_pairs(2048, 2048, True) == 2_098_176
    assert counts.mask_pairs(4, 4, False) == 16
    # window 2 over 4 causal rows keeps 1 + 2 + 2 + 2 keys
    assert counts.mask_pairs(4, 4, True, window=2) == 7


def test_flash_bound_at_phi3_16k():
    # 32 heads x 134,225,920 pairs x 2 x (96 + 96) at 989 TFLOP/s
    sec, kind = counts.flash_bound(32, 16384, 16384, 96, 96, 2, True)
    assert kind == "operations"
    assert sec == pytest.approx(32 * 134_225_920 * 2 * 192 / 989e12)
    assert 1.66e-3 < sec < 1.68e-3
    # one query row over one key is bound by its bytes
    _, kind = counts.flash_bound(1, 1, 1, 96, 96, 2, True)
    assert kind == "bytes"


def test_train_step_flops_olmo_by_hand():
    conf = manifest.Manifest().config("olmo-1b")
    d, ff, L, V, B, S = 2048, 8192, 16, 50304, 4, 4096
    n = L * (4 * d * d + 3 * d * ff) + d * V
    attn = 3 * 2 * 2 * 128 * (S * (S + 1) // 2) * 16 * L * B
    assert counts.train_step_flops(conf, B, S) == 6 * n * B * S + attn
    assert n == 1_176_764_416


def test_prefill_flops_phi3_by_hand():
    conf = manifest.Manifest().config("phi3-vision-4b")
    d, ff, L, V, H, D = 3072, 8192, 32, 32064, 32, 96
    S = 256 + 16128
    want = (2 * L * (4 * d * d + 3 * d * ff) * S + 2 * d * d * 256
            + 2 * 2 * D * (S * (S + 1) // 2) * H * L + 2 * d * V)
    assert counts.prefill_flops(conf, 1, 16128) == want
