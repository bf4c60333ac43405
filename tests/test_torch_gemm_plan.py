"""The port's GEMM dispatch plan, on the CPU: ``systolic_gemm.plan`` picks
the kernel of each (M, K, N) product from its shape, its type and the
alignment of its pointers alone, and sizes the grid -- checked here at
olmo-1b's eight GEMM shapes (as the port's ``extract_operators`` gives
them: decode at the network cells' shape, prefill at 4 x 2048) and at
ragged and unaligned shapes.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 9).
"""

import math

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.mapping.workload import extract_operators
from repro_torch.core.network import NETWORK_SHAPE
from repro_torch.kernels import ops
from repro_torch.kernels import systolic_gemm as SG
from repro_torch.models.config import ShapeConfig

H100_SMS = 132
BF16 = torch.bfloat16

# olmo-1b: d 2048, d_ff 8192, vocab 50304
DECODE = [(8, 2048, 2048), (8, 2048, 4096), (8, 2048, 24576),
          (8, 2048, 50304)]
PREFILL = [(8192, 2048, 2048), (8192, 2048, 4096), (8192, 2048, 24576),
           (8192, 2048, 50304)]


def test_olmo_gemm_shapes_are_the_ones_planned_below():
    cfg = get_config("olmo_1b")
    prefill = ShapeConfig("prefill", seq_len=2048, global_batch=4,
                          mode="prefill")
    shapes = {(c.m, c.k, c.n) for shape in (NETWORK_SHAPE, prefill)
              for c in extract_operators(cfg, shape) if c.op == "gemm"}
    assert shapes == set(DECODE + PREFILL)


@pytest.mark.parametrize("m,k,n", DECODE + PREFILL)
def test_olmo_shapes_pick_wgmma_or_splitk(m, k, n):
    p = SG.plan(m, k, n, BF16, True, sms=H100_SMS)
    assert p.variant == ("wgmma" if m == 8192 else "splitk")
    assert p.splits >= 1 and all(g >= 1 for g in p.grid)


@pytest.mark.parametrize("m,k,n", DECODE)
def test_splitk_fills_two_blocks_per_sm_at_decode(m, k, n):
    """K is split until the grid holds at least 2 x 132 blocks, never into
    more shares than K has 64-deep tiles, and every panel is covered."""
    p = SG.plan(m, k, n, BF16, True, sms=H100_SMS)
    panels, splits = p.grid
    assert panels * splits >= 2 * H100_SMS
    assert panels == math.ceil(n / SG.SPLITK_N) and splits == p.splits
    assert 1 <= splits <= math.ceil(k / SG.SPLITK_K)
    assert p.tile == (8, SG.SPLITK_N, SG.SPLITK_K)
    # no more splits than needed: one fewer would leave the grid short
    assert splits == 1 or panels * (splits - 1) < 2 * H100_SMS


@pytest.mark.parametrize("m,rows", [(1, 8), (8, 8), (9, 16), (17, 32),
                                    (33, 64), (64, 64)])
def test_splitk_rows_cover_m(m, rows):
    p = SG.plan(m, 2048, 264, BF16, True)
    assert p.variant == "splitk" and p.tile[0] == rows


@pytest.mark.parametrize("m,k,n,aligned", [(37, 53, 29, True),
                                           (64, 200, 96, False),
                                           (8192, 2048, 2052, True),
                                           (8, 2044, 2048, True),
                                           (8192, 2048, 2048, False)])
def test_unaligned_shapes_pick_mma_sync(m, k, n, aligned):
    """K or N not a multiple of 8 (TMA's 16-byte row strides), or a
    pointer off a 16-byte boundary (64x200x96 is aligned by shape, so it
    reaches mma_sync only as a misaligned view)."""
    p = SG.plan(m, k, n, BF16, aligned)
    assert p.variant == "mma_sync"
    assert p.grid == (math.ceil(m / 128), math.ceil(n / 128))
    assert p.splits == 1


@pytest.mark.parametrize("m,k,n,aligned", [(8192, 2048, 24576, True),
                                           (8, 2048, 2048, True),
                                           (37, 53, 29, False)])
def test_float32_picks_f32(m, k, n, aligned):
    p = SG.plan(m, k, n, torch.float32, aligned)
    assert p.variant == "f32" and p.splits == 1
    assert p.grid == (math.ceil(m / 128), math.ceil(n / 128))


@pytest.mark.parametrize("sms", [132, 114, 16, 1])
@pytest.mark.parametrize("m,k,n", PREFILL + [(65, 64, 8), (128, 64, 256),
                                             (300, 256, 264),
                                             (8192, 8, 2 ** 23)])
def test_persistent_grid_never_exceeds_the_sm_count(m, k, n, sms):
    """One block per SM at most, and no more blocks than 128 x 256 tiles."""
    p = SG.plan(m, k, n, BF16, True, sms=sms)
    tiles = math.ceil(m / 128) * math.ceil(n / 256)
    assert p.variant == "wgmma" and p.tile == SG.WGMMA_TILE
    assert p.grid == (min(tiles, sms),)


def test_wide_n_has_no_grid_limit_on_the_new_kernels():
    """ceil(N / 128) > 65535 bounds the 128 x 128 kernels' grid only."""
    n = 65536 * 128
    assert SG.plan(8192, 64, n, BF16, True).variant == "wgmma"
    assert SG.plan(8, 64, n, BF16, True).grid[0] == n // SG.SPLITK_N
    assert SG.plan(8192, 64, n, BF16, False).grid[1] > SG.MAX_GRID_Y


def test_plan_rejects_other_types():
    with pytest.raises(TypeError):
        SG.plan(8, 8, 8, torch.float16, True)


def test_alignment_is_read_from_the_pointers():
    a = torch.zeros((64, 200), dtype=BF16)
    b = torch.zeros((200, 96), dtype=BF16)
    assert SG._aligned16(a, b)
    a1 = torch.zeros(64 * 200 + 1, dtype=BF16)[1:].view(64, 200)
    assert a1.is_contiguous() and not SG._aligned16(a1, b)


def test_cpu_tensors_take_the_plain_version_and_count_no_kernel():
    SG.reset_counts()
    a = torch.randn((8, 64)).to(BF16)
    b = torch.randn((64, 16)).to(BF16)
    out = ops.gemm(a, b, activation=1)
    assert torch.equal(out, SG.systolic_gemm_torch(a, b, activation=1))
    assert SG.PLAIN_CALLS["systolic_gemm"] == 1
    assert SG.LAUNCHES["systolic_gemm"] == 0
    assert all(v == 0 for v in SG.VARIANT_LAUNCHES.values())
    assert set(SG.VARIANT_LAUNCHES) == set(SG.VARIANTS)
