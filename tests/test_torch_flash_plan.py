"""The port's flash-attention dispatch plan, on the CPU:
``flash_attention.plan`` picks the kernel of each call from the input type,
the head dims and the alignment of the pointers alone -- checked here at
the attention shape of every ported config (as ``models/layers.py``
hands it to the kernel: (B * H, S, head_dim)), at MLA's head dims (the
``wgmma_dv`` instance), at h2o-danube3's 120 and phi3-vision's 96 (the
``wgmma_120`` and ``wgmma_96`` instances), at the head dims that take the
CUDA-core kernel and at unaligned views; and the shared build sees the
shared header.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 6, 8, 14 and
16).
"""

import shutil

import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA

BF16 = torch.bfloat16

# the ported configs whose attention heads are 128 wide: the LM path
WGMMA_CONFIGS = ["jamba_v01_52b", "olmo_1b", "olmoe_1b_7b",
                 "deepseek_moe_16b", "mistral_large_123b"]


@pytest.mark.parametrize("arch", WGMMA_CONFIGS)
def test_head_dim_128_configs_pick_wgmma_in_bf16(arch):
    d = get_config(arch).attention.head_dim
    assert d == 128
    assert FA.plan(d, d, BF16, True) == "wgmma"
    assert FA.plan(d, d, torch.float32, True) == "cuda_core"


@pytest.mark.parametrize("arch,d", [("jamba_v01_52b", 16),
                                    ("whisper_small", 64)])
def test_other_head_dims_pick_cuda_core(arch, d):
    """jamba's smoke config (16) and whisper (64): no instance of the
    wgmma kernel, in either type."""
    cfg = get_smoke_config(arch) if d == 16 else get_config(arch)
    assert cfg.attention.head_dim == d
    for dtype in (BF16, torch.float32):
        assert FA.plan(d, d, dtype, True) == "cuda_core"


# the configs whose heads take the instances at equal head dims other than
# 128: phi-3-vision (96, MHA) and h2o-danube3 (120, GQA with a window)
NEW_DIMS = [("phi3_vision_4b", 96, "wgmma_96"),
            ("h2o_danube3_4b", 120, "wgmma_120")]


@pytest.mark.parametrize("arch,d,variant", NEW_DIMS)
def test_new_head_dims_pick_their_wgmma_instance_in_bf16(arch, d, variant):
    a = get_config(arch).attention
    assert a.head_dim == d
    assert FA.WGMMA_INSTANCES[(d, d)] == variant
    assert FA.plan(d, d, BF16, True) == variant


@pytest.mark.parametrize("arch,d,variant", NEW_DIMS)
@pytest.mark.parametrize("dtype,aligned", [(torch.float32, True),
                                           (torch.float32, False),
                                           (BF16, False)])
def test_new_head_dims_in_float32_or_unaligned_pick_cuda_core(
        arch, d, variant, dtype, aligned):
    assert get_config(arch).attention.head_dim == d
    assert FA.plan(d, d, dtype, aligned) == "cuda_core"


@pytest.mark.parametrize("dq,dv", [(120, 96), (96, 120), (112, 112),
                                   (120, 128), (104, 104), (120, 64)])
def test_near_new_head_dims_pick_cuda_core(dq, dv):
    """Only the instantiated (Dq, Dv) go to a wgmma instance."""
    assert (dq, dv) not in FA.WGMMA_INSTANCES
    assert FA.plan(dq, dv, BF16, True) == "cuda_core"


def test_unaligned_h2o_view_picks_cuda_core():
    """h2o-danube3's rows are 240 bytes: a view one element in is not
    16-byte aligned and takes the CUDA-core kernel."""
    flat = torch.zeros(8 * 64 * 120 + 1, dtype=BF16)
    q = flat[:-1].view(8, 64, 120)
    q1 = flat[1:].view(8, 64, 120)
    assert FA.plan(120, 120, BF16, FA._aligned16(q, q, q)) == "wgmma_120"
    assert FA.plan(120, 120, BF16, FA._aligned16(q, q1, q)) == "cuda_core"


@pytest.mark.parametrize("dq,dv", [(128, 64), (64, 128), (128, 120)])
def test_dv_unlike_dq_picks_cuda_core(dq, dv):
    assert FA.plan(dq, dv, BF16, True) == "cuda_core"


def _mla_head_dims():
    """minicpm3-4b's (Dq, Dv) as ``mla_block`` hands them to the kernel:
    Dq = dn + dr, Dv = dv."""
    a = get_config("minicpm3_4b").attention
    return a.qk_nope_head_dim + a.qk_rope_head_dim, a.v_head_dim


def test_mla_head_dims_pick_wgmma_dv_in_bf16():
    dq, dv = _mla_head_dims()
    assert (dq, dv) == (96, 64)
    assert (dq, dv) in FA.WGMMA_DV_HEAD_DIMS
    assert FA.plan(dq, dv, BF16, True) == "wgmma_dv"


@pytest.mark.parametrize("dtype,aligned", [(torch.float32, True),
                                           (torch.float32, False),
                                           (BF16, False)])
def test_mla_head_dims_in_float32_or_unaligned_pick_cuda_core(dtype,
                                                              aligned):
    assert FA.plan(*_mla_head_dims(), dtype, aligned) == "cuda_core"


@pytest.mark.parametrize("dq,dv", [(64, 96), (96, 128), (96, 32), (80, 64)])
def test_near_mla_head_dims_pick_cuda_core(dq, dv):
    """Only the instantiated (Dq, Dv) go to ``wgmma_dv``: Dq and Dv
    swapped, a wider Dv and others stay on ``cuda_core`` (phi-3-vision's
    96 / 96 takes ``wgmma_96``)."""
    assert FA.plan(dq, dv, BF16, True) == "cuda_core"


def test_unaligned_mla_view_picks_cuda_core():
    q = torch.zeros((40, 64, 96), dtype=BF16)
    flat = torch.zeros(40 * 64 * 64 + 1, dtype=BF16)
    v1 = flat[1:].view(40, 64, 64)
    assert FA.plan(96, 64, BF16, FA._aligned16(q, q, flat[:-1].view(
        40, 64, 64))) == "wgmma_dv"
    assert FA.plan(96, 64, BF16, FA._aligned16(q, q, v1)) == "cuda_core"


def test_unaligned_bf16_picks_cuda_core():
    assert FA.plan(128, 128, BF16, False) == "cuda_core"


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int32])
def test_plan_rejects_other_types(dtype):
    with pytest.raises(TypeError):
        FA.plan(128, 128, dtype, True)


def test_alignment_is_read_from_the_pointers():
    q = torch.zeros((4, 128, 128), dtype=BF16)
    assert FA._aligned16(q, q, q)
    flat = torch.zeros(4 * 128 * 128 + 1, dtype=BF16)
    q1 = flat[1:].view(4, 128, 128)
    assert q1.is_contiguous() and not FA._aligned16(q, q1, q)
    assert FA.plan(128, 128, BF16, FA._aligned16(q, q1, q)) == "cuda_core"


def test_cpu_tensors_count_a_plain_call_and_no_variant_launch():
    FA.reset_counts()
    q = torch.randn((8, 64, 128)).to(BF16)
    kv = torch.randn((2, 64, 128)).to(BF16)
    out = FA.flash_attention(q, kv, kv, causal=True)
    assert torch.equal(out, FA.flash_attention_torch(q, kv, kv, causal=True))
    assert FA.PLAIN_CALLS["flash_attention"] == 1
    assert FA.LAUNCHES["flash_attention"] == 0
    assert all(n == 0 for n in FA.VARIANT_LAUNCHES.values())
    assert set(FA.VARIANT_LAUNCHES) == set(FA.VARIANTS)
    FA.reset_counts()
    assert FA.PLAIN_CALLS["flash_attention"] == 0


def test_every_variant_has_an_entry_point():
    """The planned kernels, and the private mma.sync yardstick."""
    names = set(FA.ENTRY_POINTS.values())
    for name in names:
        assert f"int {name}(" in FA.SOURCE.read_text()
    assert set(FA.WGMMA_INSTANCES.values()) | {"mma_sync"} <= set(
        FA.ENTRY_POINTS)
    assert set(FA.VARIANTS) == set(FA.WGMMA_INSTANCES.values()) | {
        "cuda_core", "mma_sync"}
    assert {("cuda_core", t) for t in FA.DTYPES} <= set(FA.ENTRY_POINTS)


@pytest.mark.parametrize("variant,dims", [
    pytest.param(v, dims, id=v) for v, dims in (
        ("wgmma", (128, 128)), ("wgmma_dv", (96, 64)),
        ("wgmma_120", (120, 120)), ("wgmma_96", (96, 96)),
        ("mma_sync", (128, 128)))])
def test_bf16_kernels_have_their_own_entry_point(variant, dims):
    """Each bf16 tensor-core kernel is reached through an entry point of
    its own (the counters tell which one a path ran), which refuses other
    head dims and unaligned pointers; each wgmma instance's entry checks
    its (Dq, Dv) and launches the template at them."""
    name = FA.ENTRY_POINTS[variant]
    assert list(FA.ENTRY_POINTS.values()).count(name) == 1
    src = FA.SOURCE.read_text()
    body = src[src.index(f"int {name}("):]
    body = body[:body.index("\n}\n")]
    dq, dv = dims
    assert f"Dq != {dq} || Dv != {dv}" in body
    assert "!aligned16(q, k, v, o)" in body
    if variant != "mma_sync":
        assert FA.WGMMA_INSTANCES[dims] == variant
        assert f"launch_wgmma<{dq}, {dv}>" in body


def test_library_name_hashes_the_shared_headers(tmp_path, monkeypatch):
    """Editing a ``csrc/*.cuh`` renames every library, so a header change
    is never served by a stale build."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    src = csrc / "flash_attention.cu"
    before = _build.library_path(src)
    assert before == _build.library_path(src)
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build.library_path(src)
    assert after != before and after.parent == before.parent
    assert after.name.startswith("flash_attention_")
