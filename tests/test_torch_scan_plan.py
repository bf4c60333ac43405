"""The port's selective-scan dispatch plan, on the CPU:
``selective_scan.plan`` picks the kernel of each scan, and how it is cut,
from the shape and the alignment of the pointers alone -- checked here for
coverage (every (channel, state) held by exactly one lane of one block),
for the PR 12 kernel on shapes TMA cannot take, at jamba's two mamba
shapes and for the ring's shared memory.  A numpy emulation of the ring
kernel's arithmetic order (states split over lanes, partial dots, the
``__shfl_xor_sync`` tree) is held to ``selective_scan_torch`` and to the
reference's Pallas kernel in interpret mode, within the reference's
atol/rtol 1e-4.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 6-8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.configs import get_config
from repro_torch.kernels import selective_scan as SS

H100_SMS = 132
SMEM_PER_BLOCK = 232448    # 227 KB, the most a block can have
SMEM_PER_SM = 233472       # 228 KB; each resident block also costs 1 KB
# the blocks a ring kernel's launch bounds ask to fit on an SM, by lanes
# (csrc/selective_scan.cu, ring::Cfg::MIN_BLOCKS)
MIN_BLOCKS = {1: 2, 2: 4, 4: 8, 8: 8}
DIMS = [1, 33, 100, 260, 8192]
STATES = [1, 3, 4, 5, 8, 16]
BATCHES = [1, 4]


def _jamba_shapes():
    """(batch, S, D, N) of jamba's mamba layers in ``chip_smoke.py``: the
    bf16 scoring forward (4 x 2048) and the float32 check (1 x 1024)."""
    cfg = get_config("jamba_v01_52b")
    di, n = cfg.ssm.d_inner(cfg.d_model), cfg.ssm.d_state
    return [(4, 2048, di, n), (1, 1024, di, n)]


def _cells(p, d, n):
    """Every (channel, state) the plan's blocks and lanes hold, one entry
    per holder: block x's consumer thread tid holds channel x * channels
    + tid // lanes and states k * spl .. k * spl + spl - 1, k = tid %
    lanes (the pr12 kernel: one thread a channel, all its states)."""
    if p.variant == "pr12":
        return [(ch, s) for ch in range(p.grid[0] * p.channels) if ch < d
                for s in range(n)]
    spl = SS.padded_states(n) // p.lanes
    out = []
    for x in range(p.grid[0]):
        for tid in range(SS.RING_CONSUMERS):
            ch, k = x * p.channels + tid // p.lanes, tid % p.lanes
            out += [(ch, s) for s in range(k * spl, (k + 1) * spl)
                    if ch < d and s < n]
    return out


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("n", STATES)
@pytest.mark.parametrize("batch", BATCHES)
def test_plan_covers_every_channel_and_state_once(d, n, batch):
    for aligned in (True, False):
        p = SS.plan(batch, 64, d, n, aligned, sms=H100_SMS)
        cells = _cells(p, d, n)
        assert len(cells) == len(set(cells)) == d * n
        assert p.grid[1] == batch
        assert (p.grid[0] - 1) * p.channels < d <= p.grid[0] * p.channels
        if p.variant == "ring":
            assert p.lanes * p.channels == SS.RING_CONSUMERS
            assert p.lanes <= SS.padded_states(n)
            assert p.steps == SS.RING_STEPS and p.stages >= 2


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("n", STATES)
def test_misaligned_or_ragged_rows_pick_pr12(d, n):
    """A pointer off a 16-byte boundary, or D % 4 != 0 (a row stride TMA
    cannot take), goes to the PR 12 kernel; everything else to the ring."""
    assert SS.plan(4, 64, d, n, False).variant == "pr12"
    want = "ring" if d % 4 == 0 else "pr12"
    assert SS.plan(4, 64, d, n, True).variant == want


@pytest.mark.parametrize("batch,s,d,n", _jamba_shapes())
def test_jamba_shapes_pick_the_ring_on_a_full_wave(batch, s, d, n):
    """Both of jamba's mamba shapes get the ring kernel in one wave that
    loads the 132 SMs as evenly as the card allows: no SM holds more
    channels than the even share rounded up to one block's channels (the
    recurrence cannot be split across SMs, so the busiest SM sets the
    time), with every block resident at once and at least 128 of the 132
    SMs busy; and of the lane counts that achieve that, the fewest."""
    assert (d, n) == (8192, 16)
    p = SS.plan(batch, s, d, n, True, sms=H100_SMS)
    assert p.variant == "ring"
    blocks = p.grid[0] * p.grid[1]
    busiest = SS.busiest_sm_channels(batch, d, p.lanes, H100_SMS)
    share = -(-batch * d // H100_SMS)
    assert busiest == -(-share // p.channels) * p.channels
    assert blocks >= 128 and -(-blocks // H100_SMS) <= MIN_BLOCKS[p.lanes]
    for lanes in SS.PLAN_LANES:
        assert SS.busiest_sm_channels(batch, d, lanes, H100_SMS) >= busiest
        if lanes < p.lanes:
            assert SS.busiest_sm_channels(batch, d, lanes, H100_SMS) > busiest


def test_jamba_lanes_follow_the_sweep():
    """Scoring (4 x 2048 x 8192) takes one lane a channel, the float32
    check (1 x 1024 x 8192) two: what tools/scan_breakdown.py measured
    fastest at each shape."""
    (b1, s1, d, n), (b2, s2, _, _) = _jamba_shapes()
    assert SS.plan(b1, s1, d, n, True).lanes == 1
    assert SS.plan(b2, s2, d, n, True).lanes == 2


@pytest.mark.parametrize("lanes,n", [(L, n) for n in STATES
                                     for L in SS.RING_LANES
                                     if L <= SS.padded_states(n)])
def test_ring_shared_memory_fits(lanes, n):
    """A ring block (every instance the library has) stays within 227 KB,
    and the blocks its launch bounds ask for fit on an SM together."""
    smem = SS.ring_smem_bytes(lanes, n)
    assert smem <= SMEM_PER_BLOCK
    assert MIN_BLOCKS[lanes] * (smem + 1024) <= SMEM_PER_SM


def test_plan_rejects_states_the_kernels_lack():
    for n in (0, SS.MAX_STATE + 1):
        with pytest.raises(ValueError):
            SS.plan(1, 8, 64, n, True)
    with pytest.raises(ValueError):
        SS.ring_plan(1, 64, 3)


def test_cpu_tensors_count_a_plain_call_and_no_variant_launch():
    SS.reset_counts()
    x = torch.zeros((1, 4, 8))
    s = torch.zeros((1, 4, 2))
    SS.selective_scan(x, x, s, s, torch.zeros((8, 2)), torch.zeros(8))
    assert SS.PLAIN_CALLS["selective_scan"] == 1
    assert SS.LAUNCHES["selective_scan"] == 0
    assert set(SS.VARIANT_LAUNCHES) == set(SS.VARIANTS)
    assert all(v == 0 for v in SS.VARIANT_LAUNCHES.values())


def test_every_entry_point_is_in_the_source():
    src = SS.SOURCE.read_text()
    for name in ("selective_scan_f32", "selective_scan_f32_ring",
                 "selective_scan_ring_smem_bytes",
                 "selective_scan_ring_steps"):
        assert f"int {name}(" in src


# ---------------------------------------------------------------------------
# the ring kernel's arithmetic order, emulated in numpy
# ---------------------------------------------------------------------------

LOG2E = np.float32(1.4426950408889634)


def _partial_dot(h, c):
    """The kernel's ``dot``: P interleaved partial sums over the last axis
    (SPL states), added as a tree."""
    spl = h.shape[-1]
    n_p = 4 if spl >= 16 else (2 if spl >= 2 else 1)
    p = [h[..., j] * c[..., j] for j in range(n_p)]
    for j in range(n_p, spl):
        p[j % n_p] = h[..., j] * c[..., j] + p[j % n_p]
    if n_p == 4:
        return (p[0] + p[1]) + (p[2] + p[3])
    return p[0] + p[1] if n_p == 2 else p[0]


def emulate_ring(x, dt, b, c, a, d, lanes):
    """y as the ring kernel computes it, in float32: lane k of a channel
    holds states k * spl .. (k + 1) * spl - 1 (zeros past N), takes its
    partial dot, and the lanes' sums meet by xor shuffles (m = 1, 2, 4).
    Every lane must end with the same value; lane 0 stores it."""
    bsz, s, dm = x.shape
    n = a.shape[1]
    np_ = SS.padded_states(n)
    spl = np_ // lanes
    f32 = np.float32
    a2 = np.zeros((dm, np_), f32)
    a2[:, :n] = a * LOG2E
    bp = np.zeros((bsz, s, np_), f32)
    cp = np.zeros((bsz, s, np_), f32)
    bp[..., :n], cp[..., :n] = b, c
    h = np.zeros((bsz, dm, np_), f32)
    y = np.zeros((bsz, s, dm), f32)
    k = np.arange(lanes)
    for t in range(s):
        dv, xv = dt[:, t, :, None], x[:, t]
        dA = np.exp2(dv * a2[None])
        dtx = dt[:, t] * xv
        h = dA * h + dtx[..., None] * bp[:, t, None, :]
        acc = _partial_dot(h.reshape(bsz, dm, lanes, spl),
                           cp[:, t].reshape(bsz, 1, lanes, spl))
        m = 1
        while m < lanes:
            acc = acc + acc[..., k ^ m]
            m <<= 1
        assert (acc == acc[..., :1]).all(), "lanes disagree after the tree"
        y[:, t] = d * xv + acc[..., 0]
    return y


# the shapes of tests/test_torch_kernels.py's plain-vs-Pallas scan test,
# with the block width bd the Pallas kernel takes there
KERNEL_TEST_SHAPES = [(2, 16, 32, 4, 16), (1, 64, 128, 16, 64),
                      (2, 33, 48, 8, 16), (1, 20, 100, 8, 64)]


@pytest.mark.parametrize("B,S,D,N,bd", KERNEL_TEST_SHAPES)
def test_ring_order_matches_plain_and_pallas(B, S, D, N, bd):
    rng = np.random.default_rng(B * S + D + N)
    x = (rng.normal(size=(B, S, D)) * 0.5).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, S, D))) * 0.1).astype(np.float32)
    b = rng.normal(size=(B, S, N)).astype(np.float32)
    c = rng.normal(size=(B, S, N)).astype(np.float32)
    a = -(np.abs(rng.normal(size=(D, N))) + 0.1).astype(np.float32)
    d = rng.normal(size=(D,)).astype(np.float32)
    plain = SS.selective_scan_torch(*map(torch.from_numpy,
                                         (x, dt, b, c, a, d))).numpy()
    pallas = np.asarray(ref_ops.selective_scan(
        *map(jnp.asarray, (x, dt, b, c, a, d)), bd=bd))
    planned = SS.plan(B, S, D, N, True).lanes
    for lanes in sorted({planned} | {L for L in SS.RING_LANES
                                     if L <= SS.padded_states(N)}):
        y = emulate_ring(x, dt, b, c, a, d, lanes)
        assert y.dtype == np.float32
        np.testing.assert_allclose(y, plain, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(y, pallas, atol=1e-4, rtol=1e-4)
