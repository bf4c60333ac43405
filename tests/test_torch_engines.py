"""The port's max-plus engines, held against the JAX reference on the same
graphs: each reference AIDG is carried across with ``aidg_from_numpy`` and
the same inputs, made with numpy from a fixed seed, go through both.

Contracts (stated per test):

* θ = 1 (the AIDG's own integer latencies): EXACT equality.
* Random latencies, same engine in both packages: rtol 1e-6.  Both run
  the same float32 additions and maxes in the same order, so the results
  are in fact equal; 1e-6 leaves room for the reference's compiled
  single-slot queue ``cumsum``, which XLA may sum in another order.
* Random latencies across engines (blocked vs wavefront), longest path
  without queues: rtol 1e-5 — closure squaring associates the path sums
  differently (the reference measured a 6.8e-6 blocked-vs-wavefront
  spread).  With queues, see ``test_fixed_point_batch_matches_reference``.
"""

import jax  # noqa: F401  (both frameworks in one process; JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aidg import dse as ref_dse
from repro.core.aidg import explorer as ref_ex
from repro.core.aidg import maxplus as ref_mp
from repro.kernels.maxplus import maxplus_matmul_pallas
from repro_torch.convert import ARRAY_FIELDS, DICT_FIELDS, aidg_from_numpy
from repro_torch.core.aidg import builder as port_builder
from repro_torch.core.aidg import dse as port_dse
from repro_torch.core.aidg import explorer as port_ex
from repro_torch.core.aidg import maxplus as port_mp

CPU = "cpu"
SAME_RTOL = 1e-6
CROSS_RTOL = 1e-5

# cells with multi-block graphs and every queue family: gamma/gemm (2-slot
# dram), systolic/gemm (4-slot dram, 12 blocks of 128), plasticine/reduce
# (four 2-slot pmus), tpu_v5e/gemm (8-slot hbm + 4-slot vmem), eyeriss/conv
CELLS = ["gamma/gemm", "systolic/gemm", "plasticine/reduce", "tpu_v5e/gemm",
         "eyeriss/conv"]
_BY_NAME = {s.name: s for s in ref_ex.default_scenarios()}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes on a few cores; one
    intra-op thread keeps this file's CPU tensors from oversubscribing
    them (the JAX side keeps its own threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name):
    """(reference CompiledAIDG, the port's CompiledAIDG of the same graph
    carried across with aidg_from_numpy)."""
    ref = ref_ex.compile_scenario(_BY_NAME[name]).compiled_aidg
    fields = {k: getattr(ref.aidg, k) for k in (*ARRAY_FIELDS, *DICT_FIELDS)}
    return ref, port_builder.compile_aidg(aidg_from_numpy(fields))


def _random_inputs(a, B, seed):
    """(B, n) work, (B, n) base, {storage: (B, k)} latencies: the AIDG's
    own values scaled by log-uniform factors in [1/4, 4]."""
    rng = np.random.default_rng(seed)
    f = lambda shape: np.exp(rng.uniform(np.log(0.25), np.log(4.0), shape))
    work = np.maximum(1.0, a.work[None] * f((B, a.n))).astype(np.float32)
    base = (a.base[None] * f((B, a.n))).astype(np.float32)
    lats = {k: (v[None] * f((B, len(v)))).astype(np.float32)
            for k, v in a.storage_lat.items()}
    return work, base, lats


def _close(out, ref, rtol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.max(np.abs(out - ref) / np.maximum(np.abs(ref), 1.0))
    assert err <= rtol, err


# ---------------------------------------------------------------------------
# longest path, no queueing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CELLS)
def test_longest_path_engines_theta_one_exact(name):
    ref, port = _pair(name)
    t_scan = np.asarray(ref_mp.longest_path_scan(ref))
    for fn, r in ((port_mp.longest_path_scan, t_scan),
                  (port_mp.longest_path_wavefront,
                   np.asarray(ref_mp.longest_path_wavefront(ref))),
                  (port_mp.longest_path_blocked,
                   ref_mp.longest_path_blocked(ref).astype(np.float32))):
        out = fn(port, device=CPU).numpy()
        assert np.array_equal(out, r), fn.__name__
        assert np.array_equal(out, t_scan), fn.__name__


@pytest.mark.parametrize("name", CELLS[:3])
def test_longest_path_engines_random_latencies(name):
    ref, port = _pair(name)
    work, base, _ = _random_inputs(ref.aidg, 3, seed=11)
    outs = {e: getattr(port_mp, f"longest_path_{e}")(
        port, work=work, base=base, device=CPU).numpy()
        for e in ("scan", "wavefront", "blocked")}
    for i in range(3):
        w, b = jnp.asarray(work[i]), jnp.asarray(base[i])
        _close(outs["scan"][i], ref_mp.longest_path_scan(ref, w, b),
               SAME_RTOL)
        _close(outs["wavefront"][i],
               ref_mp.longest_path_wavefront(ref, w, b), SAME_RTOL)
        _close(outs["blocked"][i],
               ref_mp.longest_path_blocked(ref, work=w, base=b), SAME_RTOL)
    _close(outs["blocked"], outs["wavefront"], CROSS_RTOL)


@pytest.mark.parametrize("block", [16, 32])
def test_blocked_small_blocks_match_pallas_blocked(block):
    """Many small blocks (far edges, the block-0 mask, ragged last block):
    the port's blocked engine against the reference's blocked engine with
    every ⊗ through the Pallas kernel (interpret mode)."""
    ref, port = _pair("gamma/gemm")
    assert ref.n % block != 0 or block == 16
    ref_out = ref_mp.longest_path_blocked(ref, block=block,
                                          matmul=maxplus_matmul_pallas)
    out = port_mp.longest_path_blocked(port, block=block, device=CPU)
    assert np.array_equal(out.numpy(), ref_out.astype(np.float32))
    work, base, _ = _random_inputs(ref.aidg, 2, seed=block)
    out = port_mp.longest_path_blocked(port, block=block, work=work,
                                       base=base, device=CPU).numpy()
    for i in range(2):
        _close(out[i], ref_mp.longest_path_blocked(
            ref, block=block, matmul=maxplus_matmul_pallas,
            work=jnp.asarray(work[i]), base=jnp.asarray(base[i])), SAME_RTOL)


@pytest.mark.parametrize("block", [16, 32, 128])
def test_blocked_structure_copy_matches_reference(block):
    ref, port = _pair("systolic/gemm")
    for r, p in zip(ref_mp._blocked_structure(ref, block),
                    port_mp._blocked_structure(port, block)):
        assert r.dtype == p.dtype and np.array_equal(r, p)


# ---------------------------------------------------------------------------
# storage queues and the fixed point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slots", [1, 2, 4])
def test_slot_queue_matches_reference(slots):
    rng = np.random.default_rng(slots)
    arrival = np.sort(rng.integers(0, 200, (3, 40))).astype(np.float32)
    lat = rng.integers(1, 9, (3, 40)).astype(np.float32)
    out = port_mp.slot_queue_scan(torch.from_numpy(arrival),
                                  torch.from_numpy(lat), slots).numpy()
    for i in range(3):
        ref = np.asarray(ref_mp.slot_queue_scan(jnp.asarray(arrival[i]),
                                                jnp.asarray(lat[i]), slots))
        assert np.array_equal(out[i], ref)      # integer latencies: exact
    # non-integer latencies: same engine, rtol 1e-6
    lat = (lat * rng.uniform(0.25, 4, lat.shape)).astype(np.float32)
    out = port_mp.slot_queue_scan(torch.from_numpy(arrival),
                                  torch.from_numpy(lat), slots).numpy()
    for i in range(3):
        _close(out[i], ref_mp.slot_queue_scan(jnp.asarray(arrival[i]),
                                              jnp.asarray(lat[i]), slots),
               SAME_RTOL)


@pytest.mark.parametrize("name", CELLS[:4])
def test_fixed_point_batch_matches_reference(name):
    ref, port = _pair(name)
    work, base, lats = _random_inputs(ref.aidg, 4, seed=5)
    work[0], base[0] = ref.aidg.work, ref.aidg.base      # row 0: θ = 1
    for k in lats:
        lats[k][0] = ref.aidg.storage_lat[k]
    outs = {e: port_mp.fixed_point_batch(
        port, works=work, bases=base, storage_lats=lats, n_iters=2,
        engine=e, device=CPU).numpy() for e in ("wavefront", "scan",
                                                "blocked")}
    # against the reference's scan and blocked engines (its eager-vmapped
    # wavefront costs seconds per cell and adds no coverage: the port's
    # scan and wavefront add in the same order per node, so they must be
    # equal, which is asserted below)
    for engine in ("scan", "blocked"):
        r = np.asarray(ref_mp.fixed_point_batch(
            ref, works=jnp.asarray(work), bases=jnp.asarray(base),
            storage_lats={k: jnp.asarray(v) for k, v in lats.items()},
            n_iters=2, engine=engine))
        assert np.array_equal(outs[engine][0], r[0]), engine   # θ = 1
        _close(outs[engine], r, SAME_RTOL)
    assert np.array_equal(outs["scan"], outs["wavefront"])
    # No blocked-vs-wavefront bound here.  With raw random latencies (work,
    # base and every storage latency drawn independently) a queue's stable
    # sort turns a last-ulp difference between the engines' path sums into
    # another service order: the REFERENCE's own blocked and wavefront
    # engines differ by up to 0.4% on systolic/gemm's 4-slot dram with this
    # input.  The port is held to the reference engine by engine above; the
    # cross-engine bound (rtol 1e-5) is checked at θ = 1 here and under
    # random θ, the DSE contract, in test_torch_explorer.py.
    assert np.array_equal(outs["blocked"][0], outs["wavefront"][0])


def test_sweep_chunks_and_single_point_match_reference():
    """``sweep`` with a padded tail chunk and ``evaluate_theta`` on one
    point: θ = 1 exact, random θ rtol 1e-6 against the reference."""
    name = "tpu_v5e/gemm"
    rcs = ref_ex.compile_scenario(_BY_NAME[name])
    pcs = port_ex.compile_scenario(
        next(s for s in port_ex.default_scenarios() if s.name == name))
    cand = ref_ex.random_candidates(ref_ex.DEFAULT_SPACE, 8, seed=4)
    to, ts = ref_ex.DEFAULT_SPACE.theta_for(rcs.problem, cand)
    ref = ref_dse.sweep(rcs.problem, to, ts, engine="blocked")
    out = port_dse.sweep(pcs.problem, to, ts, chunk=3, engine="blocked",
                         device=CPU)
    assert out.shape == (8,) and out[0] == ref[0]
    _close(out, ref, SAME_RTOL)
    one = port_dse.evaluate_theta(pcs.problem, to[5], ts[5],
                                  engine="blocked", device=CPU)
    assert one.dim() == 0 and float(one) == out[5]
    _close(float(one), ref_dse.evaluate_theta(
        rcs.problem, jnp.asarray(to[5]), jnp.asarray(ts[5]),
        engine="blocked"), SAME_RTOL)
    with pytest.raises(ValueError, match="chunk"):
        port_dse.sweep(pcs.problem, to, ts, chunk=0, device=CPU)


def test_fixed_point_single_vector_keeps_rank():
    ref, port = _pair("tpu_v5e/gemm")
    t = port_mp.fixed_point_torch(port, n_iters=2, device=CPU)
    assert t.shape == (port.n,)
    r = np.asarray(ref_mp.fixed_point_jax(ref, n_iters=2))
    assert np.array_equal(t.numpy(), r)


def test_condensed_engine_not_ported_yet():
    """The condensed engine is ported now: its fixed point equals the
    reference's node for node at θ = 1; unknown engines still raise."""
    ref, port = _pair("tpu_v5e/gemm")
    t = port_mp.fixed_point_torch(port, engine="condensed", device=CPU)
    assert np.array_equal(
        t.numpy(), np.asarray(ref_mp.fixed_point_jax(ref, engine="condensed")))
    with pytest.raises(ValueError, match="unknown engine"):
        port_mp.fixed_point_torch(port, engine="nope", device=CPU)
