"""The port's slice as a whole: ``Explorer(engine="blocked")`` from describe
to explore, held against the JAX reference's ``Explorer(engine="blocked")``
on the same candidates (made with numpy from a fixed seed).

Contracts:

* θ = 1 cycles: EXACT (the golden per-cell literals of
  ``tests/test_dse_explorer.py`` and the reference's own baselines).
* Random θ, cycles and energy: rtol 1e-6.  Both packages run the same
  float32 operations; the reference's compiled sweep may let XLA fuse
  ``fu + mem_lat·scale`` into an FMA, a last-ulp difference in some nodes'
  work.
* Pareto index sets and the coordinate-descent incumbent: identical.
* Port blocked vs port wavefront at random θ: rtol 1e-5 (closure squaring
  associates path sums differently; the reference's own spread is 6.8e-6).

Sizes: oma/gemm and systolic/gemm enter at reduced sizes through explicit
``Scenario``s (oma 3x3x3 GEMM, 379 nodes = 3 blocks; systolic 4x4x8 on a
4x4 array, 336 nodes = 3 blocks) so that the file stays well under a
minute on the CPU; the other eight cells are the default ones.  The full
default matrix is held to the golden θ = 1 cycles below, and runs at 4096
candidates on the card in ``chip_smoke.py``.
"""

import jax  # noqa: F401  (both frameworks in one process; JAX on the CPU)
import numpy as np
import pytest
import torch

from repro.core.aidg import explorer as ref_ex
from repro_torch.core.aidg import explorer as port_ex
from repro_torch.kernels import maxplus as K

CPU = "cpu"
SAME_RTOL = 1e-6
CROSS_RTOL = 1e-5

GOLDEN_THETA1_CYCLES = {
    "oma/gemm": 3832.0,
    "systolic/gemm": 1187.0,
    "gamma/gemm": 2954.0,
    "gamma/attention": 980.0,
    "gamma/scan": 2753.0,
    "eyeriss/conv": 91.0,
    "plasticine/reduce": 91.0,
    "tpu_v5e/gemm": 3881.0,
    "tpu_v5e/attention": 225.0,
    "tpu_v5e/scan": 613.0,
}


def _cells(mod):
    """The slice's test matrix for package ``mod`` (reference or port):
    reduced oma/systolic, then the eight other default cells."""
    S = mod.Scenario
    small = [
        S("oma", "gemm", lambda: mod._build_oma_gemm(3), (("n", 3),)),
        S("systolic", "gemm",
          lambda: mod._build_systolic_gemm(4, 4, 8, 4, 4),
          (("mklrc", (4, 4, 8, 4, 4)),), 0.04),
    ]
    return small + mod.default_scenarios()[2:]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes on a few cores; one
    intra-op thread keeps this file's CPU tensors from oversubscribing
    them (the JAX side keeps its own threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def candidates():
    c = port_ex.random_candidates(port_ex.DEFAULT_SPACE, 8, seed=0)
    assert np.array_equal(
        c, ref_ex.random_candidates(ref_ex.DEFAULT_SPACE, 8, seed=0))
    return c


@pytest.fixture(scope="module")
def ref_explorer():
    return ref_ex.Explorer(_cells(ref_ex), engine="blocked")


@pytest.fixture(scope="module")
def port_explorer():
    return port_ex.Explorer(_cells(port_ex), engine="blocked", device=CPU)


@pytest.fixture(scope="module")
def explored(ref_explorer, port_explorer, candidates):
    return ref_explorer.explore(candidates), port_explorer.explore(candidates)


def _close(out, ref, rtol, what):
    err = np.max(np.abs(np.asarray(out, np.float64) - ref)
                 / np.abs(np.asarray(ref, np.float64)))
    assert err <= rtol, (what, err)


@pytest.mark.parametrize("engine", ["blocked", "wavefront"])
def test_default_matrix_theta_one_golden(engine):
    """All 10 default cells at full size: the port's θ = 1 cycles equal the
    reference's pinned literals exactly."""
    ex = port_ex.Explorer(engine=engine, device=CPU)
    assert ex.scenario_names == list(GOLDEN_THETA1_CYCLES)
    assert ex.baselines.tolist() == list(GOLDEN_THETA1_CYCLES.values())


def test_explore_matches_reference(explored, ref_explorer, port_explorer):
    ref, port = explored
    assert port.scenario_names == ref.scenario_names
    assert np.array_equal(port_explorer.baselines, ref_explorer.baselines)
    assert np.array_equal(port.cycles[0], ref.cycles[0])      # θ = 1 row
    for j, name in enumerate(ref.scenario_names):
        _close(port.cycles[1:, j], ref.cycles[1:, j], SAME_RTOL, name)
    _close(port.energy, ref.energy, SAME_RTOL, "energy")
    _close(port.latency, ref.latency, SAME_RTOL, "latency")
    assert np.array_equal(port.cost, ref.cost)
    assert np.array_equal(port.pareto, ref.pareto)


def test_blocked_matches_wavefront_engine(explored, candidates):
    _, port = explored
    wf = port_ex.Explorer(_cells(port_ex), engine="wavefront", device=CPU)
    cyc = wf.explore(candidates).cycles
    assert np.array_equal(cyc[0], port.cycles[0])
    _close(port.cycles, cyc, CROSS_RTOL, "blocked vs wavefront")


def test_refine_incumbent_matches_reference(ref_explorer, port_explorer):
    # points=7 -> batches of 8, the shape the explore test compiled
    ref = ref_explorer.refine(rounds=1, points=7)
    port = port_explorer.refine(rounds=1, points=7)
    assert np.array_equal(port, ref)


def test_blocked_path_runs_every_product_through_the_kernel_module(
        port_explorer, candidates):
    """On the CPU every ⊗ of the blocked path goes through the kernel
    module's wrappers, which count their plain-version calls: the closure
    (planned in lower mode), the folded sub-diagonal matvec and the lower
    closure matvec -- and no general matmul or matvec."""
    K.reset_counts()
    port_explorer.evaluate(candidates[:2])
    assert K.PLAIN_CALLS["maxplus_closure"] > 0
    assert K.PLAIN_CALLS["maxplus_matvec_folded"] > 0
    assert K.PLAIN_CALLS["maxplus_matvec_lower"] > 0
    assert K.PLAIN_CALLS["maxplus_matmul"] == 0
    assert K.PLAIN_CALLS["maxplus_matvec"] == 0
    assert sum(K.LAUNCHES.values()) == 0


def test_unported_engines_and_methods_raise(port_explorer):
    """"packed" (the default) and "condensed" are ported now and agree
    with the blocked engine at θ = 1; the gradient search is ported too
    (on a per-cell engine it descends each cell's wavefront soft family)
    and returns an in-box design; the sharded evaluator needs the packed
    engine."""
    for engine in ("packed", "condensed"):
        ex = port_ex.Explorer(_cells(port_ex)[5:6], engine=engine,
                              device=CPU)
        assert ex.baselines.tolist() == [GOLDEN_THETA1_CYCLES["eyeriss/conv"]]
    assert port_ex.Explorer(_cells(port_ex)[5:6], device=CPU).engine == \
        "packed"
    theta = port_explorer.refine(method="grad", starts=1, steps=2)
    assert np.array_equal(port_explorer.space.clip(theta), theta)
    with pytest.raises(ValueError, match="requires engine='packed'"):
        port_explorer.evaluate(np.ones((1, 5)), sharded=True)
    with pytest.raises(ValueError, match="unknown engine"):
        port_ex.Explorer(_cells(port_ex)[5:6], engine="nope", device=CPU)
