"""The port's default Explorer path — the condensed engine, the network
stack and the packed matrix — held against the JAX reference on the CPU,
on the same candidates (made with numpy from a fixed seed).

Contracts:

* θ = 1 cycles: EXACT.  The 10 operator cells equal the reference's
  pinned ``GOLDEN_THETA1_CYCLES`` and the reference's own packed matrix
  bit for bit; the olmo-1b network cells lie within rel 1e-4 of the
  reference's ``GOLDEN_E2E_THETA1`` and within rtol 1e-6 of the
  reference's packed evaluation (float32 composition order).
* The condensed engine per cell: θ = 1 bit for bit, random θ rtol 1e-6.
* ``affine_scan``: bit for bit equal to ``lax.associative_scan`` of the
  same operator (the same combine order, so θ = 1 stays exact).
* Random θ through the packed matrix: cycles rtol 2e-6 — the reference's
  ``cumsum`` on the CPU is a tree of adds (``associative_scan``), the
  port's is sequential, so the absorbed-prefix and single-slot-queue sums
  round differently in the last few ulps; energy rtol 1e-6.
* Pareto index sets, cost and the coordinate-descent incumbent:
  identical.

Sizes: the 10 default operator cells at full size, and olmo-1b's six
network cells (``networks="olmo_1b"``); the whole 31-cell matrix runs on
the card in ``chip_smoke.py``.
"""

import jax  # noqa: F401  (both frameworks in one process; JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aidg import dse as ref_dse
from repro.core.aidg import explorer as ref_ex
from repro_torch.core.aidg import dse as port_dse
from repro_torch.core.aidg import explorer as port_ex
from repro_torch.core.aidg import maxplus as port_mp
from repro_torch.core.network import NetworkScenario

from test_dse_explorer import GOLDEN_THETA1_CYCLES
from test_network import GOLDEN_E2E_THETA1

CPU = "cpu"
SAME_RTOL = 1e-6
PACKED_RTOL = 2e-6
REF_SCEN = ref_ex.default_scenarios()
PORT_SCEN = port_ex.default_scenarios()
IDS = [s.name for s in REF_SCEN]
N_CAND = 16


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
    c = port_ex.random_candidates(port_ex.DEFAULT_SPACE, N_CAND, seed=0)
    assert np.array_equal(
        c, ref_ex.random_candidates(ref_ex.DEFAULT_SPACE, N_CAND, seed=0))
    return c


def _close(out, ref, rtol, what):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    err = np.max(np.abs(out - ref) / np.abs(ref))
    assert err <= rtol, (what, err)


# ---------------------------------------------------------------------------
# the condensed engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(REF_SCEN)), ids=IDS)
def test_condensed_engine_matches_reference(i):
    """One batched sweep per package: row 0 at θ = 1 (bit for bit), the
    other rows at random θ."""
    rp = ref_ex.compile_scenario(REF_SCEN[i]).problem
    pp = port_ex.compile_scenario(PORT_SCEN[i]).problem
    rng = np.random.default_rng(i)
    to = np.exp(rng.uniform(np.log(0.25), np.log(4.0), (6, pp.n_op))
                ).astype(np.float32)
    ts = np.exp(rng.uniform(np.log(0.25), np.log(4.0), (6, pp.n_st))
                ).astype(np.float32)
    to[0], ts[0] = 1.0, 1.0
    ref = ref_dse.sweep(rp, to, ts, engine="condensed")
    port = port_dse.sweep(pp, to, ts, engine="condensed", device=CPU)
    assert port[0] == ref[0] == GOLDEN_THETA1_CYCLES[IDS[i]]
    _close(port[1:], ref[1:], SAME_RTOL, IDS[i])
    # the port's condensed and wavefront engines agree at θ = 1 node by node
    ca = port_ex.compile_scenario(PORT_SCEN[i]).compiled_aidg
    assert torch.equal(
        port_mp.fixed_point_torch(ca, engine="condensed", device=CPU),
        port_mp.fixed_point_torch(ca, engine="wavefront", device=CPU))


def test_affine_scan_matches_associative_scan():
    """Same operator, same combine order: bit for bit, chain breaks (NEG)
    and every length parity included."""
    rng = np.random.default_rng(0)
    neg = np.float32(-1e18)

    def op(a, c):
        return jnp.maximum(a[0] + c[0], neg), jnp.maximum(a[1] + c[0], c[1])

    for n in (1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 31, 100):
        v = rng.uniform(0.5, 40.0, (3, n)).astype(np.float32)
        v[rng.random((3, n)) < 0.2] = neg
        h = rng.uniform(-5.0, 500.0, (3, n)).astype(np.float32)
        want = jax.lax.associative_scan(op, (jnp.asarray(v), jnp.asarray(h)),
                                        axis=1)
        got = port_mp.affine_scan(torch.from_numpy(v), torch.from_numpy(h))
        assert np.array_equal(got[1].numpy(), np.asarray(want[1])), n
        assert np.array_equal(got[0].numpy(), np.asarray(want[0])), n


def test_longest_path_condensed_matches_wavefront():
    """rtol 1e-5 at random work: an absorbed node's time is the anchor's
    plus a difference of prefix sums, not a sum formed step by step (a
    chain of ~2000 nodes in oma/gemm); θ = 1 (integers) stays exact."""
    ca = port_ex.compile_scenario(PORT_SCEN[0]).compiled_aidg
    works = np.maximum(ca.aidg.work[None] * np.random.default_rng(1).uniform(
        0.5, 2.0, (3, ca.aidg.n)), 1.0).astype(np.float32)
    cd = port_mp.longest_path_condensed(ca, work=works, device=CPU)
    wf = port_mp.longest_path_wavefront(ca, work=works, device=CPU)
    torch.testing.assert_close(cd, wf, rtol=1e-5, atol=0)
    one = port_mp.longest_path_condensed(ca, device=CPU)
    assert torch.equal(one, port_mp.longest_path_wavefront(ca, device=CPU))


# ---------------------------------------------------------------------------
# the packed matrix over the 10 operator cells
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_packed():
    return ref_ex.Explorer()                 # "packed" is the default


@pytest.fixture(scope="module")
def port_packed():
    ex = port_ex.Explorer(device=CPU)
    assert ex.engine == "packed"
    return ex


@pytest.fixture(scope="module")
def explored(ref_packed, port_packed, candidates):
    return ref_packed.explore(candidates), port_packed.explore(candidates)


def test_packed_theta_one_matches_golden_and_reference(ref_packed,
                                                       port_packed):
    assert port_packed.scenario_names == list(GOLDEN_THETA1_CYCLES)
    assert port_packed.baselines.tolist() == \
        list(GOLDEN_THETA1_CYCLES.values())
    assert np.array_equal(port_packed.baselines, ref_packed.baselines)
    assert np.array_equal(port_packed.energy_baselines,
                          ref_packed.energy_baselines) or np.allclose(
        port_packed.energy_baselines, ref_packed.energy_baselines,
        rtol=SAME_RTOL, atol=0)
    assert port_packed.packed_matrix().stats() == \
        ref_packed.packed_matrix().stats()
    assert port_packed.packed_matrix()._bucketize() == \
        ref_packed.packed_matrix()._bucketize()


def test_packed_explore_matches_reference(explored):
    ref, port = explored
    assert np.array_equal(port.cycles[0], ref.cycles[0])      # θ = 1 row
    _close(port.cycles, ref.cycles, PACKED_RTOL, "cycles")
    _close(port.energy, ref.energy, SAME_RTOL, "energy")
    _close(port.latency, ref.latency, PACKED_RTOL, "latency")
    assert np.array_equal(port.cost, ref.cost)
    assert np.array_equal(port.pareto, ref.pareto)


def test_packed_energy_matches_reference(ref_packed, port_packed,
                                         candidates):
    rc, re = ref_packed.evaluate_full(candidates)
    pc, pe = port_packed.evaluate_full(candidates)
    _close(pe, re, SAME_RTOL, "energy pJ")
    # the same closed form the per-cell engines apply to their cycles
    edyn, pstat = port_packed._energy_arrays()
    inv = 1.0 / np.concatenate([candidates.astype(np.float64),
                                np.ones((N_CAND, 1))], axis=1)
    _close(pe, inv @ edyn.T + pstat * pc.astype(np.float64), SAME_RTOL,
           "closed form")


def test_packed_matches_per_cell_wavefront(port_packed, candidates):
    """Packed (condensed, packed queues) against the per-cell wavefront
    engine of the same package: θ = 1 exact, random θ within the
    reference's own stated agreement of about 0.3% (queue tie-breaks)."""
    wf = port_ex.Explorer(engine="wavefront", device=CPU)
    a, b = port_packed.evaluate(candidates), wf.evaluate(candidates)
    assert np.array_equal(a[0], b[0])
    _close(a, b, 3e-3, "packed vs wavefront")


def test_packed_refine_incumbent_matches_reference(ref_packed, port_packed):
    # points=15 -> batches of N_CAND, the shape the reference compiled
    ref = ref_packed.refine(rounds=1, points=N_CAND - 1)
    port = port_packed.refine(rounds=1, points=N_CAND - 1)
    assert np.array_equal(port, ref)


def test_packed_chunked_and_training_table(ref_packed, port_packed,
                                           candidates):
    full = port_packed.evaluate(candidates)
    assert np.array_equal(port_packed.evaluate(candidates, chunk=5), full)
    pm = port_packed.packed_matrix()
    # N_CAND - 1 candidates + the θ = 1 row: the shape already compiled
    table = pm.export_training_table(candidates[1:])
    want = ref_packed.packed_matrix().export_training_table(candidates[1:])
    assert sorted(table) == sorted(want)
    assert np.array_equal(table["theta"], want["theta"])
    assert np.array_equal(table["cycles_base"], want["cycles_base"])
    _close(table["cycles"], want["cycles"], PACKED_RTOL, "table cycles")
    _close(table["energy"], want["energy"], SAME_RTOL, "table energy")


def test_pack_spec_and_dedup():
    cs = port_ex.compile_scenario(PORT_SCEN[2])
    proj = port_ex.DEFAULT_SPACE.projection(cs.problem)
    spec = cs.pack_spec(proj)
    assert isinstance(spec, port_dse.PackSpec)
    assert len(spec.problems) == 1 and spec.run_reps.tolist() == [1.0]
    assert spec.fits_within.tolist() == [0.0]
    pm = port_dse.PackedMatrix.build([spec, spec], port_ex.DEFAULT_SPACE.n,
                                     device=CPU)
    assert pm.n_cells == 2 and pm.n_rows == 1
    out = pm.evaluate(np.ones((1, port_ex.DEFAULT_SPACE.n), np.float32))
    assert out.shape == (1, 2) and out[0, 0] == out[0, 1] == 2954.0


def test_unported_packed_paths_raise(port_packed):
    pm = port_packed.packed_matrix()
    for call in (lambda: pm.grad_fn(port_packed.baselines),
                 lambda: pm.grad3_fn(port_packed.baselines,
                                     port_packed.energy_baselines),
                 lambda: port_packed.refine(method="grad")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


# ---------------------------------------------------------------------------
# olmo-1b's network cells
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_net():
    return ref_ex.Explorer(scenarios=[], networks="olmo_1b")


@pytest.fixture(scope="module")
def port_net():
    return port_ex.Explorer(scenarios=[], networks="olmo_1b", device=CPU)


def test_network_cells_theta_one(ref_net, port_net):
    assert port_net.scenario_names == ref_net.scenario_names
    assert len(port_net.scenario_names) == 6
    for name, got, ref in zip(port_net.scenario_names, port_net.baselines,
                              ref_net.baselines):
        assert got == pytest.approx(GOLDEN_E2E_THETA1[name], rel=1e-4), name
        _close(got, ref, SAME_RTOL, name)


def test_network_cells_match_reference(ref_net, port_net, candidates):
    ref, port = ref_net.explore(candidates), port_net.explore(candidates)
    _close(port.cycles, ref.cycles, PACKED_RTOL, "network cycles")
    _close(port.energy, ref.energy, SAME_RTOL, "network energy")
    assert np.array_equal(port.cost, ref.cost)
    assert np.array_equal(port.pareto, ref.pareto)
    # the per-cell path of the same cells (the stacked network sweep)
    wf = port_ex.Explorer(scenarios=[], networks="olmo_1b",
                          engine="wavefront", device=CPU)
    got = wf.evaluate(candidates[:4])
    assert np.array_equal(got[0], port.cycles[0])
    _close(got, port.cycles[:4], 3e-3, "packed vs stacked wavefront")


@pytest.mark.parametrize("arch", ["tpu_v5e", "gamma"])
def test_pipelined_bounded_by_sequential_and_layers(arch):
    seq = NetworkScenario(arch, "olmo_1b").compile()
    pip = NetworkScenario(arch, "olmo_1b", mode="pipelined").compile()
    space = port_ex.DEFAULT_SPACE
    for kt in (np.ones((1, 5), np.float32),
               np.asarray([[0.5, 2.0, 0.8, 1.5, 1.0]], np.float32)):
        s = float(seq.evaluate(space, kt, device=CPU)[0])
        p = float(pip.evaluate(space, kt, device=CPU)[0])
        assert p <= s * (1 + 1e-6), (arch, p, s)
        for prob in pip.stack.problems:
            to, ts = space.theta_for(prob, kt)
            assert p >= float(port_dse.sweep(prob, to, ts, device=CPU)[0]) \
                - 1e-3
        # the packed matrix composes the pipelined cell as the stack does
        packed = port_ex.Explorer(scenarios=[NetworkScenario(
            arch, "olmo_1b", mode="pipelined")], device=CPU).evaluate(kt)
        _close(packed[0, 0], p, 5e-3, "packed vs stack, pipelined")
    if arch == "tpu_v5e":
        one = np.ones((1, 5), np.float32)
        assert float(pip.evaluate(space, one, device=CPU)[0]) < float(
            seq.evaluate(space, one, device=CPU)[0]), "no overlap credited"
    with pytest.raises(ValueError, match="mode"):
        port_dse.compiled_network_sweep(seq.stack, mode="nope", device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        seq.grad_fn(seq.projection(space))


def test_repeated_layers_compile_once_and_share_across_networks():
    """The port's scenario cache, as the reference's: olmo-1b on Γ̈ lowers
    81 layer instances onto 2 tile programs; a second compile and another
    network on the same architecture only hit the cache."""
    port_ex.clear_scenario_cache()
    cn = NetworkScenario("gamma", "olmo_1b").compile()
    s1 = port_ex.scenario_cache_stats()
    assert cn.n_layers == 2 and len(cn.layer_graph.instances) == 81
    assert s1 == {"hits": 0, "misses": 2}
    NetworkScenario("gamma", "olmo_1b").compile()
    NetworkScenario("gamma", "olmoe_1b_7b").compile()
    assert port_ex.scenario_cache_stats() == {"hits": 4, "misses": 2}
