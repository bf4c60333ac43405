"""The port's DSE query service (``repro_torch.serve``) and its sharded
packed evaluator, held against the JAX reference's ``repro.serve`` on the
CPU, on the 4-cell corner of the default matrix that ``tests/test_serve.py``
uses (pool 8, seed 1).

Contracts:

* Per query shape of the mixed stream, the port's answer equals the
  reference service's: resolved cells, ``best_arch``, ``tier`` and every
  ranked design's θ exactly; latency, energy, cost and per-cell cycles
  within rtol 2e-6 (the packed contract: the reference's CPU ``cumsum``
  is a tree of adds, the port's sequential).
* The served answer equals the port's own direct Explorer sweep of the
  same block (``direct_answer``), threaded equals sequential replay, and
  answers do not depend on batch composition — all exactly.
* The sharded evaluator is bit for bit the unsharded one: the split over
  1, 2 and 3 CPU slices at B = 8 and 13 (remainders padded), with and
  without ``chunk``; ``evaluate(sharded=True)`` on the one device; a
  sharded service.
* ``energy_bottleneck_report`` returns the reference's rows on all 31
  cells of the default operator + network matrix.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import jax  # noqa: F401  (both frameworks in one process; JAX on the CPU)
import numpy as np
import pytest
import torch

from repro.core.aidg import explorer as ref_ex
from repro.core.aidg.energy import energy_bottleneck_report as ref_report
from repro.core.network import default_network_scenarios as ref_net_cells
from repro.serve import DSEService as RefService
from repro.serve import Query as RefQuery
from repro_torch.core.aidg import explorer as port_ex
from repro_torch.core.aidg.energy import \
    energy_bottleneck_report as port_report
from repro_torch.core.network import \
    default_network_scenarios as port_net_cells
from repro_torch.serve import Answer, Design, DSEService, Query
from repro_torch.serve import batcher as batcher_mod

CPU = torch.device("cpu")
PACKED_RTOL = 2e-6
# a 4-cell corner of the default matrix: two archs sharing a workload
# (subset queries bite), one non-gemm workload, one multi-workload arch
SUBSET = {("oma", "gemm"), ("systolic", "gemm"), ("gamma", "attention"),
          ("tpu_v5e", "gemm")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on
    a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ex():
    scs = [s for s in port_ex.default_scenarios()
           if (s.arch, s.workload) in SUBSET]
    assert len(scs) == len(SUBSET)
    return port_ex.Explorer(scenarios=scs, device="cpu")


@pytest.fixture(scope="module")
def ref_explorer():
    return ref_ex.Explorer(scenarios=[s for s in ref_ex.default_scenarios()
                                      if (s.arch, s.workload) in SUBSET])


@pytest.fixture()
def svc(ex):
    s = DSEService(ex, pool=8, seed=1, max_batch=4, window_s=0.01)
    yield s
    s.close()


BASE = [dict(workload="gemm"), dict(workload="gemm", top_k=2),
        dict(workload="attention"),
        dict(workload="gemm", archs=["oma", "systolic"]),
        dict(archs=["gamma"]),
        dict(workload="gemm", overrides={"matrix": 2.0})]


def mixed_stream(n=12, make=Query.make):
    """A deterministic mixed client stream over the SUBSET matrix."""
    return [make(**BASE[i % len(BASE)]) for i in range(n)]


def direct_answer(service, q):
    """The oracle: re-derive the answer from a DIRECT Explorer sweep of
    the same candidate block — no service, no batching, no cache."""
    ex = service.explorer
    cand = service.pool.copy()
    for name, val in q.overrides:
        cand[:, ex.space.names.index(name)] = val
    cycles, energy_pj = ex.evaluate_full(cand)
    cols = np.asarray(port_ex.resolve_cells(ex.compiled, workload=q.workload,
                                            archs=q.archs))
    names = tuple(ex.compiled[i].name for i in cols)
    rel = cycles[:, cols] / ex.baselines[None, cols]
    latency = rel.mean(axis=1)
    energy = (energy_pj[:, cols]
              / ex.energy_baselines[None, cols]).mean(axis=1)
    cost = ex.cost_proxy(cand)
    top = port_ex.pareto_front(np.stack([latency, energy, cost],
                                        axis=1))[: q.top_k]
    designs = tuple(
        Design(theta=tuple(float(v) for v in cand[i]),
               latency=float(latency[i]), energy=float(energy[i]),
               cost=float(cost[i]),
               cycles=tuple(float(c) for c in cycles[i, cols]))
        for i in top)
    lead = int(top[0]) if len(top) else int(np.argmin(latency))
    best_arch = ex.compiled[int(cols[int(np.argmin(rel[lead]))])].arch
    return Answer(query=q, cells=names, designs=designs,
                  best_arch=best_arch)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b))) if a.size else 0.0


def assert_matches_reference(port, ref):
    assert port.query.key == ref.query.key
    assert (port.cells, port.best_arch, port.tier) == \
        (ref.cells, ref.best_arch, ref.tier)
    assert port.err_bound == ref.err_bound
    assert len(port.designs) == len(ref.designs)
    for p, r in zip(port.designs, ref.designs):
        assert p.theta == r.theta
        for f in ("latency", "energy", "cost", "cycles"):
            assert _rel(getattr(p, f), getattr(r, f)) <= PACKED_RTOL, f


# -- held against the reference service -------------------------------------

def test_answers_match_reference_service(ex, ref_explorer):
    port_qs = mixed_stream(len(BASE))
    ref_qs = mixed_stream(len(BASE), make=RefQuery.make)
    with DSEService(ex, pool=8, seed=1) as port, \
            RefService(ref_explorer, pool=8, seed=1) as ref:
        assert np.array_equal(port.pool, ref.pool)
        got, want = port.query_many(port_qs), ref.query_many(ref_qs)
        assert port.stats()["device_dispatches"] == \
            ref.stats()["device_dispatches"] == 1
    for p, r in zip(got, want):
        assert_matches_reference(p, r)


def test_served_equals_direct_sweep(svc):
    for q in {q.key: q for q in mixed_stream()}.values():
        assert svc.query(q) == direct_answer(svc, q)


# -- determinism under concurrency ------------------------------------------

def test_threaded_equals_sequential_replay(ex):
    stream = mixed_stream(18)
    svc = DSEService(ex, pool=8, seed=1, max_batch=3, window_s=0.002)
    try:
        with ThreadPoolExecutor(max_workers=6) as tp:
            threaded = list(tp.map(svc.query, stream))
    finally:
        svc.close()
    with DSEService(ex, pool=8, seed=1, max_batch=3) as ref:
        replay = ref.query_many(stream)
    assert threaded == replay


def test_answers_invariant_to_batch_composition(ex):
    """The same query answered through windows of 1, through a full
    window, and coalesced with strangers — all equal."""
    q = Query.make(workload="gemm", top_k=3)
    got = []
    for max_batch, stream in [(1, [q]), (4, [q] * 4),
                              (4, mixed_stream(7) + [q])]:
        with DSEService(ex, pool=8, seed=1, max_batch=max_batch) as s:
            got.append(s.query_many(stream)[-1])
    assert got[0] == got[1] == got[2]


# -- micro-batch window boundaries and cache counters ------------------------

@pytest.mark.parametrize("m,expected", [(1, [1]), (4, [4]), (6, [4, 2])])
def test_window_boundaries(ex, m, expected):
    with DSEService(ex, pool=8, seed=1, max_batch=4,
                    window_s=0.005) as svc:
        with svc.batcher.hold():
            futs = [svc.submit(workload="gemm", top_k=i + 1)
                    for i in range(m)]
        answers = [f.result(timeout=60.0) for f in futs]
        assert [len(w) for w in svc.window_log] == expected
        assert [len(b) for b in svc.batcher.dispatch_log] == expected
        assert [a.query.top_k for a in answers] == list(range(1, m + 1))
        assert all(len(a.designs) <= i + 1 for i, a in enumerate(answers))


def test_cache_counter_transitions(svc):
    q = Query.make(workload="attention")
    a1 = svc.query(q)
    assert svc.cache_stats == {"hits": 0, "misses": 1, "coalesced": 0}
    assert a1.cached is False
    a2 = svc.query(q)
    assert svc.cache_stats == {"hits": 1, "misses": 1, "coalesced": 0}
    assert a2.cached is True and a1 == a2
    with svc.batcher.hold():
        f1 = svc.submit(workload="gemm")
        f2 = svc.submit(workload="gemm")
    assert f1.result(60.0) == f2.result(60.0)
    assert svc.cache_stats == {"hits": 1, "misses": 2, "coalesced": 1}
    assert svc.evaluated_log[-1] == [Query.make(workload="gemm").key]
    st = svc.stats()
    assert st["hit_ratio"] == pytest.approx(2 / 4)
    assert st["device_dispatches"] == 2 and st["windows"] == 3
    # cached answers never reach the packed matrix again
    before = svc.dispatched_candidates
    assert before == 2 * svc.pool.shape[0]
    assert svc.query(q).cached and svc.dispatched_candidates == before


def test_bad_queries_fail_fast(svc):
    with pytest.raises(KeyError, match="workload"):
        svc.query(workload="nope")
    with pytest.raises(KeyError, match="arch"):
        svc.query(archs=["nope"])
    with pytest.raises(KeyError, match="knob"):
        svc.query(workload="gemm", overrides={"bogus": 1.0})
    with pytest.raises(ValueError, match="outside"):
        svc.query(workload="gemm", overrides={"matrix": 1e9})
    with pytest.raises(ValueError, match="top_k"):
        Query.make(top_k=0)
    assert svc.query(workload="gemm").best_arch in {"oma", "systolic",
                                                    "gamma", "tpu_v5e"}


# -- shutdown: no leaked worker threads ---------------------------------------

def test_close_is_idempotent_and_flushes_a_hold(ex):
    svc = DSEService(ex, pool=8, seed=1)
    svc.query(workload="gemm")
    svc.close()
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(workload="gemm")
    svc = DSEService(ex, pool=8, seed=1)
    with svc.batcher.hold():
        fut = svc.submit(workload="gemm")
        svc.batcher.close(timeout=60.0)
    assert fut.result(timeout=60.0).best_arch
    assert not svc.batcher._worker.is_alive()


def test_unclosed_service_leaves_no_joinable_threads(ex):
    svc = DSEService(ex, pool=8, seed=1)
    svc.query(workload="gemm")
    assert not any(t.name == "microbatcher" and not t.daemon
                   for t in threading.enumerate())
    assert svc.batcher._worker.daemon
    assert svc.batcher in batcher_mod._LIVE
    batcher_mod._close_all()
    svc.batcher._worker.join(timeout=30.0)
    assert not svc.batcher._worker.is_alive()
    assert svc.batcher not in batcher_mod._LIVE


def test_service_builds_its_explorer_on_the_given_device():
    scs = [s for s in port_ex.default_scenarios()
           if (s.arch, s.workload) == ("oma", "gemm")]
    with DSEService(scenarios=scs, pool=4, device="cpu") as svc:
        assert svc.explorer.device == CPU
        assert svc.query(workload="gemm").cells == ("oma/gemm",)


# -- the sharded evaluator ----------------------------------------------------

@pytest.mark.parametrize("B", [8, 13])
def test_split_over_cpu_slices_is_bit_for_bit(ex, B):
    pm = ex.packed_matrix()
    cand = port_ex.random_candidates(ex.space, B, seed=3)
    cycles, energy = pm.evaluate_full(cand)
    for D in (1, 2, 3):
        for chunk in (None, 3, 5):
            c, e = pm._evaluate_split(cand, chunk, [CPU] * D)
            assert c.shape == e.shape == (B, pm.n_cells)
            assert np.array_equal(c, cycles), (D, chunk)
            assert np.array_equal(e, energy), (D, chunk)
    # the sharded function itself takes a device multiple only
    fn = pm.sharded_fn()
    kt = torch.as_tensor(cand[:6])
    assert torch.equal(fn(kt)[0], torch.as_tensor(cycles[:6]))
    with pytest.raises(ValueError, match="multiple"):
        pm._split_matrix(kt[:5], [CPU] * 2)


def test_sharded_evaluate_on_one_device(ex):
    pm = ex.packed_matrix()
    theta1 = np.ones((1, ex.space.n), np.float32)
    assert np.array_equal(ex.evaluate(theta1, sharded=True),
                          ex.evaluate(theta1))
    cand = port_ex.random_candidates(ex.space, 8, seed=3)
    assert np.array_equal(pm.evaluate(cand, sharded=True), pm.evaluate(cand))
    assert np.array_equal(ex.evaluate(cand, sharded=True, chunk=3),
                          ex.evaluate(cand))
    c, e = ex.evaluate_full(cand, sharded=True, n_devices=1)
    c0, e0 = ex.evaluate_full(cand)
    assert np.array_equal(c, c0) and np.array_equal(e, e0)


def test_sharded_service_matches_unsharded(ex):
    with DSEService(ex, pool=8, seed=1) as plain, \
            DSEService(ex, pool=8, seed=1, sharded=True) as shard:
        for q in {q.key: q for q in mixed_stream()}.values():
            assert plain.query(q) == shard.query(q)
        assert shard.stats()["sharded"] is True


def test_sharded_device_count_validation(ex):
    pm = ex.packed_matrix()
    assert pm.n_shards(None) == 1          # one CPU device
    assert pm.n_shards(1) == 1
    for bad in (0, 2):
        with pytest.raises(ValueError, match="n_devices"):
            pm.n_shards(bad)
    with pytest.raises(ValueError, match="n_devices"):
        ex.evaluate(np.ones((1, ex.space.n)), sharded=True, n_devices=2)
    blocked = port_ex.Explorer(port_ex.default_scenarios()[:1],
                               engine="blocked", device="cpu")
    with pytest.raises(ValueError, match="packed"):
        blocked.evaluate(np.ones((1, ex.space.n)), sharded=True)


# -- the A4 tail: per-memory-level energy bottlenecks -------------------------

def test_energy_bottleneck_report_matches_reference_on_31_cells():
    ref_cells = ([ref_ex.compile_scenario(s)
                  for s in ref_ex.default_scenarios()]
                 + [s.compile() for s in ref_net_cells()])
    port_cells = ([port_ex.compile_scenario(s)
                   for s in port_ex.default_scenarios()]
                  + [s.compile() for s in port_net_cells()])
    assert len(ref_cells) == len(port_cells) == 31
    for r, p in zip(ref_cells, port_cells):
        assert r.name == p.name
        assert port_report(p) == ref_report(r), r.name
