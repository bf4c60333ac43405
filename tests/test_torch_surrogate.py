"""The port's surrogate tier (``repro_torch.surrogate``) and AdamW
(``repro_torch.optim``), held against the JAX reference on the CPU.

Contracts:

* The stacked forward pass (``predict_rel_cells``, ``predict_rel``) on
  the same parameters: rtol 1e-5 (float32 einsum and logsumexp orders).
* AdamW over 20 steps on a random dict, clipping active, cosine schedule,
  decoupled decay: rtol 1e-5.
* ``_fit`` started from the reference's initial parameters (its
  ``init_stacked_params(PRNGKey(seed), ...)``, carried across by
  ``convert.surrogate_params_from_numpy``) against the reference's
  ``_fit``, 250 steps on the 2-cell table: predictions within rtol 1e-5
  (measured worst 1.1e-6 on the CPU), losses within 1e-5.
* Bundles cross-load both ways, and ``predict_full`` is bit for bit equal.
* A bundle the port trains is deterministic for one seed, anchored at 1.0
  at θ = 1, monotone, and routes and falls back as
  ``tests/test_surrogate.py`` checks the reference's.
"""

from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aidg import explorer as ref_ex
from repro.optim import adamw as ref_adamw
from repro.surrogate import SurrogateBundle as RefBundle
from repro.surrogate import model as ref_model
from repro.surrogate import train as ref_train
from repro_torch.convert import surrogate_params_from_numpy
from repro_torch.core.aidg import explorer as port_ex
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.serve import DSEService, Query
from repro_torch.surrogate import (SurrogateBundle, SurrogateConfig,
                                   evaluate_surrogate, init_cell_params,
                                   init_stacked_params, predict_rel,
                                   predict_rel_cells, train_surrogate)
from repro_torch.surrogate import train as port_train

RTOL = 1e-5
# reduced budget, as the reference's fault tests: mechanics, not accuracy
CFG = SurrogateConfig(n_samples=48, steps=250)
REF_CFG = ref_train.SurrogateConfig(n_samples=48, steps=250)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ex2():
    return port_ex.Explorer(scenarios=port_ex.default_scenarios()[:2],
                            device="cpu")


@pytest.fixture(scope="module")
def ref_ex2():
    return ref_ex.Explorer(scenarios=ref_ex.default_scenarios()[:2])


@pytest.fixture(scope="module")
def bundle(ex2):
    return train_surrogate(ex2, CFG)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _ref_tree(n_cells, n_knobs=5, seed=0):
    return jax.tree.map(np.asarray, ref_model.init_stacked_params(
        jax.random.PRNGKey(seed), n_cells, n_knobs))


def _knobs(n, k=5, seed=7):
    return np.exp(np.random.default_rng(seed).uniform(
        np.log(0.25), np.log(4.0), (n, k))).astype(np.float32)


# -- the forward pass ---------------------------------------------------------

def test_predict_rel_matches_reference():
    tree = _ref_tree(3)
    params = surrogate_params_from_numpy(tree, "cpu")
    kt = _knobs(11)
    rl, re_ = ref_model.predict_rel_cells(tree, jnp.asarray(kt))
    pl, pe = predict_rel_cells(params, torch.from_numpy(kt))
    assert pl.shape == pe.shape == (3, 11)
    assert _rel(pl.numpy(), rl) <= RTOL and _rel(pe.numpy(), re_) <= RTOL
    # one cell alone equals its row of the stacked pass
    one = {k: v[1] for k, v in params.items()}
    l1, e1 = predict_rel(one, torch.from_numpy(kt))
    rl1, re1 = ref_model.predict_rel({k: v[1] for k, v in tree.items()},
                                     jnp.asarray(kt))
    assert _rel(l1.numpy(), rl1) <= RTOL and _rel(e1.numpy(), re1) <= RTOL
    assert torch.equal(l1, pl[1]) and torch.equal(e1, pe[1])


def test_init_is_seeded_and_anchored_near_one():
    gen = lambda: torch.Generator().manual_seed(3)           # noqa: E731
    a, b = init_stacked_params(gen(), 4, 5), init_stacked_params(gen(), 4, 5)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        k: v.shape for k, v in _ref_tree(4).items()}
    lat, _ = predict_rel_cells(a, torch.ones((1, 5)))
    assert torch.all((lat > 0.5) & (lat < 2.0))
    cell = init_cell_params(gen(), 5)
    assert torch.equal(cell["w_raw"], init_stacked_params(gen(), 1, 5)
                       ["w_raw"][0])


def test_surrogate_params_from_numpy_checks_leaves():
    tree = _ref_tree(2)
    out = surrogate_params_from_numpy(tree, "cpu")
    for k, v in tree.items():
        assert out[k].dtype == torch.float32
        assert np.array_equal(out[k].numpy(), v)
    with pytest.raises(KeyError, match="tau_raw"):
        surrogate_params_from_numpy(
            {k: v for k, v in tree.items() if k != "tau_raw"}, "cpu")
    with pytest.raises(ValueError, match="extra"):
        surrogate_params_from_numpy(dict(tree, extra=tree["a"]), "cpu")
    with pytest.raises(ValueError, match="float64"):
        surrogate_params_from_numpy(
            dict(tree, a=tree["a"].astype(np.float64)), "cpu")
    with pytest.raises(ValueError, match="axis S"):
        surrogate_params_from_numpy(dict(tree, beta_raw=np.zeros(
            3, np.float32)), "cpu")


# -- AdamW ----

def test_adamw_matches_reference_over_20_steps():
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,), "s": ()}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: (3.0 * rng.normal(size=s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(20)]
    total = 20
    ref_cfg = ref_adamw.AdamWConfig(
        lr=0.05, weight_decay=0.1, clip_norm=1.0,
        schedule=lambda step: 0.5 * (1.0 + jnp.cos(jnp.pi * jnp.minimum(
            step.astype(jnp.float32) / total, 1.0))))
    cfg = AdamWConfig(
        lr=0.05, weight_decay=0.1, clip_norm=1.0,
        schedule=lambda step: 0.5 * (1.0 + np.cos(np.pi * min(
            step / total, 1.0))))
    rp = {k: jnp.asarray(v) for k, v in init.items()}
    rs = ref_adamw.adamw_init(rp)
    pp = {k: torch.tensor(v) for k, v in init.items()}
    ps = adamw_init(pp)
    for g in grads:
        rp, rs, rm = ref_adamw.adamw_update(
            ref_cfg, rp, {k: jnp.asarray(v) for k, v in g.items()}, rs)
        out, ps, pm = adamw_update(
            cfg, pp, {k: torch.tensor(v) for k, v in g.items()}, ps)
        assert out is pp                      # updated in place
        assert float(rm["grad_norm"]) > 1.0   # clipping is active
        assert _rel(pm["grad_norm"].numpy(), rm["grad_norm"]) <= RTOL
        assert _rel(pm["lr"], rm["lr"]) <= RTOL
    assert ps["step"] == int(rs["step"]) == 20
    for k in init:
        assert _rel(pp[k].numpy(), rp[k]) <= RTOL, k
        assert _rel(ps["m"][k].numpy(), rs["m"][k]) <= RTOL, k
        assert _rel(ps["v"][k].numpy(), rs["v"][k]) <= RTOL, k
    with pytest.raises(KeyError, match="match"):
        adamw_update(cfg, pp, {"w": torch.zeros(6, 5)}, ps)


# -- the fit ----

def test_fit_from_reference_init_matches_reference_fit(ref_ex2):
    kt = ref_ex.random_candidates(ref_ex2.space, 48, seed=0)
    table = ref_ex2.packed_matrix().export_training_table(kt, chunk=64)
    y_lat = table["cycles"] / table["cycles_base"][None, :]
    y_en = table["energy"] / table["energy_base"][None, :]
    ref_params, ref_losses = ref_train._fit(jax.random.PRNGKey(0), kt,
                                            y_lat, y_en, REF_CFG)
    init = surrogate_params_from_numpy(_ref_tree(2), "cpu")
    params, losses = port_train._fit(init, kt, y_lat, y_en, CFG)
    assert losses.shape == (250,) and losses[-1] < 0.1 * losses[0]
    assert np.allclose(losses, np.asarray(ref_losses), rtol=RTOL, atol=0)
    rl, re_ = ref_model.predict_rel_cells(
        jax.tree.map(jnp.asarray, ref_params), jnp.asarray(kt))
    pl, pe = predict_rel_cells({k: torch.from_numpy(v)
                                for k, v in params.items()},
                               torch.from_numpy(kt))
    assert _rel(pl.numpy(), rl) <= RTOL and _rel(pe.numpy(), re_) <= RTOL


# -- bundles ----

def test_bundles_cross_load_both_ways(tmp_path, ex2, ref_ex2, bundle):
    ref_bundle = ref_train.train_surrogate(ref_ex2, REF_CFG)
    kt = _knobs(9)
    # the reference's bundle, loaded by the port
    ref_bundle.save(tmp_path / "ref.npz")
    mine = SurrogateBundle.load(tmp_path / "ref.npz")
    assert mine.cell_names == ref_bundle.cell_names
    assert mine.meta == ref_bundle.meta
    assert np.array_equal(mine.err_bound, ref_bundle.err_bound)
    for a, b in zip(mine.predict_full(kt), ref_bundle.predict_full(kt)):
        assert np.array_equal(a, b)
    # the port's bundle, loaded by the reference
    bundle.save(tmp_path / "port.npz")
    theirs = RefBundle.load(tmp_path / "port.npz")
    assert theirs.knob_names == bundle.knob_names
    assert theirs.meta == bundle.meta
    for a, b in zip(theirs.predict_full(kt), bundle.predict_full(kt)):
        assert np.array_equal(a, b)
    # the port's own round trip
    again = SurrogateBundle.load(tmp_path / "port.npz")
    for a, b in zip(again.predict_full(kt), bundle.predict_full(kt)):
        assert np.array_equal(a, b)
    # a reference-trained bundle serves in the port, routed as there
    with DSEService(ex2, pool=8, seed=1, surrogate=mine,
                    surrogate_max_err=10.0) as svc:
        assert svc.query(workload="gemm").tier == "surrogate"


def test_training_is_deterministic(ex2, bundle):
    again = train_surrogate(ex2, CFG)
    for k in bundle.params:
        assert bundle.params[k].dtype == np.float32
        assert np.array_equal(bundle.params[k], again.params[k]), k
    assert np.array_equal(bundle.err_bound, again.err_bound)
    assert bundle.meta == again.meta
    assert bundle.meta["n_train"] + bundle.meta["n_holdout"] == 48
    assert bundle.cell_names == tuple(cs.name for cs in ex2.compiled)
    assert np.all(bundle.err_bound > 0.0)


def test_predict_anchored_at_theta_one(bundle):
    lat, en = bundle.predict_rel(np.ones((1, bundle.n_knobs), np.float32))
    assert lat.shape == en.shape == (1, 2)
    assert np.all(np.abs(lat[0] - 1.0) <= bundle.err_bound)
    assert np.all(np.abs(en[0] - 1.0) <= bundle.err_bound)


def test_latency_monotone_on_grid(bundle):
    base = np.full((1, bundle.n_knobs), 0.7, np.float32)
    lat0, _ = bundle.predict_rel(base)
    for k in range(bundle.n_knobs):
        up = base.copy()
        up[0, k] = 2.5
        lat1, _ = bundle.predict_rel(up)
        assert np.all(lat1 >= lat0 - 1e-6), k


def test_confident_api_and_report(ex2, bundle):
    assert bundle.confident(max_err=10.0)
    assert not bundle.confident(max_err=0.0)
    assert bundle.confident(cols=[0], max_err=float(bundle.err_bound[0]))
    assert not bundle.confident(cols=[], max_err=10.0)
    rep = evaluate_surrogate(bundle, ex2, n=16, seed=5)
    assert rep["err_latency"].shape == rep["err_energy"].shape == (16, 2)
    assert 0.0 <= rep["median_latency_err"] < 1.0
    assert rep["bound_coverage"].shape == (2,)


# -- service integration: the staged router -----------------------------------

def test_service_routes_to_surrogate_tier(ex2, bundle):
    with DSEService(ex2, pool=8, seed=1, surrogate=bundle,
                    surrogate_max_err=10.0) as svc:
        a = svc.query(workload="gemm")
        assert a.tier == "surrogate" and 0.0 < a.err_bound <= 10.0
        assert a.cells == ("oma/gemm", "systolic/gemm")
        assert svc.dispatched_candidates == 0 and svc.evaluated_log == []
        st = svc.stats()
        assert st["surrogate_armed"] is True
        assert st["tiers"] == {"cache": 0, "surrogate": 1, "packed": 0,
                               "surrogate-degraded": 0, "failed": 0}
        assert st["fallback_rate"] == 0.0
        assert st["tier_us_per_query"]["surrogate"] > 0.0
        b = svc.query(workload="gemm")
        assert b.cached and b.tier == "surrogate" and b == a


def test_service_falls_back_when_bound_exceeded(ex2, bundle):
    with DSEService(ex2, pool=8, seed=1, surrogate=bundle,
                    surrogate_max_err=0.0) as svc:
        a = svc.query(workload="gemm")
        assert a.tier == "packed" and a.err_bound == 0.0
        assert svc.dispatched_candidates == 8
        assert svc.stats()["fallback_rate"] == 1.0
    with DSEService(ex2, pool=8, seed=1) as svc:
        assert svc.query(workload="gemm").tier == "packed"
        assert svc.stats()["surrogate_armed"] is False


def test_surrogate_answers_match_packed_structure(ex2, bundle):
    q = Query.make(workload="gemm", top_k=3)
    with DSEService(ex2, pool=8, seed=1, surrogate=bundle,
                    surrogate_max_err=10.0) as fast:
        a_sur = fast.query(q)
    with DSEService(ex2, pool=8, seed=1) as slow:
        a_pkd = slow.query(q)
    assert a_sur.cells == a_pkd.cells
    pool = {tuple(np.float32(v) for v in row)
            for row in port_ex.random_candidates(ex2.space, 8, seed=1)}
    assert all(tuple(np.float32(v) for v in d.theta) in pool
               for d in a_sur.designs)
    tol = 5.0 * float(bundle.err_bound.max())
    assert a_sur.best.latency == pytest.approx(a_pkd.best.latency,
                                               rel=max(tol, 0.05))


def test_threaded_equals_replay_with_surrogate(ex2, bundle):
    stream = [Query.make(workload="gemm"),
              Query.make(workload="gemm", archs=["oma"]),
              Query.make(workload="gemm", top_k=2),
              Query.make(workload="gemm", overrides={"matrix": 2.0})] * 3
    svc = DSEService(ex2, pool=8, seed=1, surrogate=bundle,
                     surrogate_max_err=10.0, max_batch=3, window_s=0.002)
    try:
        with ThreadPoolExecutor(max_workers=4) as tp:
            threaded = list(tp.map(svc.query, stream))
    finally:
        svc.close()
    with DSEService(ex2, pool=8, seed=1, surrogate=bundle,
                    surrogate_max_err=10.0, max_batch=3) as ref:
        replay = ref.query_many(stream)
    assert threaded == replay
    assert all(a.tier == "surrogate" for a in replay if not a.cached)


def test_service_trains_its_own_bundle_and_rejects_mismatches(ex2, bundle):
    with DSEService(ex2, pool=8, seed=1, surrogate=True) as svc:
        sur = svc.surrogate
        assert sur.cell_names == bundle.cell_names
        assert sur.meta["config"] == asdict(SurrogateConfig())
        assert svc.query(workload="gemm").tier in ("surrogate", "packed")
    ex3 = port_ex.Explorer(scenarios=port_ex.default_scenarios()[:3],
                           device="cpu")
    with pytest.raises(ValueError, match="cells"):
        DSEService(ex3, pool=8, surrogate=bundle)
