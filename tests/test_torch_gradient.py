"""The port's τ-soft max-plus family and gradient search, held against the
JAX reference on the CPU, on the same inputs (made with numpy from a
fixed seed): ``maxplus.{softmaximum, softmax_reduce, slot_queue_soft,
longest_path_soft, fixed_point_soft}``, ``dse.{grad_sweep,
grad_network_sweep}``, ``PackedMatrix.grad_fn`` / ``grad3_fn``,
``CompiledNetwork.grad_fn``, ``GradientExplorer`` and
``Explorer.refine(method="grad")``.

Contracts (each tolerance is stated where it is asserted, with why):

* Values: the same float32 operations in both packages; the port's
  ``cumsum`` is sequential where the reference's CPU scan is a tree, and
  XLA fuses some multiply-adds, so values agree to a few float32 ulps of
  the largest time — rtol 1e-5 on makespans (1e-4 on oma/gemm's longest
  chains).
* Gradients of the per-cell soft family (``grad_sweep``, the primitives):
  both packages differentiate exact softmax weights, so they agree to
  float32 rounding (atol 1e-4 of a cell's baseline).
* Gradients of the packed soft family: the port's lie within ``FD_ATOL``
  (2e-3) of central differences of the REFERENCE's values, at every τ, on
  the 10-cell matrix and on olmo-1b's network cells; at τ = 0.5 they also
  lie within 1e-3 of the reference's own gradient.  At small τ the
  reference's packed gradient departs from those differences (its
  ``logaddexp`` JVP rounds the softmax weights; ROADMAP §C, C8) — pinned
  by ``test_reference_packed_gradient_departs_from_its_differences``.
* The gradient search: histories, final thetas and scores within the
  tolerances stated at ``test_refine_matches_reference`` (Adam carries
  C8's gradient difference forward); the end-to-end gate of the
  reference's ``tests/test_gradient_dse.py`` holds for the port itself.

Sizes: the 10 default operator cells at full size and olmo-1b's six
network cells; the 31-cell matrix runs on the card in ``chip_smoke.py``
phase 12.  Knobs for finite differences are seeded from ``zlib.crc32`` of
the cell's name (stable across processes; the reference's own test
salts its seed with ``hash``, C7).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aidg import dse as ref_dse
from repro.core.aidg import explorer as ref_ex
from repro.core.aidg import maxplus as ref_mp
from repro.core.aidg.gradient import GradientExplorer as RefGE
from repro_torch.core.aidg import dse as port_dse
from repro_torch.core.aidg import explorer as port_ex
from repro_torch.core.aidg import maxplus as port_mp
from repro_torch.core.aidg.gradient import GradientExplorer as PortGE
from repro_torch.core.network import NetworkScenario

CPU = "cpu"
TAUS = (0.5, 0.05, 0.01)
REF_SCEN = ref_ex.default_scenarios()
IDS = [s.name for s in REF_SCEN]
K = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes on a few cores; one
    intra-op thread keeps this file's CPU tensors from oversubscribing
    them (and makes the CPU's sums one fixed order)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_packed():
    return ref_ex.Explorer()


@pytest.fixture(scope="module")
def port_packed():
    return port_ex.Explorer(device=CPU)


@pytest.fixture(scope="module")
def refined(ref_packed, port_packed):
    """One default gradient refine (2 starts, 22 steps) in each package."""
    return RefGE(ref_packed).refine(), PortGE(port_packed).refine()


def _knobs(name: str, n: int = 2) -> np.ndarray:
    """(n, K) knob rows for a cell: θ = 1 (ties everywhere), then
    log-uniform in [e^-0.5, e^0.5] from a stable seed."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    k = np.exp(rng.uniform(-0.5, 0.5, (n, K))).astype(np.float32)
    k[0] = 1.0
    return k


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(out - ref) / np.abs(ref)))


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x,
                      np.float64)


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tau", TAUS)
def test_softmaximum_and_reduce_match_reference(tau):
    """Values within 2 float32 ulps of x/τ (times τ); gradients (softmax
    weights in [0, 1]) within 2e-4: the reference's ``logaddexp`` JVP forms
    its weights as exp(x - out), whose rounding at the scale of x/τ (up to
    2000 here) is ~1.2e-4 relative; the port's are exact.  A third of the
    entries tie exactly (weights 1/2)."""
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 20, (64,)).astype(np.float32)
    b = rng.uniform(0, 20, (64,)).astype(np.float32)
    b[::3] = a[::3]
    x = rng.uniform(0, 20, (16, 9)).astype(np.float32)
    x[:, 3] = x[:, 5]
    x[:, 7] = port_mp.NEG                          # a padded slot
    t = np.float32(tau)
    rv, (rga, rgb) = jax.value_and_grad(
        lambda u, v: ref_mp.softmaximum(u, v, t).sum(), (0, 1))(
            jnp.asarray(a), jnp.asarray(b))
    A = torch.tensor(a, requires_grad=True)
    Bt = torch.tensor(b, requires_grad=True)
    pv = port_mp.softmaximum(A, Bt, torch.tensor(t))
    pv.sum().backward()
    rs = np.asarray(ref_mp.softmaximum(jnp.asarray(a), jnp.asarray(b), t))
    assert np.allclose(_np(pv), rs, rtol=0, atol=2 * tau * 2 ** -23 * 2000)
    assert np.allclose(_np(A.grad), rga, atol=2e-4)
    assert np.allclose(_np(Bt.grad), rgb, atol=2e-4)
    assert np.all(_np(A.grad)[::3] == 0.5)         # an exact even split
    rr, rg = jax.value_and_grad(
        lambda u: ref_mp.softmax_reduce(u, t, axis=1).sum())(jnp.asarray(x))
    X = torch.tensor(x, requires_grad=True)
    pr = port_mp.softmax_reduce(X, torch.tensor(t), dim=1)
    pr.sum().backward()
    ref_r = np.asarray(ref_mp.softmax_reduce(jnp.asarray(x), t, axis=1))
    assert np.allclose(_np(pr), ref_r, rtol=0, atol=2 * tau * 2 ** -23 * 2000)
    assert np.allclose(_np(X.grad), rg, atol=2e-4)
    assert np.all(_np(X.grad)[:, 7] == 0.0)        # the NEG slot is inert
    assert np.allclose(_np(X.grad).sum(axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("slots", [1, 2, 4])
def test_slot_queue_soft_matches_reference(slots, tau):
    """Completions within rtol 1e-5 (float32 prefix sums of ~30 latencies
    in another order); gradients of the summed completions w.r.t.
    arrivals and latencies (sums of up to 24 softmax weights) within
    2e-3: the reference's multi-slot begins are ``logaddexp`` weights
    (exp(x - out) at scale x/τ ≤ 2e4, ~1e-3 relative each), its
    single-slot ``cumlogsumexp`` JVP an associative scan of them."""
    rng = np.random.default_rng(slots)
    arrival = np.sort(rng.uniform(0, 50, 24)).astype(np.float32)
    arrival[5] = arrival[4]                        # a tie in arrival
    lat = rng.uniform(1, 9, 24).astype(np.float32)
    t = np.float32(tau)
    f = lambda a, l: ref_mp.slot_queue_soft(a, l, slots, t)
    ref = np.asarray(f(jnp.asarray(arrival), jnp.asarray(lat)))
    rga, rgl = jax.grad(lambda a, l: f(a, l).sum(), (0, 1))(
        jnp.asarray(arrival), jnp.asarray(lat))
    A = torch.tensor(arrival, requires_grad=True)
    L = torch.tensor(lat, requires_grad=True)
    out = port_mp.slot_queue_soft(A, L, slots, tau)
    out.sum().backward()
    assert _rel(_np(out), ref) <= 1e-5
    assert np.allclose(_np(A.grad), rga, atol=2e-3)
    assert np.allclose(_np(L.grad), rgl, atol=2e-3)
    hard = port_mp.slot_queue_scan(torch.tensor(arrival), torch.tensor(lat),
                                   slots)
    assert np.all(_np(out) >= _np(hard) - 1e-3)    # an upper bound


@pytest.mark.parametrize("scenario", REF_SCEN, ids=IDS)
def test_longest_path_and_fixed_point_soft_match_reference(scenario):
    """``longest_path_soft`` at every τ and ``fixed_point_soft`` (wavefront
    and condensed, τ = 0.05) on every operator cell: rtol 1e-5 (1e-4 on
    oma/gemm, whose 3800-deep chains carry the reference's tree cumsum
    and fused adds furthest); soft ≥ hard - 1e-2, the bound of the
    reference's own tests."""
    rtol = 1e-4 if scenario.name == "oma/gemm" else 1e-5
    ca = ref_ex.compile_scenario(scenario).compiled_aidg
    pca = port_ex.compile_scenario(port_ex.default_scenarios()[
        IDS.index(scenario.name)]).compiled_aidg
    hard = _np(port_mp.longest_path_wavefront(pca, device=CPU))
    for tau in TAUS:
        ref = np.asarray(ref_mp.longest_path_soft(ca, tau=tau))
        got = _np(port_mp.longest_path_soft(pca, tau=tau, device=CPU))
        assert _rel(got, ref) <= rtol, (scenario.name, tau)
        assert got.max() >= hard.max() - 1e-2
    hard = _np(port_mp.fixed_point_torch(pca, n_iters=2, device=CPU))
    for engine in ("wavefront", "condensed"):
        ref = np.asarray(ref_mp.fixed_point_soft(ca, tau=0.05, n_iters=2,
                                                 engine=engine))
        got = _np(port_mp.fixed_point_soft(pca, tau=0.05, n_iters=2,
                                           engine=engine, device=CPU))
        assert _rel(got, ref) <= rtol, (scenario.name, engine)
        assert got.max() >= hard.max() - 1e-2, (scenario.name, engine)


def test_fixed_point_soft_rejects_other_engines():
    pca = port_ex.compile_scenario(port_ex.default_scenarios()[2]
                                   ).compiled_aidg
    for engine in ("blocked", "scan", "nope"):
        with pytest.raises(ValueError, match="'wavefront' and 'condensed'"):
            port_mp.fixed_point_soft(pca, engine=engine, device=CPU)


# ---------------------------------------------------------------------------
# per-cell knob-space gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scenario", REF_SCEN, ids=IDS)
def test_grad_sweep_matches_reference(scenario, ref_packed, port_packed):
    """Soft cycles rtol 1e-5 (2e-5 on oma/gemm at τ = 0.01: its longest
    chains), gradients within 1e-4 of the cell's baseline at every τ, on
    θ = 1 and a random row; the 5% finite-difference gate of the
    reference's test at τ = 0.2 on the port's own values; gradients
    finite at τ = 0.01."""
    i = IDS.index(scenario.name)
    rc, pc = ref_packed.compiled[i], port_packed.compiled[i]
    proj = ref_packed.space.projection(rc.problem)
    rf = ref_dse.grad_sweep(rc.problem, *proj)
    pf = pc.grad_fn(port_packed._projections[i], device=CPU)
    k = _knobs(scenario.name)
    rtol = 2e-5 if scenario.name == "oma/gemm" else 1e-5
    for tau in TAUS:
        rv, rg = rf(jnp.asarray(k), jnp.float32(tau))
        pv, pg = pf(k, tau)
        assert _rel(_np(pv), rv) <= rtol, (scenario.name, tau)
        assert np.abs(_np(pg) - np.asarray(rg)).max() <= 1e-4 * rc.baseline
        assert np.isfinite(_np(pg)).all()
    tau, eps = 0.2, 1e-2
    rows = np.repeat(k[1:2], 2 * K + 1, axis=0)
    rows[1 + np.arange(0, 2 * K, 2), np.arange(K)] += eps
    rows[2 + np.arange(0, 2 * K, 2), np.arange(K)] -= eps
    v, g = pf(rows, tau)
    fd = (_np(v)[1::2] - _np(v)[2::2]) / (2 * eps)
    assert np.all(np.abs(fd - _np(g)[0]) <= 5e-2 * np.maximum(1.0,
                                                               np.abs(fd)))


def test_grad_sweep_is_cached_and_zero_on_unmatched_knobs(port_packed):
    """The cache returns the same function per (maps, n_iters, device);
    a knob matching nothing in plasticine/reduce gets exactly zero."""
    cs = port_packed.compiled[0]
    proj = port_packed.space.projection(cs.problem)
    assert (port_dse.grad_sweep(cs.problem, *proj, device=CPU)
            is port_dse.grad_sweep(cs.problem, *proj, device=CPU))
    i = IDS.index("plasticine/reduce")
    cs = port_packed.compiled[i]
    op_idx, st_idx = port_packed._projections[i]
    fn = cs.grad_fn((op_idx, st_idx), device=CPU)
    _, g = fn(np.ones((1, K), np.float32), 0.1)
    matched = set(op_idx[op_idx < K]) | set(st_idx[st_idx < K])
    assert matched and len(matched) < K
    for k in range(K):
        if k not in matched:
            assert _np(g)[0, k] == 0.0


def test_evaluate_theta_soft_anneals_to_hard(port_packed):
    """τ = 0.01 on every cell within 5e-3 of the hard cycles (the
    reference's own gate), and one point against the reference."""
    for i, pc in enumerate(port_packed.compiled):
        p = pc.problem
        one_op, one_st = np.ones(p.n_op, np.float32), np.ones(p.n_st,
                                                               np.float32)
        hard = float(port_dse.evaluate_theta(p, one_op, one_st, device=CPU))
        soft = float(port_dse.evaluate_theta_soft(p, one_op, one_st, 0.01,
                                                  device=CPU))
        assert abs(soft - hard) / max(1.0, hard) < 5e-3, IDS[i]
    p = port_packed.compiled[2].problem
    rp = ref_ex.compile_scenario(REF_SCEN[2]).problem
    to = np.full(p.n_op, 0.7, np.float32)
    ts = np.full(p.n_st, 1.3, np.float32)
    ref = float(ref_dse.evaluate_theta_soft(rp, jnp.asarray(to),
                                            jnp.asarray(ts), 0.05))
    got = float(port_dse.evaluate_theta_soft(p, to, ts, 0.05, device=CPU))
    assert got == pytest.approx(ref, rel=1e-5)


# ---------------------------------------------------------------------------
# the packed soft family
# ---------------------------------------------------------------------------

FD_EPS = 1e-3
FD_ATOL = 2e-3    # port vs central differences (step 1e-3) of the
#                   reference's values: truncation ~(step/τ)² of the soft
#                   curvature plus float32 noise of the values / step


def _in_pairs(fn, rows: np.ndarray):
    """``fn`` over ``rows`` two at a time (the reference's jitted function
    compiles once per batch shape; the refine runs it at 2), stacked."""
    outs = [fn(rows[i:i + 2]) for i in range(0, len(rows), 2)]
    return tuple(np.concatenate([np.asarray(o[j]) for o in outs])
                 for j in range(len(outs[0])))


def _with_differences(fn, k: np.ndarray, tau: float):
    """The reference's ``fn(knobs, tau) -> (values, grads)`` at the rows
    ``k`` and its central differences around each row: (values, grads,
    differences (B, K) or (B, C, K))."""
    B = k.shape[0]
    rows = np.repeat(k, 2 * K, axis=0).reshape(B, 2 * K, K)
    rows[:, np.arange(0, 2 * K, 2), np.arange(K)] += FD_EPS
    rows[:, np.arange(1, 2 * K, 2), np.arange(K)] -= FD_EPS
    steps = (rows[:, 0::2] - rows[:, 1::2])[:, np.arange(K), np.arange(K)]
    call = lambda x: fn(jnp.asarray(x), jnp.float32(tau))
    v, g = _in_pairs(call, k)
    vr = _in_pairs(call, rows.reshape(-1, K))[0].astype(np.float64)
    vr = vr.reshape((B, 2 * K) + vr.shape[1:])
    fd = (vr[:, 0::2] - vr[:, 1::2]) / (steps.reshape(
        (B, K) + (1,) * (vr.ndim - 2)).astype(np.float64))
    if fd.ndim == 3:                              # (B, K, C) -> (B, C, K)
        fd = fd.transpose(0, 2, 1)
    return np.asarray(v, np.float64), np.asarray(g, np.float64), fd


@pytest.fixture(scope="module")
def packed_ref(ref_packed):
    """The reference's packed ``grad_fn`` on the 10-cell matrix at θ = 1
    and a random row, per τ, with its central differences."""
    rf = ref_packed.packed_matrix().grad_fn(ref_packed.baselines)
    k = _knobs("packed", 2)
    return k, {tau: _with_differences(rf, k, tau) for tau in TAUS}


@pytest.fixture(scope="module")
def net_explorers():
    """olmo-1b on tpu_v5e, sequential and pipelined, as a packed matrix in
    each package."""
    from repro.core.network.model import NetworkScenario as RefNS
    cells = lambda NS: [NS("tpu_v5e", "olmo_1b"),
                        NS("tpu_v5e", "olmo_1b", mode="pipelined")]
    return (ref_ex.Explorer(scenarios=cells(RefNS)),
            port_ex.Explorer(scenarios=cells(NetworkScenario), device=CPU))


@pytest.fixture(scope="module")
def net_ref(net_explorers):
    """The reference's packed ``grad3_fn`` (latency and energy rows) on
    the network matrix at θ = 1 and a random row, per τ."""
    rex = net_explorers[0]
    rf = rex.packed_matrix().grad3_fn(rex.baselines, rex.energy_baselines)
    k = _knobs("olmo_1b", 2)
    return k, {tau: _with_differences(rf, k, tau) for tau in (0.5, 0.01)}


@pytest.mark.parametrize("tau", TAUS)
def test_packed_grad_fn_matches_reference(tau, packed_ref, port_packed):
    """The 10-cell matrix: mean normalized soft latency rtol 1e-6 (the same
    float32 operations; sums in another order); the gradient within
    ``FD_ATOL`` of the central differences of the reference's values, and
    finite.  At τ = 0.5 also within 1e-3 of the reference's gradient
    (C8's rounding is small there: 1.4e-4 measured)."""
    k, res = packed_ref
    rv, rg, fd = res[tau]
    pv, pg = port_packed.packed_matrix().grad_fn(port_packed.baselines)(
        k, tau)
    assert _rel(_np(pv), rv) <= 1e-6
    assert np.isfinite(_np(pg)).all()
    assert np.abs(_np(pg) - fd).max() <= FD_ATOL
    if tau == 0.5:
        assert np.abs(_np(pg) - rg).max() <= 1e-3


def test_packed_grad3_fn_matches_reference(net_ref, net_explorers,
                                           port_packed):
    """Latency and energy rows on the network matrix (sequential and
    pipelined olmo-1b): values rtol 1e-6, the Jacobian within ``FD_ATOL``
    of the central differences of the reference's values (the energy
    row's dynamic term is analytic, its static term rides the soft
    makespan); the reference's own Jacobian departs from them here even
    at τ = 0.5 (1.3e-2, C8).  The latency row is ``grad_fn``'s gradient,
    on this matrix and on the 10-cell one."""
    k, res = net_ref
    pex = net_explorers[1]
    pm = pex.packed_matrix()
    pf = pm.grad3_fn(pex.baselines, pex.energy_baselines)
    assert pf is pm.grad3_fn(pex.baselines, pex.energy_baselines)
    for tau, (rv, rj, fd) in res.items():
        pv, pj = pf(k, tau)
        assert _np(pv).shape == (2, 2) and _np(pj).shape == (2, 2, K)
        assert _rel(_np(pv), rv) <= 1e-6
        assert np.isfinite(_np(pj)).all()
        assert np.abs(_np(pj) - fd).max() <= FD_ATOL, tau
        _, g = pm.grad_fn(pex.baselines)(k, tau)
        assert np.allclose(_np(pj)[:, 0], _np(g), rtol=0, atol=1e-7)
    pm = port_packed.packed_matrix()
    _, j = pm.grad3_fn(port_packed.baselines,
                       port_packed.energy_baselines)(k, 0.05)
    _, g = pm.grad_fn(port_packed.baselines)(k, 0.05)
    assert np.allclose(_np(j)[:, 0], _np(g), rtol=0, atol=1e-7)


def test_reference_packed_gradient_departs_from_its_differences(
        packed_ref, net_ref, port_packed, net_explorers):
    """C8, pinned: at θ = 1 and τ = 0.01 the reference's packed gradient
    lies well off the central differences of its own values — its
    ``logaddexp`` JVP forms softmax weights as exp(x - out), rounded at
    the scale of x/τ, and the error compounds along the soft paths — while
    the port's stays within ``FD_ATOL``: on the 10-cell matrix more than
    twice the port's error, on the network matrix's latency row by more
    than 0.5 (per unit knob, of a mean normalized latency near 1)."""
    k, res = packed_ref
    rv, rg, fd = res[0.01]
    _, pg = port_packed.packed_matrix().grad_fn(port_packed.baselines)(
        k, 0.01)
    port_err = np.abs(_np(pg)[0] - fd[0]).max()
    ref_err = np.abs(rg[0] - fd[0]).max()
    assert port_err <= FD_ATOL and ref_err > 2 * port_err, (ref_err,
                                                            port_err)
    k, res = net_ref
    rv, rj, fd = res[0.01]
    assert np.abs(rj[0, 0] - fd[0, 0]).max() > 0.5


def test_compiled_network_grad_fn_matches_reference():
    """``CompiledNetwork.grad_fn`` (the stacked per-layer soft family and
    the composition with its softmin overlap clip) on pipelined olmo-1b
    over tpu_v5e: end-to-end soft cycles rtol 1e-5, gradients within 1e-4
    of the cycles (per-cell soft family: exact weights in both)."""
    from repro.core.network.model import NetworkScenario as RefNS
    rn = RefNS("tpu_v5e", "olmo_1b", mode="pipelined").compile()
    pn = NetworkScenario("tpu_v5e", "olmo_1b", mode="pipelined").compile()
    proj = pn.projection(port_ex.DEFAULT_SPACE)
    rf = rn.grad_fn(rn.projection(ref_ex.DEFAULT_SPACE))
    pf = pn.grad_fn(proj, device=CPU)
    assert pf is pn.grad_fn(proj, device=CPU)
    k = _knobs("olmo_1b/pipelined", 2)
    for tau in (0.5, 0.01):
        rv, rg = rf(jnp.asarray(k), jnp.float32(tau))
        pv, pg = pf(k, tau)
        assert _rel(_np(pv), rv) <= 1e-5, tau
        assert np.abs(_np(pg) - np.asarray(rg)).max() <= 1e-4 * float(
            np.asarray(rv).max()), tau


# ---------------------------------------------------------------------------
# the gradient search
# ---------------------------------------------------------------------------


def test_refine_matches_reference(refined):
    """The default refine (2 starts, 22 steps, τ 0.5 -> 0.01) from the same
    starts: the log-objective history (τ, mean, min per step) within 5e-4
    — C8's gradient difference moves Adam's steps by ~1e-4 of the log
    objective (1e-4 measured); final thetas rtol 1e-2 (3e-3 measured);
    the hard scores rtol 1e-4 and the same winning start."""
    ref, port = refined
    assert np.array_equal(port.start_thetas, ref.start_thetas)
    assert len(port.history) == len(ref.history) == 22
    for a, b in zip(ref.history, port.history):
        assert a["step"] == b["step"] and a["tau"] == b["tau"]
        assert abs(a["obj_mean"] - b["obj_mean"]) <= 5e-4, (a, b)
        assert abs(a["obj_min"] - b["obj_min"]) <= 5e-4, (a, b)
    assert np.allclose(port.final_thetas, ref.final_thetas, rtol=1e-2)
    assert np.allclose(port.final_scores, ref.final_scores, rtol=1e-4)
    assert port.best_start == ref.best_start
    assert port.score == pytest.approx(ref.score, rel=1e-4)


def test_gradient_refine_beats_coordinate_descent(port_packed, refined):
    """The reference's acceptance gate, on the port: from θ = 1 the
    default gradient search (46 evaluations) reaches a latency·cost at
    least as good as the default coordinate descent (100), allowing
    0.1%; the incumbent lies in the knob box and its reported score is
    the hard evaluator's."""
    _, out = refined
    cd = port_packed.refine()
    cd_evals = (9 + 1) * K * 2
    res = port_packed.explore(cd[None, :])
    cd_score = float(res.latency[0] * res.cost[0])
    assert out.evaluations == 46 and out.evaluations * 2 <= cd_evals
    assert out.score <= cd_score * 1.001, (out.score, cd_score)
    lo = np.asarray([k.lo for k in port_packed.space.knobs])
    hi = np.asarray([k.hi for k in port_packed.space.knobs])
    assert np.all(out.theta >= lo - 1e-6) and np.all(out.theta <= hi + 1e-6)
    re = port_packed.explore(out.theta[None, :])
    assert float(re.latency[0] * re.cost[0]) == pytest.approx(out.score,
                                                              rel=1e-6)


def test_gradient_refine_is_deterministic(port_packed):
    """On the CPU two identical refines agree bit for bit."""
    ge = PortGE(port_packed)
    a = ge.refine(starts=2, steps=3, seed=5)
    b = ge.refine(starts=2, steps=3, seed=5)
    assert np.array_equal(a.theta, b.theta)
    assert np.array_equal(a.final_thetas, b.final_thetas)
    assert a.score == b.score and a.history == b.history
    assert a.evaluations == b.evaluations == 2 * 3 + 2


def test_latency_objective_pushes_faster_hardware(port_packed):
    """Pure-latency descent has no cost counterweight: every knob ends at
    or below 1 and the latency does not rise."""
    ge = PortGE(port_packed, objective="latency")
    out = ge.refine(starts=1, steps=6, lr=0.4, tau0=0.2, tau_min=0.05)
    base = port_packed.explore(np.ones((1, K), np.float32))
    ref = port_packed.explore(out.theta[None, :])
    assert ref.latency[0] <= base.latency[0]
    assert np.all(out.theta <= 1.0 + 1e-6)


def test_energy_objectives_need_the_packed_engine(port_packed):
    """``energy``/``edp`` ride ``grad3_fn`` and are refused on a per-cell
    explorer; on the packed one they run and improve on θ = 1."""
    wf = port_ex.Explorer(port_ex.default_scenarios()[5:6],
                          engine="wavefront", device=CPU)
    for objective in ("energy", "edp"):
        with pytest.raises(ValueError, match="packed engine"):
            PortGE(wf, objective=objective)
    ge = PortGE(port_packed, objective="edp")
    assert ge._packed3_fn is not None
    out = ge.refine(starts=1, steps=3)
    base = float(ge.hard_score(np.ones((1, K), np.float32))[0])
    assert out.score <= base + 1e-6


def test_percell_gradient_path_matches_packed(port_packed):
    """The per-cell fallback (a wavefront explorer) descends the same
    objective as the packed path: the reference's tolerances (rel 2e-2
    value, rtol 0.2 / atol 5e-2 gradient — condensed chains keep exact
    sums, so the soft surfaces are close, not identical)."""
    wf = port_ex.Explorer(engine="wavefront", device=CPU)
    gp, gc = PortGE(port_packed), PortGE(wf)
    assert gp._packed_fn is not None and gc._packed_fn is None
    k0 = np.asarray([[0.9, 1.1, 1.0, 1.2, 0.8]], np.float32)
    vp, dp = gp.value_and_grad(k0, 0.05)
    vc, dc = gc.value_and_grad(k0, 0.05)
    assert vp[0] == pytest.approx(vc[0], rel=2e-2)
    assert np.allclose(dp, dc, rtol=0.2, atol=5e-2)


def test_refine_api(port_packed):
    """``refine(method="grad")`` returns an in-box knob vector no worse
    than θ = 1; arguments of the other method and unknown methods are
    refused with the reference's errors."""
    theta = port_packed.refine(method="grad", starts=1, steps=4, tau0=0.2)
    assert theta.shape == (K,)
    base = port_packed.explore(np.ones((1, K), np.float32))
    ref = port_packed.explore(theta[None, :])
    assert (ref.latency[0] * ref.cost[0]
            <= base.latency[0] * base.cost[0] + 1e-6)
    with pytest.raises(ValueError, match="method"):
        port_packed.refine(method="newton")
    with pytest.raises(TypeError, match="coord"):
        port_packed.refine(method="coord", steps=3)
    with pytest.raises(TypeError, match="starts/steps"):
        port_packed.refine(method="grad", rounds=5)
    with pytest.raises(TypeError, match="starts/steps"):
        port_packed.refine(method="grad", points=20)
    with pytest.raises(ValueError, match="objective"):
        PortGE(port_packed, objective="area")
