"""Fault tolerance of the port's serving stack (``repro_torch.serve``),
ported from ``tests/test_serve_faults.py`` on its 2-cell corner (oma/gemm
+ systolic/gemm, on the CPU): the fault plan grammar replays
deterministically, transient dispatch failures are retried and absorbed,
the circuit breaker walks closed -> open -> half-open -> closed exactly
as specified, queries degrade onto the port's surrogate tier with
honestly widened bounds (and recover to exact packed answers), deadlines
and timeouts never leak enqueued work, a killed worker thread respawns,
and the RPC front-end over 127.0.0.1 sheds load and frames every failure
as a structured error.

The determinism contract extends under injected faults: the SAME fault
plan on a fresh service produces the SAME per-query outcomes threaded as
in sequential replay.  The no-loss property closes the file; its
recovery walk runs until the fault schedule is spent (the reference's
version stops at the first clean probe, ROADMAP.md C4).
"""

import functools
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings, strategies as st

from repro_torch.core.aidg.explorer import (Explorer, default_scenarios,
                                            resolve_cells)
from repro_torch.serve import (DEGRADED_WIDEN, Answer, CircuitBreaker,
                               DeadlineExceeded, DSEService, FaultAction,
                               FaultPlan, InvalidQuery, MicroBatcher,
                               OracleUnavailable, Overloaded,
                               PoisonedDispatch, Query, RetryPolicy,
                               ServeClient, ServeError, ServeFrontend,
                               TransientDispatchError, WorkerKill,
                               error_from_payload, error_payload)
from repro_torch.serve.faults import ENV_FAULT_PLAN
from repro_torch.surrogate import SurrogateConfig, train_surrogate

# reduced budget: these tests exercise failure mechanics, not accuracy
CFG = SurrogateConfig(n_samples=48, steps=250)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on
    a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ex2():
    """oma/gemm + systolic/gemm — the cheap 2-cell corner, enough for
    subset queries and surrogate coverage to be non-trivial."""
    return Explorer(scenarios=default_scenarios()[:2], device="cpu")


@pytest.fixture(scope="module")
def bundle(ex2):
    return train_surrogate(ex2, CFG)


def make_svc(ex2, **kw):
    kw.setdefault("pool", 8)
    kw.setdefault("seed", 1)
    kw.setdefault("max_batch", 4)
    kw.setdefault("window_s", 0.005)
    kw.setdefault("retry", RetryPolicy(max_attempts=2, base_s=0.0))
    return DSEService(ex2, **kw)


# -- fault plan grammar -------------------------------------------------------

def test_fault_plan_parse_and_lookup():
    plan = FaultPlan.parse(
        "packed[2:5]=error; packed[6]=latency:0.25; packed[8:]=poison")
    assert plan.action("packed", 1) == FaultAction()
    assert plan.action("packed", 2) == FaultAction("error")
    assert plan.action("packed", 4) == FaultAction("error")
    assert plan.action("packed", 5) == FaultAction()
    assert plan.action("packed", 6) == FaultAction("ok", 0.25)
    assert plan.action("packed", 7) == FaultAction()
    assert plan.action("packed", 8) == FaultAction("poison")
    assert plan.action("packed", 10 ** 6) == FaultAction("poison")
    # last clause wins on overlap
    refined = FaultPlan.parse("packed[0:10]=error;packed[3]=kill")
    assert refined.action("packed", 3) == FaultAction("kill")
    assert refined.action("packed", 4) == FaultAction("error")


def test_fault_plan_roundtrip_and_window():
    spec = "packed[0:2]=error;packed[4]=latency:0.01;packed[5]=kill"
    plan = FaultPlan.parse(spec)
    assert FaultPlan.parse(plan.to_spec()) == plan
    assert plan.max_faulty_attempt() == 6      # one past the last faulty
    assert FaultPlan.parse("packed[3:]=error").max_faulty_attempt() == -1
    assert FaultPlan.parse("").max_faulty_attempt() == 0


@pytest.mark.parametrize("bad", [
    "packed=error",                  # no selector
    "packed[]=error",                # "[]" is legal: attempt 0
    "gemm[0]=error",                 # unknown site
    "packed[0]=explode",             # unknown action
    "packed[0]=error:7",             # error takes no parameter
    "packed[5:2]=error",             # empty range
    "packed[0] error",               # malformed clause
])
def test_fault_plan_rejects_malformed(bad):
    if bad == "packed[]=error":
        # `[]` is the degenerate-but-legal "attempt 0" selector
        assert FaultPlan.parse(bad).action("packed", 0) == FaultAction("error")
        return
    with pytest.raises(ValueError):
        FaultPlan.parse(bad)


def test_fault_plan_env_hook(ex2, monkeypatch):
    monkeypatch.setenv(ENV_FAULT_PLAN, "packed[0]=error")
    svc = make_svc(ex2)
    try:
        assert svc.fault_plan is not None
        assert svc.fault_plan.to_spec() == "packed[0]=error"
    finally:
        svc.close()
    monkeypatch.delenv(ENV_FAULT_PLAN)
    svc = make_svc(ex2)
    try:
        assert svc.fault_plan is None
        assert svc.stats()["fault_plan"] is None
    finally:
        svc.close()


# -- retry policy + circuit breaker (unit) -----------------------------------

def test_retry_delays_deterministic_and_bounded():
    a = list(RetryPolicy(max_attempts=4, base_s=0.01, factor=2.0,
                         jitter=0.5, seed=7).delays())
    b = list(RetryPolicy(max_attempts=4, base_s=0.01, factor=2.0,
                         jitter=0.5, seed=7).delays())
    assert a == b                       # seeded jitter: pure replay
    assert a[0] == 0.0                  # first attempt never sleeps
    for i, d in enumerate(a[1:], 1):
        lo = 0.01 * 2.0 ** (i - 1)
        assert lo <= d <= lo * 1.5


def test_retry_call_budget_and_passthrough():
    calls = []

    def flaky():
        calls.append(1)
        raise TransientDispatchError("nope")

    r = RetryPolicy(max_attempts=3, base_s=0.0)
    with pytest.raises(TransientDispatchError):
        r.call(flaky, retry_on=(TransientDispatchError,))
    assert len(calls) == 3
    # non-matching exceptions propagate immediately, unretried
    calls.clear()

    def wrong():
        calls.append(1)
        raise ValueError("not transient")

    with pytest.raises(ValueError):
        r.call(wrong, retry_on=(TransientDispatchError,))
    assert len(calls) == 1


def test_breaker_state_machine():
    br = CircuitBreaker(open_after=2, probe_after=2)
    assert br.state == "closed" and br.allow()
    br.record_failure()
    assert br.state == "closed"         # streak 1 < open_after
    br.record_success()
    br.record_failure()
    assert br.state == "closed"         # success reset the streak
    br.record_failure()
    br.record_failure()
    assert br.state == "open" and br.opens == 1
    # open: probe_after rejections, then the next allow() IS the probe
    assert not br.allow() and not br.allow()
    assert br.allow() and br.state == "half-open"
    # concurrent dispatches shed while the probe is in flight
    assert not br.allow()
    br.record_failure()                 # failed probe re-opens
    assert br.state == "open" and br.opens == 2
    assert not br.allow() and not br.allow()
    assert br.allow()
    br.record_success()                 # successful probe closes
    assert br.state == "closed"
    assert br.transitions == [("closed", "open"), ("open", "half-open"),
                              ("half-open", "open"), ("open", "half-open"),
                              ("half-open", "closed")]
    snap = br.snapshot()
    assert snap["state"] == "closed" and snap["opens"] == 2


# -- service-level fault handling --------------------------------------------

def test_transient_faults_absorbed_by_retry(ex2):
    with make_svc(ex2, retry=RetryPolicy(max_attempts=3, base_s=0.0),
                  fault_plan="packed[0:2]=error") as svc:
        a = svc.query(workload="gemm")
        assert a.tier == "packed" and a.err_bound == 0.0
        st = svc.stats()
        assert st["retries"] == 2
        assert st["breaker"]["state"] == "closed"
        assert svc.faults.attempts() == 3


def test_poisoned_dispatch_retried_never_served(ex2):
    # the "oracle returns garbage" path: attempt 0 yields all-NaN output,
    # output validation converts it to a retryable PoisonedDispatch
    with make_svc(ex2, fault_plan="packed[0]=poison") as svc:
        a = svc.query(workload="gemm")
        assert a.tier == "packed"
        assert all(np.isfinite(c) for d in a.designs for c in d.cycles)
        assert svc.stats()["retries"] == 1
    assert issubclass(PoisonedDispatch, TransientDispatchError)


def test_exhausted_retries_fail_fast_without_surrogate(ex2):
    with make_svc(ex2, retry=RetryPolicy(max_attempts=1, base_s=0.0),
                  breaker=CircuitBreaker(open_after=1, probe_after=2),
                  fault_plan="packed[0]=error") as svc:
        with pytest.raises(OracleUnavailable) as ei:
            svc.query(workload="gemm")
        assert ei.value.code == 503 and ei.value.retryable
        assert svc.breaker.state == "open"
        assert svc.stats()["tiers"]["failed"] == 1
        # failed outcomes are never cached: the same query is a fresh miss
        assert svc.cache_stats["misses"] == 1
        with pytest.raises(OracleUnavailable):
            svc.query(workload="gemm")
        assert svc.cache_stats["misses"] == 2


def test_degraded_answers_recover_and_stay_within_bounds(ex2, bundle):
    q = Query.make(workload="gemm", top_k=4)
    # surrogate_max_err=-1 forces normal routing to the packed tier, so
    # the surrogate is ONLY reachable through degradation
    svc = make_svc(ex2, surrogate=bundle, surrogate_max_err=-1.0,
                   retry=RetryPolicy(max_attempts=1, base_s=0.0),
                   breaker=CircuitBreaker(open_after=1, probe_after=1),
                   fault_plan="packed[0]=error",
                   degraded_max_err=np.inf)
    try:
        # dispatch 1 fails -> breaker opens -> this very query degrades
        a = svc.query(q)
        assert a.tier == "surrogate-degraded" and not a.cached
        cols = np.asarray(resolve_cells(ex2.compiled, workload="gemm"))
        stated = DEGRADED_WIDEN * float(bundle.err_bound[cols].max())
        assert a.err_bound == pytest.approx(stated)
        assert svc.breaker.state == "open"

        # degraded answers are never cached: repeat is a fresh miss
        # (still degraded — the breaker needs one more rejected
        # opportunity before it half-opens)
        b = svc.query(q)
        assert b.tier == "surrogate-degraded" and not b.cached
        assert svc.cache_stats["hits"] == 0

        # third dispatch opportunity is the half-open probe; the plan is
        # clean from attempt 1 on, so it succeeds and the breaker closes
        c = svc.query(q)
        assert c.tier == "packed" and c.err_bound == 0.0
        assert svc.breaker.state == "closed"
        assert svc.breaker.transitions == [
            ("closed", "open"), ("open", "half-open"),
            ("half-open", "closed")]
        # recovery restored the exact answer to the cache
        d = svc.query(q)
        assert d.cached and d.tier == "packed"

        # honesty of the stated widened bound: every degraded design's
        # relative latency matches the packed oracle recomputed offline
        # within the bound stamped on the answer
        exact_c = c  # packed answer over the identical candidate block
        by_theta = {dd.theta: dd for dd in exact_c.designs}
        cycles, _ = ex2.evaluate_full(svc.pool)
        rel = (cycles[:, cols] / ex2.baselines[None, cols]).mean(axis=1)
        pool_lat = {tuple(float(v) for v in svc.pool[i]): float(rel[i])
                    for i in range(svc.pool.shape[0])}
        for dd in a.designs:
            exact = (by_theta[dd.theta].latency
                     if dd.theta in by_theta else pool_lat[dd.theta])
            assert abs(dd.latency - exact) / exact <= a.err_bound, (
                dd.theta, dd.latency, exact, a.err_bound)
    finally:
        svc.close()


def test_degradation_ladder_covers_only_calibrated_cells(ex2, bundle):
    # degraded_max_err below every calibrated bound: nothing is covered,
    # so an open breaker means fail-fast for ALL queries
    svc = make_svc(ex2, surrogate=bundle, surrogate_max_err=-1.0,
                   retry=RetryPolicy(max_attempts=1, base_s=0.0),
                   breaker=CircuitBreaker(open_after=1, probe_after=9),
                   fault_plan="packed[0]=error", degraded_max_err=0.0)
    try:
        with pytest.raises(OracleUnavailable) as ei:
            svc.query(workload="gemm")
        assert ei.value.detail.get("breaker") in ("closed", "open")
        with pytest.raises(OracleUnavailable):
            svc.query(workload="gemm", archs=["oma"])
        assert svc.stats()["tiers"]["failed"] == 2
        assert svc.stats()["tiers"]["surrogate-degraded"] == 0
    finally:
        svc.close()


def test_threaded_equals_replay_under_faults(ex2):
    """The determinism contract under chaos: the same fault plan on a
    fresh service yields the same per-query outcome (answer or error
    kind) threaded as in sequential replay, and the breaker walks the
    same transition path."""
    stream = [Query.make(workload="gemm", top_k=k) for k in range(1, 13)]
    mk = lambda: make_svc(  # noqa: E731 — two identical fresh services
        ex2, max_batch=4,
        retry=RetryPolicy(max_attempts=2, base_s=0.0),
        breaker=CircuitBreaker(open_after=1, probe_after=1),
        fault_plan="packed[0:2]=error")

    with mk() as replay_svc:
        replayed = replay_svc.query_many(stream, return_exceptions=True)
        replay_trans = list(replay_svc.breaker.transitions)
        replay_attempts = replay_svc.faults.attempts()

    with mk() as svc:
        with svc.batcher.hold():
            futs = [svc.submit(q) for q in stream]
        svc.batcher.drain()
        threaded = []
        for f in futs:
            threaded.append(f.exception() or f.result())
        threaded_trans = list(svc.breaker.transitions)
        threaded_attempts = svc.faults.attempts()

    # window 1: retries exhausted -> breaker opens -> OracleUnavailable;
    # window 2: rejected (the open->half-open cooldown opportunity);
    # window 3: the half-open probe succeeds -> packed answers
    assert [type(o).__name__ for o in replayed] == (
        ["OracleUnavailable"] * 8 + ["Answer"] * 4)
    assert len(threaded) == len(replayed) == len(stream)
    for got, want in zip(threaded, replayed):
        if isinstance(want, Answer):
            assert got == want and got.tier == want.tier
        else:
            assert type(got) is type(want)
    assert threaded_trans == replay_trans == [
        ("closed", "open"), ("open", "half-open"), ("half-open", "closed")]
    assert threaded_attempts == replay_attempts == 3


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_kill_fails_batch_and_respawns(ex2):
    with make_svc(ex2, fault_plan="packed[0]=kill") as svc:
        fut = svc.submit(workload="gemm")
        with pytest.raises(WorkerKill):
            fut.result(timeout=30)
        # the forwarded exception names its window
        assert len(fut.exception().batch_items) == 1
        # the worker died loudly (BaseException is not swallowed) …
        deadline = time.monotonic() + 5.0
        while svc.batcher._worker.is_alive():
            assert time.monotonic() < deadline, "worker survived WorkerKill"
            time.sleep(0.005)
        # … and the next submission respawns it; attempt 1 is clean
        a = svc.query(workload="gemm", timeout=30)
        assert a.tier == "packed"
        assert svc.stats()["worker_restarts"] == 1


def test_latency_spike_injection(ex2):
    with make_svc(ex2, fault_plan="packed[0]=latency:0.2") as svc:
        t0 = time.perf_counter()
        a = svc.query(workload="gemm")
        assert a.tier == "packed"
        assert time.perf_counter() - t0 >= 0.2
        assert svc.stats()["retries"] == 0      # a spike is not a failure


# -- deadlines and timeout accounting ----------------------------------------

def test_expired_deadline_fails_before_evaluation(ex2):
    with make_svc(ex2) as svc:
        with svc.batcher.hold():
            fut = svc.submit(Query.make(workload="gemm"), deadline_s=0.03)
            time.sleep(0.1)             # expire while the window is held
        with pytest.raises(DeadlineExceeded) as ei:
            fut.result(timeout=30)
        assert ei.value.code == 504
        assert isinstance(ei.value, FutureTimeout)
        st = svc.stats()
        assert st["deadline_misses"] == 1
        assert st["device_dispatches"] == 0      # never reached an oracle


def test_query_timeout_cancels_and_accounts(ex2):
    with make_svc(ex2) as svc:
        with svc.batcher.hold():
            with pytest.raises(DeadlineExceeded):
                svc.query(workload="gemm", timeout=0.05)
            # a second client timing out on the SAME held window
            with pytest.raises(DeadlineExceeded):
                svc.query(workload="gemm", deadline_s=0.05)
        svc.batcher.drain()
        st = svc.stats()
        assert st["timeouts"] == 2
        # both futures were cancelled while queued: reaped pre-dispatch,
        # so the abandoned window never touched the device
        assert st["cancelled"] == 2
        assert st["windows"] == 0 and st["device_dispatches"] == 0
        # the service still serves normally afterwards
        assert svc.query(workload="gemm").tier == "packed"


def test_deadline_closes_window_early(ex2):
    """window_s is huge; the submission's deadline must close it early.

    The service closes a submission's window at half its deadline.  The
    test bounds the instant the batcher closed the window (the moment it
    hands the batch to its dispatch callback), relative to the submit --
    not the whole query: the packed evaluation after it runs on a CPU
    shared with other test workers and is no part of the window."""
    deadline_s = 4.0
    with make_svc(ex2, window_s=30.0) as svc:
        closed = []
        dispatch = svc.batcher._dispatch

        def record_close(items):
            closed.append(time.monotonic())
            return dispatch(items)

        svc.batcher._dispatch = record_close
        t0 = time.monotonic()
        fut = svc.submit(Query.make(workload="gemm"), deadline_s=deadline_s)
        assert fut.result(timeout=60.0).tier == "packed"
        assert len(closed) == 1
        # closed by the deadline (not before half of it), with room for a
        # loaded host, far below the 30 s window
        assert deadline_s / 2 <= closed[0] - t0 < 10.0, closed[0] - t0


# -- micro-batcher failure contract ------------------------------------------

def test_batcher_per_item_exception_results():
    def dispatch(items):
        return [ValueError(f"bad {x}") if x % 2 else x * 10
                for x in items]

    with MicroBatcher(dispatch, max_batch=8, window_s=0.001) as b:
        with b.hold():
            futs = [b.submit(x) for x in range(4)]
        b.drain()
    assert futs[0].result() == 0 and futs[2].result() == 20
    with pytest.raises(ValueError):
        futs[1].result()
    with pytest.raises(ValueError):
        futs[3].result()
    # one window dispatched them all; per-item failure is not batch failure
    assert b.dispatch_log == [[0, 1, 2, 3]]


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_batcher_reraises_base_exception_and_respawns():
    boom = threading.Event()

    def dispatch(items):
        if not boom.is_set():
            boom.set()
            raise WorkerKill("die")
        return list(items)

    b = MicroBatcher(dispatch, max_batch=2, window_s=0.001)
    try:
        f1 = b.submit("a")
        with pytest.raises(WorkerKill) as ei:
            f1.result(timeout=10)
        assert ei.value.batch_items == ("a",)
        f2 = b.submit("b")              # respawns the dead worker
        assert f2.result(timeout=10) == "b"
        assert b.worker_restarts == 1
    finally:
        b.close()


def test_batcher_drain_timeout():
    release = threading.Event()

    def dispatch(items):
        release.wait(10)
        return list(items)

    b = MicroBatcher(dispatch, max_batch=1, window_s=0.0)
    try:
        fut = b.submit(1)
        with pytest.raises(TimeoutError):
            b.drain(timeout=0.05)
        release.set()
        assert fut.result(timeout=10) == 1
        b.drain(timeout=10)
    finally:
        b.close()


# -- structured errors on the wire -------------------------------------------

def test_error_payload_roundtrip():
    for err in (InvalidQuery("bad knob", knob="nope"),
                Overloaded("full", max_inflight=4),
                OracleUnavailable("down", breaker="open"),
                DeadlineExceeded("late", timeout_s=0.1)):
        p = error_payload(err)
        back = error_from_payload(p)
        assert type(back) is type(err)
        assert back.kind == err.kind and back.code == err.code
        assert back.retryable == err.retryable
        assert back.detail == err.detail and str(back) == str(err)
    # non-ServeError exceptions still produce a well-formed frame
    p = error_payload(RuntimeError("boom"))
    assert p["kind"] == "serve-error" and not p["retryable"]
    assert isinstance(error_from_payload(p), ServeError)
    # unknown kinds downgrade to the base class, never crash the client
    assert isinstance(error_from_payload({"kind": "from-the-future"}),
                      ServeError)


def test_wire_roundtrip_query_answer(ex2):
    q = Query.make(workload="gemm", archs=["systolic", "oma"],
                   overrides={"matrix": 2.0}, top_k=3)
    assert Query.from_payload(q.to_payload()) == q
    with make_svc(ex2) as svc:
        a = svc.query(q)
    back = Answer.from_payload(a.to_payload())
    assert back == a
    assert back.tier == a.tier and back.err_bound == a.err_bound
    assert back.cached == a.cached


# -- RPC front-end ------------------------------------------------------------

def test_frontend_roundtrip_health_stats(ex2):
    with make_svc(ex2) as svc:
        direct = svc.query(workload="gemm")
        with ServeFrontend(svc, max_inflight=4) as fe:
            with ServeClient(fe.address) as cli:
                a = cli.query(workload="gemm")
                assert a == direct and a.cached     # same cache, same answer
                h = cli.health()
                assert h["ready"] and h["breaker"] == "closed"
                assert h["fallback_rate"] == 1.0    # no surrogate armed
                assert h["shed"] == 0 and h["max_inflight"] == 4
                st = cli.stats()
                assert st["cache"]["hits"] == 1
                assert st["breaker"]["state"] == "closed"
            assert fe.accepted == 1 and fe.rpc_errors == 0


def test_frontend_rejects_invalid_queries(ex2):
    with make_svc(ex2) as svc, ServeFrontend(svc) as fe, \
            ServeClient(fe.address) as cli:
        with pytest.raises(InvalidQuery) as ei:
            cli.query(workload="gemm", overrides={"no_such_knob": 1.0})
        assert ei.value.code == 400 and not ei.value.retryable
        with pytest.raises(InvalidQuery):
            cli.query(workload="gemm", overrides={"matrix": 1e9})
        # an unknown op is an invalid request, not a dropped connection
        assert not cli._call({"op": "selfdestruct"})["ok"]
        # the connection survives all three errors
        assert cli.query(workload="gemm").tier == "packed"
        assert fe.rpc_errors == 3


def test_frontend_sheds_load_when_full(ex2):
    with make_svc(ex2) as svc, ServeFrontend(svc, max_inflight=1) as fe:
        with svc.batcher.hold():        # first query parks in the window
            got = {}

            def slow():
                with ServeClient(fe.address) as c:
                    got["a"] = c.query(workload="gemm")

            t = threading.Thread(target=slow)
            t.start()
            with ServeClient(fe.address) as cli:
                deadline = time.monotonic() + 10.0
                while cli.health()["inflight"] < 1:
                    assert time.monotonic() < deadline
                    time.sleep(0.005)
                with pytest.raises(Overloaded) as ei:
                    cli.query(workload="gemm")
                assert ei.value.code == 429 and ei.value.retryable
                assert ei.value.detail["max_inflight"] == 1
        t.join(timeout=30)
        assert got["a"].tier == "packed"    # the admitted query completed
        assert fe.shed == 1
        with ServeClient(fe.address) as cli:
            assert cli.health()["shed"] == 1


def test_frontend_propagates_deadline(ex2):
    with make_svc(ex2) as svc, ServeFrontend(svc) as fe, \
            ServeClient(fe.address) as cli:
        with svc.batcher.hold():
            with pytest.raises(DeadlineExceeded) as ei:
                cli.query(workload="gemm", deadline_ms=60)
            assert ei.value.code == 504 and ei.value.retryable
        svc.batcher.drain()
        assert svc.stats()["timeouts"] == 1
        # a generous deadline sails through
        a = cli.query(workload="gemm", deadline_ms=60_000)
        assert a.tier == "packed"


def test_frontend_surfaces_degraded_service(ex2, bundle):
    svc = make_svc(ex2, surrogate=bundle, surrogate_max_err=-1.0,
                   retry=RetryPolicy(max_attempts=1, base_s=0.0),
                   breaker=CircuitBreaker(open_after=1, probe_after=99),
                   fault_plan="packed[0:]=error", degraded_max_err=np.inf)
    try:
        with ServeFrontend(svc) as fe, ServeClient(fe.address) as cli:
            a = cli.query(workload="gemm")
            assert a.tier == "surrogate-degraded"
            assert a.err_bound > 0.0
            h = cli.health()
            assert h["breaker"] == "open" and h["ready"]
    finally:
        svc.close()


# -- the no-loss property -----------------------------------------------------

@functools.lru_cache(maxsize=1)
def _tiny_ex():
    """The property's 3-cell operator explorer, built once per process
    (Hypothesis examples share it)."""
    return Explorer(scenarios=default_scenarios()[:3], device="cpu")


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
@given(st.lists(st.sampled_from(["ok", "error", "poison", "kill"]),
                min_size=0, max_size=10),
       st.integers(1, 3), st.integers(1, 4))
# the schedule that falsifies the reference's version of this property:
# query 8 fails at attempt 7, the first clean probe (attempt 8) ends the
# reference's walk, and its final replay dispatches into attempt 9's fault
@example(actions=["ok"] * 7 + ["error", "ok", "error"], attempts=1, k=1)
@settings(max_examples=15, deadline=None)
def test_no_fault_schedule_drops_dups_or_reorders(actions, attempts, k):
    """Under ANY injected fault schedule — transient dispatch errors,
    poisoned payloads, worker-thread kills — every submitted query
    resolves to exactly one outcome, in submission order, that is either
    an Answer to ITS OWN question or a structured failure; once the
    schedule is spent the service answers every query exactly again."""
    spec = ";".join(f"packed[{i}]={a}"
                    for i, a in enumerate(actions) if a != "ok")
    svc = DSEService(_tiny_ex(), pool=8, max_batch=k,
                     retry=RetryPolicy(max_attempts=attempts, base_s=0.0),
                     breaker=CircuitBreaker(open_after=2, probe_after=1),
                     fault_plan=spec or None)
    try:
        queries = [Query.make(workload="gemm", top_k=t)
                   for t in range(1, 9)]
        with svc.batcher.hold():                 # pin window composition
            futs = [svc.submit(q) for q in queries]
        outcomes = [f.exception(timeout=60.0) or f.result()
                    for f in futs]
        assert len(outcomes) == len(queries)     # no drop, no dup
        for q, o in zip(queries, outcomes):
            if isinstance(o, Answer):
                assert o.query == q              # no reorder, no swap
            else:
                assert isinstance(o, (ServeError, WorkerKill)), o
        # walk the breaker (shed -> probe) with fresh, uncached queries
        # until the schedule is spent AND a probe came back clean: a clean
        # probe alone does not end the walk, since a later attempt may
        # still be faulty.  Each failed probe burns schedule, so the walk
        # is bounded by the schedule's length.
        last = svc.fault_plan.max_faulty_attempt() if svc.faults else 0
        assert last >= 0                         # the plan's window ends
        for i in range(4 * len(actions) + 8):
            try:
                svc.query_many([Query.make(workload="gemm", top_k=9 + i)])
            except (ServeError, WorkerKill):
                continue
            if svc.faults is None or svc.faults.attempts() > last:
                break
        else:
            pytest.fail("service never recovered after the schedule ran dry")
        assert svc.breaker.state == "closed"
        final = svc.query_many(queries)
        for q, a in zip(queries, final):
            assert isinstance(a, Answer) and a.query == q
            assert a.tier == "packed"
    finally:
        svc.close()
