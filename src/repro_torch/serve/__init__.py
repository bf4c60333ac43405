"""DSE-as-a-service: the persistent, micro-batching, cache-backed query
engine over the port's matrix-packed evaluator (see ``docs/serving.md``
for the reference package's service, which this one mirrors).

    from repro_torch.serve import DSEService, Query

    with DSEService(networks=True) as svc:          # on cuda by default
        ans = svc.query(workload="gemm", archs=("gamma", "tpu_v5e"))
        print(ans.best_arch, ans.best.knobs(svc.space.names))

Fault tolerance rides on top: :mod:`repro_torch.serve.policy` (retry +
circuit breaker), :mod:`repro_torch.serve.faults` (deterministic fault
injection), :mod:`repro_torch.serve.errors` (the structured error
taxonomy) and :mod:`repro_torch.serve.frontend` (the length-prefixed-JSON
RPC front-end with deadlines, admission control, and health probes).
``errors``, ``query``, ``policy``, ``faults``, ``batcher`` and
``frontend`` are the reference's modules copied as they are (standard
library only).
"""

from .batcher import MicroBatcher, plan_batches
from .engine import DEGRADED_WIDEN, DSEService
from .errors import (DeadlineExceeded, InvalidQuery, OracleUnavailable,
                     Overloaded, PoisonedDispatch, ServeError,
                     TransientDispatchError, error_from_payload,
                     error_payload)
from .faults import (ENV_FAULT_PLAN, FaultAction, FaultInjector, FaultPlan,
                     WorkerKill)
from .frontend import ServeClient, ServeFrontend
from .policy import CircuitBreaker, RetryPolicy
from .query import Answer, Design, Query

__all__ = [
    "DSEService", "DEGRADED_WIDEN", "MicroBatcher", "plan_batches",
    "Query", "Design", "Answer",
    "ServeError", "InvalidQuery", "Overloaded", "OracleUnavailable",
    "DeadlineExceeded", "TransientDispatchError", "PoisonedDispatch",
    "error_payload", "error_from_payload",
    "RetryPolicy", "CircuitBreaker",
    "FaultPlan", "FaultAction", "FaultInjector", "WorkerKill",
    "ENV_FAULT_PLAN",
    "ServeFrontend", "ServeClient",
]
