"""Structured error taxonomy for the serving stack.

Every way a query can fail — shed at admission, past its deadline, or
stranded behind a dead oracle — maps to one :class:`ServeError` subclass
carrying a stable machine-readable ``kind``, an HTTP-flavoured ``code``,
and a ``retryable`` hint, so clients (and the RPC front-end, which
serializes them as ``{"ok": false, "error": {...}}`` frames) can react
programmatically instead of parsing message strings.

The taxonomy is deliberately small and closed:

=====================  ====  =========  =======================================
class                  code  retryable  raised when
=====================  ====  =========  =======================================
``InvalidQuery``       400   no         the query itself is malformed (unknown
                                        workload/arch/knob, out-of-range pin)
``Overloaded``         429   yes        the front-end's admission queue is full
                                        (load shedding — try again later)
``OracleUnavailable``  503   yes        the circuit breaker is open and the
                                        query has no surrogate coverage to
                                        degrade onto
``DeadlineExceeded``   504   yes        the per-query deadline or the client
                                        timeout elapsed first
=====================  ====  =========  =======================================

``TransientDispatchError`` / ``PoisonedDispatch`` are internal: the
retry policy treats them as retryable dispatch outcomes and they never
reach a client un-translated (after the retry budget they surface as
``OracleUnavailable`` for the queries that could not degrade).
"""

from __future__ import annotations

from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Dict, Optional, Type

__all__ = [
    "ServeError", "InvalidQuery", "Overloaded", "OracleUnavailable",
    "DeadlineExceeded", "TransientDispatchError", "PoisonedDispatch",
    "error_payload", "error_from_payload",
]


class ServeError(Exception):
    """Base class: a structured, client-visible serving failure."""

    kind: str = "serve-error"
    code: int = 500
    retryable: bool = False

    def __init__(self, message: str = "", **detail):
        super().__init__(message or self.kind)
        self.detail: Dict[str, object] = detail


class InvalidQuery(ServeError):
    """The query itself is malformed — retrying the same bytes cannot
    succeed (unknown workload/arch/knob, out-of-range override, bad
    frame)."""

    kind = "invalid-query"
    code = 400
    retryable = False


class Overloaded(ServeError):
    """Load-shed at admission: the front-end's bounded in-flight queue is
    full.  The 429 of the serving stack — the request was never enqueued,
    so retrying after a backoff is safe and expected."""

    kind = "overloaded"
    code = 429
    retryable = True


class OracleUnavailable(ServeError):
    """The packed oracle is unreachable (circuit breaker open / retries
    exhausted) and this query has no calibrated surrogate coverage to
    degrade onto — it fails fast instead of queuing behind a dead
    dispatch."""

    kind = "oracle-unavailable"
    code = 503
    retryable = True


class DeadlineExceeded(ServeError, _FutureTimeout):
    """The per-query deadline (or the blocking-call timeout) elapsed
    before an answer was produced.  Subclasses
    ``concurrent.futures.TimeoutError`` so callers of the pre-deadline
    API that caught ``TimeoutError`` keep working unchanged."""

    kind = "deadline-exceeded"
    code = 504
    retryable = True


class TransientDispatchError(ServeError):
    """Internal: one packed-dispatch attempt failed in a way worth
    retrying (injected fault, flaky backend).  Consumed by the retry
    policy / circuit breaker; clients never see it directly."""

    kind = "transient-dispatch"
    code = 503
    retryable = True


class PoisonedDispatch(TransientDispatchError):
    """Internal: the dispatch RETURNED, but its payload failed output
    validation (non-finite cycles/energy) — treated exactly like a
    failed attempt so a misbehaving oracle cannot leak garbage answers."""

    kind = "poisoned-dispatch"


_KINDS: Dict[str, Type[ServeError]] = {
    cls.kind: cls
    for cls in (ServeError, InvalidQuery, Overloaded, OracleUnavailable,
                DeadlineExceeded, TransientDispatchError, PoisonedDispatch)
}


def error_payload(err: BaseException) -> Dict[str, object]:
    """The wire form of an error (``{"kind", "code", "message",
    "retryable", "detail"}``) — non-:class:`ServeError` exceptions map to
    the base kind so the frame is always well-formed."""
    if isinstance(err, ServeError):
        return {"kind": err.kind, "code": err.code, "message": str(err),
                "retryable": err.retryable, "detail": dict(err.detail)}
    return {"kind": ServeError.kind, "code": ServeError.code,
            "message": f"{type(err).__name__}: {err}", "retryable": False,
            "detail": {}}


def error_from_payload(payload: Dict[str, object],
                       default: Optional[Type[ServeError]] = None
                       ) -> ServeError:
    """Reconstruct the matching :class:`ServeError` subclass from a wire
    payload (unknown kinds fall back to ``default`` or the base class) —
    the client half of the structured-error round trip."""
    cls = _KINDS.get(str(payload.get("kind")), default or ServeError)
    err = cls(str(payload.get("message", "")),
              **dict(payload.get("detail") or {}))
    return err
