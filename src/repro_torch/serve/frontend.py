"""The network front-end: length-prefixed-JSON RPC over TCP for
:class:`~repro.serve.engine.DSEService` (ROADMAP item 1's "real network
front-end (sockets/RPC)").

Wire protocol — deliberately boring: each frame is a 4-byte big-endian
length followed by a UTF-8 JSON body, both directions, many requests per
connection.  Requests are ``{"op": "query" | "health" | "stats", ...}``;
query requests carry the :meth:`Query.to_payload` fields plus an
optional ``deadline_ms``.  Responses are ``{"ok": true, ...}`` or
``{"ok": false, "error": {kind, code, message, retryable, detail}}``
(:mod:`repro.serve.errors`) — a client never has to parse message
strings to decide whether to retry.

Failure semantics at this layer (``docs/serving.md`` §Failure
semantics):

* **bounded admission** — at most ``max_inflight`` queries are being
  served concurrently; one more is shed immediately with a 429-style
  ``overloaded`` error instead of queuing without bound (the client's
  cue to back off);
* **deadline propagation** — ``deadline_ms`` becomes the service-side
  ``deadline_s``: it shortens the query's micro-batch window, expires it
  before evaluation when the window was too slow, and bounds the
  blocking wait — one number, enforced at every layer;
* **health/readiness** — ``{"op": "health"}`` answers without touching
  an oracle: readiness, circuit-breaker state, per-tier answer counts
  and latency, fallback rate, and the shed/timeout counters — what a
  load balancer polls to take a degraded replica out of rotation.

:class:`ServeClient` is the matching client (used by the load harness
and the chaos tests); :func:`send_frame` / :func:`recv_frame` expose the
framing for anyone speaking the protocol raw.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
from typing import Dict, Mapping, Optional, Tuple

from .engine import DSEService
from .errors import (InvalidQuery, Overloaded, ServeError, error_from_payload,
                     error_payload)
from .query import Answer, Query

__all__ = ["ServeFrontend", "ServeClient", "send_frame", "recv_frame"]

_LEN = struct.Struct(">I")
MAX_FRAME = 16 * 1024 * 1024


def _jsonable(obj):
    """Best-effort JSON sanitizer for stats payloads (tuples, numpy
    scalars, dict keys that are tuples)."""
    if isinstance(obj, Mapping):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "item"):               # numpy scalar
        return obj.item()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return str(obj)


def send_frame(sock: socket.socket, payload: Dict) -> None:
    """Write one length-prefixed JSON frame."""
    body = json.dumps(payload, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME:
        raise ValueError(f"frame of {len(body)} bytes exceeds {MAX_FRAME}")
    sock.sendall(_LEN.pack(len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def recv_frame(sock: socket.socket) -> Optional[Dict]:
    """Read one frame; ``None`` on a clean EOF at a frame boundary."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME:
        raise ValueError(f"peer announced a {n}-byte frame (> {MAX_FRAME})")
    body = _recv_exact(sock, n)
    if body is None:
        return None
    return json.loads(body.decode("utf-8"))


class ServeFrontend:
    """A threaded TCP server wrapping one :class:`DSEService` (see the
    module docstring for protocol and failure semantics).  Binds and
    starts serving on construction (``port=0`` picks a free port — read
    :attr:`address`); ``close()`` stops the listener, existing
    connections drain on their next request."""

    def __init__(self, service: DSEService, host: str = "127.0.0.1",
                 port: int = 0, max_inflight: int = 32,
                 default_timeout_s: float = 120.0):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.service = service
        self.max_inflight = int(max_inflight)
        self.default_timeout_s = float(default_timeout_s)
        self._lock = threading.Lock()
        self._inflight = 0
        self.accepted = 0               # queries admitted past the gate
        self.shed = 0                   # queries rejected 429-style
        self.rpc_errors = 0             # error frames sent (any kind)
        frontend = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:  # one thread per connection
                sock = self.request
                while True:
                    try:
                        req = recv_frame(sock)
                    except (ValueError, OSError, json.JSONDecodeError):
                        break
                    if req is None:
                        break
                    try:
                        send_frame(sock, frontend._handle(req))
                    except OSError:
                        break

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Server((host, port), _Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="serve-frontend")
        self._thread.start()

    @property
    def address(self) -> Tuple[str, int]:
        """The bound ``(host, port)``."""
        return self._server.server_address

    def close(self) -> None:
        """Stop accepting connections and join the listener thread (the
        wrapped service is NOT closed — it may outlive the front-end)."""
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10.0)

    def __enter__(self) -> "ServeFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request handling ---------------------------------------------------

    def _handle(self, req: Dict) -> Dict:
        op = req.get("op", "query")
        if op == "health":
            return self._health()
        if op == "stats":
            return {"ok": True, "stats": _jsonable(self.service.stats())}
        if op == "query":
            return self._query(req)
        with self._lock:
            self.rpc_errors += 1
        return {"ok": False, "error": error_payload(
            InvalidQuery(f"unknown op {op!r}"))}

    def _health(self) -> Dict:
        """Readiness + the failure-semantics counters, oracle-free: what
        a load balancer polls to spot a degraded or dead replica."""
        st = self.service.stats()
        ready = not self.service.batcher._closed
        with self._lock:
            inflight, shed = self._inflight, self.shed
        return {"ok": True, "ready": ready,
                "breaker": st["breaker"]["state"],
                "tiers": _jsonable(st["tiers"]),
                "tier_us_per_query": _jsonable(st["tier_us_per_query"]),
                "fallback_rate": st["fallback_rate"],
                "retries": st["retries"], "timeouts": st["timeouts"],
                "deadline_misses": st["deadline_misses"],
                "worker_restarts": st["worker_restarts"],
                "inflight": inflight, "shed": shed,
                "max_inflight": self.max_inflight}

    def _query(self, req: Dict) -> Dict:
        with self._lock:
            if self._inflight >= self.max_inflight:
                self.shed += 1
                self.rpc_errors += 1
                return {"ok": False, "error": error_payload(Overloaded(
                    f"{self._inflight} queries in flight "
                    f"(max_inflight={self.max_inflight})",
                    max_inflight=self.max_inflight))}
            self._inflight += 1
            self.accepted += 1
        try:
            deadline_ms = req.get("deadline_ms")
            deadline_s = None if deadline_ms is None \
                else float(deadline_ms) / 1e3
            try:
                q = Query.from_payload(req)
            except (KeyError, ValueError, TypeError) as e:
                raise InvalidQuery(str(e)) from e
            try:
                ans = self.service.query(
                    q, timeout=self.default_timeout_s, deadline_s=deadline_s)
            except (KeyError, ValueError) as e:
                # service-side validation (unknown workload/arch/knob,
                # out-of-range override) — not retryable
                raise InvalidQuery(str(e)) from e
            return {"ok": True, "answer": ans.to_payload()}
        except BaseException as e:      # noqa: BLE001 — every failure framed
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            with self._lock:
                self.rpc_errors += 1
            return {"ok": False, "error": error_payload(e)}
        finally:
            with self._lock:
                self._inflight -= 1


class ServeClient:
    """Blocking client for :class:`ServeFrontend` (one socket, many
    requests).  Query failures raise the matching
    :class:`~repro.serve.errors.ServeError` subclass reconstructed from
    the error frame — ``Overloaded`` means back off and retry,
    ``InvalidQuery`` means don't."""

    def __init__(self, address: Tuple[str, int],
                 connect_timeout_s: float = 10.0,
                 io_timeout_s: float = 300.0):
        self._sock = socket.create_connection(address,
                                              timeout=connect_timeout_s)
        self._sock.settimeout(io_timeout_s)
        self._lock = threading.Lock()

    def _call(self, req: Dict) -> Dict:
        with self._lock:
            send_frame(self._sock, req)
            resp = recv_frame(self._sock)
        if resp is None:
            raise ConnectionError("server closed the connection")
        return resp

    def query(self, query: Optional[Query] = None,
              deadline_ms: Optional[float] = None, **kwargs) -> Answer:
        """Ask one question (a :class:`Query` or ``Query.make`` kwargs);
        returns the :class:`Answer` or raises the structured error."""
        q = query if query is not None else Query.make(**kwargs)
        req = {"op": "query", **q.to_payload()}
        if deadline_ms is not None:
            req["deadline_ms"] = float(deadline_ms)
        resp = self._call(req)
        if not resp.get("ok"):
            raise error_from_payload(resp.get("error") or {})
        return Answer.from_payload(resp["answer"])

    def health(self) -> Dict:
        """The readiness/health probe payload."""
        return self._call({"op": "health"})

    def stats(self) -> Dict:
        """The full (JSON-sanitized) ``DSEService.stats()`` payload."""
        return self._call({"op": "stats"})["stats"]

    def close(self) -> None:
        """Close the client's socket (idempotent)."""
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
