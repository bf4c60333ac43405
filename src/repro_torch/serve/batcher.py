"""Bounded-window micro-batching for concurrent query streams.

Many clients submit items concurrently; one worker thread coalesces them
into *dispatches* — contiguous, arrival-ordered batches of at most
``max_batch`` items, closed early when the batch fills and at the latest
``window_s`` seconds after its first item arrived.  The dispatch callback
receives the whole batch and returns one result per item; results resolve
the per-item futures.

The batching CONTRACT the property tests pin down
(``tests/test_property.py``):

* every submitted item lands in exactly one dispatch (the dispatch log is
  a partition of the submission sequence — no drop, no dup);
* batches are contiguous in arrival order (the worker drains FIFO);
* per-item results never depend on batchmates (that part is the dispatch
  function's obligation — the service keeps per-query answers a pure
  function of the query, which is what makes micro-batching invisible).

``hold()`` freezes batch formation (submissions queue up but nothing
dispatches) so tests and benchmarks can stage exact window contents
instead of racing the wall clock.
"""

from __future__ import annotations

import atexit
import threading
import time
import weakref
from concurrent.futures import Future
from contextlib import contextmanager
from typing import Callable, List, Optional, Sequence, Tuple

__all__ = ["MicroBatcher", "plan_batches"]

# every live batcher, so interpreter shutdown can flush + join the worker
# threads of instances nobody explicitly closed (weak: a collected batcher
# needs no cleanup — its worker is a daemon and dies with the process)
_LIVE: "weakref.WeakSet[MicroBatcher]" = weakref.WeakSet()


def _close_all() -> None:
    """``atexit`` safety net: close every still-live batcher so no worker
    thread is left running user code while the interpreter tears down
    (unjoined workers racing module teardown raise spurious exceptions)."""
    for b in list(_LIVE):
        b.close(timeout=1.0)


atexit.register(_close_all)


def plan_batches(n: int, max_batch: int) -> List[Tuple[int, int]]:
    """Arrival-ordered batch boundaries for ``n`` pending items:
    ``[(start, end), ...]`` half-open index ranges, each at most
    ``max_batch`` long — the same greedy FIFO split the worker thread
    applies, exposed pure so the synchronous replay path
    (``DSEService.query_many``) provably coalesces identically."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    return [(s, min(s + max_batch, n)) for s in range(0, n, max_batch)]


class MicroBatcher:
    """One worker thread turning concurrent ``submit`` calls into bounded
    arrival-ordered dispatches (see the module docstring for the
    contract).  ``dispatch`` maps a list of items to a list of results of
    the same length; a result element that is itself an exception fails
    ONLY that item's future (per-item structured errors), while an
    exception raised by ``dispatch`` fails every future in the batch —
    and a non-``Exception`` ``BaseException`` (``KeyboardInterrupt``,
    ``SystemExit``, injected ``WorkerKill``) additionally re-raises after
    failing the futures, so the worker dies instead of swallowing it; the
    forwarded exception carries the window's items as ``batch_items``.
    ``dispatch_log`` records the sequence numbers of every batch, in
    dispatch order — the partition evidence tests assert on."""

    def __init__(self, dispatch: Callable[[List], List],
                 max_batch: int = 8, window_s: float = 0.002):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if window_s < 0:
            raise ValueError(f"window_s must be >= 0, got {window_s}")
        self._dispatch = dispatch
        self.max_batch = int(max_batch)
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: List[Tuple[int, object, Future,
                                  Optional[float]]] = []
        self._seq = 0
        self._held = 0
        self._in_flight = 0
        self._closed = False
        self.dispatch_log: List[List[int]] = []
        self.cancelled = 0              # futures cancelled before dispatch
        self.worker_restarts = 0        # respawns after a worker death
        self._dead = False              # worker announced its own death
        self._window_open = time.monotonic()
        self._worker = self._spawn_worker()
        _LIVE.add(self)

    def _spawn_worker(self) -> threading.Thread:
        worker = threading.Thread(target=self._run, daemon=True,
                                  name="microbatcher")
        worker.start()
        return worker

    def _ensure_worker(self) -> None:
        """Worker supervision (caller must hold the lock): a worker
        killed mid-dispatch by a ``BaseException`` (injected
        ``WorkerKill``, a stray ``SystemExit``) is respawned so the
        batcher keeps serving instead of stranding every later
        submission.  The worker flags ``_dead`` under the lock BEFORE it
        re-raises, so a submit racing its unwind (``is_alive()`` still
        true) respawns rather than enqueuing onto a corpse."""
        if not self._closed and (self._dead or not self._worker.is_alive()):
            self.worker_restarts += 1
            self._dead = False
            self._worker = self._spawn_worker()

    # -- client side --------------------------------------------------------

    def submit(self, item, deadline: Optional[float] = None) -> Future:
        """Enqueue one item; returns the future its result will resolve.
        ``deadline`` (absolute ``time.monotonic()`` seconds) closes the
        item's window no later than that instant — a tight per-query
        deadline shortens its window instead of waiting out
        ``window_s``."""
        fut: Future = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._ensure_worker()
            self._pending.append((self._seq, item, fut, deadline))
            self._seq += 1
            self._cond.notify_all()
        return fut

    @contextmanager
    def hold(self):
        """Freeze batch formation while the context is open: submissions
        accumulate into one window deterministically (tests/benchmarks
        stage exact batch contents instead of racing ``window_s``)."""
        with self._cond:
            self._held += 1
        try:
            yield self
        finally:
            with self._cond:
                self._held -= 1
                self._cond.notify_all()

    def drain(self, timeout: float = 30.0) -> None:
        """Block until every already-submitted item has been dispatched
        AND its future resolved (the dispatch log is complete up to the
        last pre-drain submission when this returns).  Purely
        event-driven: the waiter sleeps on the condition until the worker
        settles the last batch (``Condition.wait_for`` — no deadline
        polling loop burning a core under load)."""
        with self._cond:
            self._ensure_worker()
            done = self._cond.wait_for(
                lambda: not self._pending and not self._in_flight, timeout)
            if not done:
                raise TimeoutError("MicroBatcher.drain timed out")

    def close(self, timeout: Optional[float] = None) -> None:
        """Dispatch whatever is pending, then stop the worker thread.

        Idempotent — safe to call repeatedly, from ``atexit``, or while a
        ``hold()`` is open (closing overrides the hold so pending items
        still flush rather than deadlocking the worker).  ``timeout``
        bounds the join; ``None`` waits until the worker exits."""
        with self._cond:
            # a dead worker (BaseException mid-dispatch) with items still
            # queued gets one last respawn so close() flushes rather than
            # stranding those futures
            if self._pending:
                self._ensure_worker()
            self._closed = True
            self._cond.notify_all()
        if self._worker is not threading.current_thread():
            self._worker.join(timeout)
        _LIVE.discard(self)

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker side --------------------------------------------------------

    def _take_batch(self) -> List[Tuple[int, object, Future,
                                        Optional[float]]]:
        """Wait for a window to close, then pop the next FIFO batch: at
        most ``max_batch`` items, no earlier than ``window_s`` after the
        window's first item arrived — or the earliest per-item deadline
        in the forming batch, whichever comes first (unless the batch is
        already full, or the batcher is closing).  Items whose futures
        were cancelled while queued are dropped here, before dispatch."""
        with self._cond:
            while True:
                # reap cancel()ed futures: they must neither be dispatched
                # nor keep a window open waiting on them
                live = [p for p in self._pending if not p[2].cancelled()]
                if len(live) != len(self._pending):
                    self.cancelled += len(self._pending) - len(live)
                    self._pending[:] = live
                    if not live:
                        self._cond.notify_all()   # wake drain()
                # a close overrides any open hold(): pending items must
                # still flush or the worker (and its joiner) deadlocks
                if self._pending and (not self._held or self._closed):
                    deadline = self._window_open + self.window_s
                    for _, _, _, item_dl in self._pending[: self.max_batch]:
                        if item_dl is not None:
                            deadline = min(deadline, item_dl)
                    if (len(self._pending) >= self.max_batch
                            or self._closed
                            or time.monotonic() >= deadline):
                        batch = self._pending[: self.max_batch]
                        del self._pending[: len(batch)]
                        self._in_flight += 1
                        return batch
                    self._cond.wait(max(0.0, deadline - time.monotonic()))
                    continue
                if self._closed and not self._pending:
                    return []
                if self._pending and self._held:
                    self._cond.wait()
                else:
                    # idle: note when the NEXT window opens
                    self._cond.wait()
                    self._window_open = time.monotonic()

    @staticmethod
    def _resolve(fut: Future, res: object) -> None:
        """Settle one future defensively: a result that IS an exception
        fails the future (per-item structured errors from the dispatch
        function), and a future cancelled mid-dispatch is left alone
        (its submitter already walked away — the outcome is accounted,
        not crashed on)."""
        if fut.cancelled():
            return
        if isinstance(res, BaseException):
            fut.set_exception(res)
        else:
            fut.set_result(res)

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                return
            with self._cond:
                self._window_open = time.monotonic()
            items = [it for _, it, _, _ in batch]
            try:
                results = self._dispatch(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"dispatch returned {len(results)} results for "
                        f"{len(items)} items")
            except BaseException as e:  # noqa: BLE001 — forwarded, see below
                # diagnosability: the forwarded exception names exactly
                # which window died with it
                try:
                    e.batch_items = tuple(items)
                except Exception:       # __slots__ exceptions: best-effort
                    pass
                self.dispatch_log.append([seq for seq, *_ in batch])
                for _, _, fut, _ in batch:
                    self._resolve(fut, e)
                self._settle()
                if not isinstance(e, Exception):
                    # KeyboardInterrupt / SystemExit / injected WorkerKill:
                    # fail the batch's futures (no client may hang) but
                    # NEVER swallow a BaseException into them — re-raise
                    # so the worker dies loudly.  Items already queued
                    # behind the dead window would otherwise strand (no
                    # later submit to trigger supervision), so the dying
                    # worker spawns its own successor when work remains;
                    # an idle batcher stays dead until the next submit.
                    with self._cond:
                        self._dead = True
                        if self._pending and not self._closed:
                            self.worker_restarts += 1
                            self._dead = False
                            self._worker = self._spawn_worker()
                    raise
                continue
            self.dispatch_log.append([seq for seq, *_ in batch])
            for (_, _, fut, _), res in zip(batch, results):
                self._resolve(fut, res)
            self._settle()

    def _settle(self) -> None:
        with self._cond:
            self._in_flight -= 1
            if not self._pending and not self._in_flight:
                self._cond.notify_all()   # wake drain()
