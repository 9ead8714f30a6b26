"""Micro-batcher: coalesce stranger queries into one lane-batched launch.

Callers submit :class:`WhatIfQuery` tickets to a queue; a single batcher
thread drains it into per-``batch_key()`` buckets (queries can only share a
launch when their (start_window, n_windows, seed) agree — lanes are
independent, but the window stream and key schedule are shared).
A bucket launches when it holds ``max_lanes`` queries, or when its oldest
ticket has waited ``max_wait_s`` — so a lone query pays at most the wait
bound, and a burst of B strangers rides one compiled program.

The executor is injected (``execute_fn(tickets) -> None``, filling each
ticket's result) so the batcher is testable without a simulator behind it.
Execution happens on the batcher thread itself: one batch runs on the card
at a time, which is the right throughput shape for a single-card server.

Failure behaviour is engineered, not incidental:

* **Supervised thread.** The loop runs under a supervisor: a crash (bug or
  an armed ``batcher_loop`` fault) is counted, the thread state survives on
  ``self``, and the loop restarts — undispatched tickets stay in their
  buckets and are re-queued into the next dispatch pass, never lost.
* **Deadlines.** A ticket whose ``deadline_s`` expired before dispatch is
  shed with a typed DEADLINE_EXCEEDED result instead of burning a fleet
  lane on an answer nobody is waiting for.
* **Cancellation.** ``Ticket.wait(timeout)`` raising ``TimeoutError`` marks
  the ticket cancelled; the batcher skips it at dispatch (typed CANCELLED).
* **Bounded queue + priority lane.** With ``max_pending`` set, best-effort
  (priority 0) submissions beyond the bound are shed immediately (typed
  SHED); ``priority > 0`` queries bypass the bound and their buckets launch
  ahead of aged best-effort buckets — the seed of admission control beyond
  FIFO.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.resilience.faults import maybe_fault
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.service.protocol import (ErrorCode, WhatIfQuery,
                                          WhatIfResult)


class Ticket:
    """One in-flight query: the request, a completion event, the slot the
    executor writes the result into, and latency bookkeeping."""

    def __init__(self, query: WhatIfQuery,
                 metrics: Optional[ServiceMetrics] = None):
        self.query = query
        self.metrics = metrics
        self.done = threading.Event()
        self.result: Optional[WhatIfResult] = None
        self.t_submit = time.time()
        self.t_start = 0.0             # set when its batch launches
        self.cancelled = False         # waiter gave up; skip at dispatch

    def finish(self, result: WhatIfResult):
        now = time.time()
        result.queue_s = (self.t_start or now) - self.t_submit
        result.exec_s = now - (self.t_start or now)
        result.total_s = now - self.t_submit
        self.result = result
        # record BEFORE waking waiters, so a caller reading metrics right
        # after wait() returns always sees this query counted
        if self.metrics is not None:
            self.metrics.on_done(result.total_s, result.ok(), result.code)
        self.done.set()

    def fail(self, code: str, error: str):
        """Finish with a typed error result built from the query."""
        q = self.query
        self.finish(WhatIfResult(
            name=q.spec.name, scheduler=q.spec.scheduler,
            start_window=q.start_window, n_windows=q.n_windows,
            row={}, error=error, code=code))

    def expired(self, now: float) -> bool:
        d = self.query.deadline_s
        return d is not None and now - self.t_submit >= d

    def wait(self, timeout: Optional[float] = None) -> WhatIfResult:
        if not self.done.wait(timeout):
            # nobody will read the result: tell the batcher not to burn a
            # fleet lane on it (racing with a concurrent launch is fine —
            # the flag only matters while the ticket is still undispatched)
            self.cancelled = True
            raise TimeoutError(
                f"query {self.query.spec.name!r} still pending after "
                f"{timeout}s (ticket cancelled)")
        return self.result


class MicroBatcher:

    def __init__(self, execute_fn: Callable[[List[Ticket]], None],
                 max_lanes: int = 8, max_wait_s: float = 0.05,
                 metrics: Optional[ServiceMetrics] = None,
                 max_pending: Optional[int] = None,
                 max_restarts: int = 100):
        if max_lanes < 1:
            raise ValueError("max_lanes must be >= 1")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending={max_pending} must be >= 1")
        if max_restarts < 0:
            raise ValueError(f"max_restarts={max_restarts} must be >= 0")
        self._execute = execute_fn
        self.max_lanes = max_lanes
        self.max_wait_s = max_wait_s
        self.max_pending = max_pending
        self.max_restarts = max_restarts
        self.metrics = metrics or ServiceMetrics()
        self._q: "queue.Queue[Ticket]" = queue.Queue()
        self._buckets: Dict[tuple, List[Ticket]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pending_lock = threading.Lock()
        self._pending = 0              # submitted, not yet pulled for dispatch

    def start(self):
        if self._thread is not None:
            raise RuntimeError("batcher already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="whatif-batcher")
        self._thread.start()

    def stop(self, drain: bool = True):
        """Stop the batcher thread; with ``drain`` (default) every already
        submitted ticket is still executed before the thread exits."""
        if self._thread is None:
            return
        self._drain_on_stop = drain
        self._stop.set()
        self._q.put(None)              # wake the blocking get
        self._thread.join()
        self._thread = None

    def submit(self, query: WhatIfQuery) -> Ticket:
        if self._thread is None:
            raise RuntimeError("batcher not started")
        t = Ticket(query, self.metrics)
        self.metrics.on_submit()
        # bounded-queue load shedding: best-effort traffic beyond the bound
        # is rejected NOW with a typed result; the priority lane is exempt
        if self.max_pending is not None and query.priority == 0:
            with self._pending_lock:
                over = self._pending >= self.max_pending
                if not over:
                    self._pending += 1
            if over:
                self.metrics.on_shed()
                t.fail(ErrorCode.SHED,
                       f"queue full ({self.max_pending} pending); "
                       f"shed best-effort query {query.spec.name!r}")
                return t
        else:
            with self._pending_lock:
                self._pending += 1
        self._q.put(t)
        return t

    def pending(self) -> int:
        with self._pending_lock:
            return self._pending

    # --- batcher thread ------------------------------------------------------

    def _run(self):
        """Supervisor: restart the loop when it crashes (chaos fault or bug).
        State lives on ``self``, so undispatched tickets in ``_buckets`` and
        ``_q`` survive the crash and dispatch on the next pass."""
        restarts = 0
        while True:
            try:
                self._loop()
                return                             # clean stop() exit
            except Exception:                      # noqa: BLE001 — supervisor
                restarts += 1
                self.metrics.on_batcher_restart()
                if restarts > self.max_restarts:
                    self._fail_all_pending(
                        f"batcher crash-looped {restarts} times; giving up")
                    return
                time.sleep(min(0.5, 0.01 * restarts))   # crash-loop brake

    def _fail_all_pending(self, why: str):
        while True:
            try:
                t = self._q.get_nowait()
            except queue.Empty:
                break
            if t:
                self._buckets.setdefault(t.query.batch_key(), []).append(t)
        for ts in self._buckets.values():
            for t in ts:
                self._drop_pending(1)
                if not t.done.is_set():
                    t.fail(ErrorCode.EXECUTOR_ERROR, why)
        self._buckets.clear()

    def _drop_pending(self, n: int):
        with self._pending_lock:
            self._pending = max(0, self._pending - n)

    def _loop(self):
        while True:
            maybe_fault("batcher_loop")
            timeout = self._next_deadline()
            try:
                t = self._q.get(timeout=timeout)
            except queue.Empty:
                t = False                      # deadline tick, nothing new
            if t:
                self._buckets.setdefault(t.query.batch_key(), []).append(t)
            # launch every full bucket, then any bucket past its wait bound
            while self._launch_ready():
                pass
            if self._stop.is_set():
                if getattr(self, "_drain_on_stop", True):
                    while True:                # tickets raced in after stop
                        try:
                            t = self._q.get_nowait()
                        except queue.Empty:
                            break
                        if t:
                            self._buckets.setdefault(
                                t.query.batch_key(), []).append(t)
                    while self._launch_ready():
                        pass
                return

    def _next_deadline(self) -> Optional[float]:
        """Seconds until the oldest bucket ages out (None: queue is empty)."""
        if not self._buckets:
            return None
        oldest = min(ts[0].t_submit for ts in self._buckets.values())
        return max(0.0, oldest + self.max_wait_s - time.time())

    @staticmethod
    def _bucket_priority(ts: List[Ticket]) -> int:
        return max(t.query.priority for t in ts)

    def _launch_ready(self) -> bool:
        """Launch one bucket if any is full, or aged past max_wait_s, or the
        batcher is draining on stop. Full buckets go first; among aged ones
        the priority lane wins, then the oldest. Returns whether one was
        processed (launched, or entirely shed)."""
        now = time.time()
        pick = None
        for key, ts in self._buckets.items():
            if len(ts) >= self.max_lanes:
                pick = key
                break
            if self._stop.is_set() or now - ts[0].t_submit >= self.max_wait_s:
                if pick is None:
                    pick = key
                else:
                    best = self._buckets[pick]
                    cand = (-self._bucket_priority(ts), ts[0].t_submit)
                    incumbent = (-self._bucket_priority(best),
                                 best[0].t_submit)
                    if cand < incumbent:
                        pick = key
        if pick is None:
            return False
        ts = self._buckets.pop(pick)
        tickets, rest = ts[:self.max_lanes], ts[self.max_lanes:]
        if rest:                     # bucket overfilled between gets — requeue
            self._buckets[pick] = rest
        self._drop_pending(len(tickets))
        # dispatch-time shedding: cancelled or past-deadline tickets must not
        # leak a launched lane — nobody reads those results
        now = time.time()
        live: List[Ticket] = []
        for t in tickets:
            if t.done.is_set():
                continue
            if t.cancelled:
                self.metrics.on_cancelled()
                t.fail(ErrorCode.CANCELLED,
                       "caller stopped waiting before dispatch")
            elif t.expired(now):
                self.metrics.on_deadline_missed()
                t.fail(ErrorCode.DEADLINE_EXCEEDED,
                       f"deadline {t.query.deadline_s}s exceeded after "
                       f"{now - t.t_submit:.3f}s in queue")
            else:
                live.append(t)
        if not live:
            return True
        for t in live:
            t.t_start = time.time()
        try:
            self._execute(live)
        except Exception as e:              # noqa: BLE001 — server boundary
            code = getattr(e, "code", ErrorCode.EXECUTOR_ERROR)
            for t in live:
                if not t.done.is_set():
                    t.fail(code, f"{type(e).__name__}: {e}")
        for t in live:
            if not t.done.is_set():
                t.fail(ErrorCode.NO_RESULT,
                       "executor returned without a result")
        return True
