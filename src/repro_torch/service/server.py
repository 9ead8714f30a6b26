"""WhatIfServer — the persistent what-if serving loop.

Owns one pre-compiled trace stack, one warm fleet geometry of
``max_lanes`` lanes, a micro-batcher, and (optionally) a fork-point store.
Callers ``submit()`` :class:`WhatIfQuery` tickets; compatible strangers are
coalesced into one lane-batched launch, incompatible ones run in separate
launches of the *same* geometry (lane count is always padded to
``max_lanes``, so every batch has one (B, W) shape).

Equivalence contract (tested): a served query's frame equals the lane of a
direct ``ScenarioFleet.from_precompiled`` run of the same specs and B under
the same config — bitwise, including fork-point continuations — because
the server replays the WindowedDriver schedule exactly: same
``batch_windows`` chunking, chunk seeds ``query.seed +
absolute_start_window``, the same incremental-accounting resync cadence
(re-phased for fork starts via ``restored_resync_phase``), the fleet's
switchless dispatch (the static lane assignment is computed on the host),
and ``has_storm=True`` (a bitwise no-op at ``storm_frac == 0``). Compare
runs at equal ``cfg.stats_stride`` — mean report columns are means over the
decimated sample.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.config import SimConfig
from repro_torch.core.pipeline import restored_resync_phase
from repro_torch.core.precompile import (StackCorruptionError, replay_config,
                                         stack_n_windows)
from repro_torch.core.state import SimState
from repro_torch.device import resolve_device
from repro_torch.resilience.faults import maybe_fault
from repro_torch.resilience.policy import BreakerPolicy, RetryPolicy
from repro_torch.scenarios import batch as batch_mod
from repro_torch.scenarios.report import scenario_report
from repro_torch.scenarios.spec import ScenarioSpec, build_knobs_for_table
from repro_torch.sched import SCHEDULERS, snapshot_dispatch
from repro_torch.service.batcher import MicroBatcher, Ticket
from repro_torch.service.engine_cache import EngineCache
from repro_torch.service.forkpoint import ForkPointStore, build_fork_points
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.service.protocol import (ErrorCode, ServingError, WhatIfQuery,
                                          WhatIfResult)
from repro_torch.trace import span


class WhatIfServer:
    """On the card unless ``device="cpu"`` is passed."""

    def __init__(self, cfg: SimConfig, replay_path: str,
                 schedulers: Sequence[str] = ("greedy",),
                 max_lanes: int = 8, max_wait_s: float = 0.05,
                 batch_windows: int = 32, seed: int = 0,
                 window_cache_chunks: int = 16,
                 max_fork_points: Optional[int] = None,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[BreakerPolicy] = None,
                 max_pending: Optional[int] = None,
                 verify_chunks: bool = False, device=None):
        # retry/breaker config is validated NOW (their __post_init__ raises
        # on max_retries < 0 etc.) — a bad policy fails server construction,
        # not the first degraded query
        self.retry = retry if retry is not None else RetryPolicy()
        self.breaker_policy = breaker if breaker is not None \
            else BreakerPolicy()
        self.device = resolve_device(device)
        # the stack's embedded geometry wins, exactly like `whatif --replay`
        self.cfg = replay_config(replay_path, cfg)
        self.replay_path = replay_path
        unknown = sorted(set(schedulers) - set(SCHEDULERS))
        if unknown:
            raise ValueError(f"unknown schedulers {unknown}; "
                             f"have {list(SCHEDULERS)}")
        if not schedulers:
            raise ValueError("need at least one scheduler in the table")
        self.scheduler_names: Tuple[str, ...] = tuple(schedulers)
        # the dispatch contract, frozen now as a fleet freezes its own
        self.dispatch_table = snapshot_dispatch(self.scheduler_names)
        if self.cfg.stats_stride > 1:    # mirror WindowedDriver's rounding
            k = self.cfg.stats_stride
            batch_windows = ((batch_windows + k - 1) // k) * k
        self.batch_windows = batch_windows
        self.max_lanes = max_lanes
        self.seed = seed
        self.n_stack_windows = stack_n_windows(replay_path)
        self.engines = EngineCache(self.cfg, window_cache_chunks,
                                   verify_chunks=verify_chunks,
                                   device=self.device)
        # bounded: a long-lived trunk with refresh-on-advance must not pin
        # (B, ...) device snapshots forever
        self.forks = ForkPointStore(max_points=max_fork_points)
        self._fork_seed: Optional[int] = None
        self.metrics = ServiceMetrics()
        self._batcher = MicroBatcher(self._execute, max_lanes=max_lanes,
                                     max_wait_s=max_wait_s,
                                     metrics=self.metrics,
                                     max_pending=max_pending)
        self._started = False

    # --- lifecycle -----------------------------------------------------------

    def start(self, warm: bool = True) -> "WhatIfServer":
        """Start the batcher thread; by default also pay the first launch's
        fixed costs now (one throwaway launch) so the first query is served
        warm."""
        self._batcher.start()
        self._started = True
        if warm:
            self.engines.warm(self.max_lanes, self.batch_windows,
                              self.scheduler_names)
        return self

    def stop(self, drain: bool = True):
        self._batcher.stop(drain=drain)
        self._started = False

    def __enter__(self) -> "WhatIfServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # --- fork points ---------------------------------------------------------

    def build_fork_points(self, specs: Sequence[ScenarioSpec], every: int,
                          n_windows: Optional[int] = None) -> List[int]:
        """Run the fork trunk: simulate ``specs`` from window 0 over the
        stack (or its first ``n_windows``), snapshotting every ``every``
        windows (must be a multiple of ``batch_windows``). Queries may then
        start at any returned window, provided their spec matches a trunk
        lane and their seed matches the server seed. Returns the windows."""
        from repro_torch.scenarios.runner import ScenarioFleet
        fleet = ScenarioFleet.from_precompiled(
            self.cfg, self.replay_path, specs,
            batch_windows=self.batch_windows, seed=self.seed,
            n_windows=n_windows, device=self.device)
        build_fork_points(fleet, every, self.forks)
        self._fork_seed = self.seed
        return self.forks.windows

    # --- query path ----------------------------------------------------------

    def submit(self, query: WhatIfQuery) -> Ticket:
        """Enqueue a query; returns a Ticket (``.wait()`` for the result).
        Invalid queries come back as an already-finished error ticket
        instead of poisoning a whole micro-batch."""
        if not self._started:
            raise RuntimeError("server not started")
        err = self._validate(query)
        if err is not None:
            t = Ticket(query, self.metrics)
            self.metrics.on_submit()
            t.finish(self._error_result(query, err))
            return t
        return self._batcher.submit(query)

    def query(self, query: WhatIfQuery,
              timeout: Optional[float] = None) -> WhatIfResult:
        """Blocking submit + wait."""
        return self.submit(query).wait(timeout)

    def _validate(self, q: WhatIfQuery) -> Optional[str]:
        if q.deadline_s is not None and q.deadline_s <= 0:
            return (f"deadline_s={q.deadline_s} must be > 0 — a non-positive "
                    f"deadline can never be met")
        if q.spec.scheduler not in self.scheduler_names:
            return (f"scheduler {q.spec.scheduler!r} not in the serving "
                    f"table {list(self.scheduler_names)}")
        if q.spec.arrival_rate > 1.0 and not self.cfg.inject_slots:
            return ("arrival_rate > 1 needs an injection slot pool, but the "
                    "stack was packed with inject_slots == 0")
        if q.start_window + q.n_windows > self.n_stack_windows:
            return (f"window range [{q.start_window}, "
                    f"{q.start_window + q.n_windows}) outside the stack's "
                    f"[0, {self.n_stack_windows})")
        if q.start_window:
            if q.start_window not in self.forks.windows:
                return (f"no fork point at window {q.start_window}; "
                        f"have {self.forks.windows}")
            if q.seed != self._fork_seed:
                return (f"fork-point queries must use the trunk seed "
                        f"{self._fork_seed}, got {q.seed}")
            try:
                self.forks.lane_for(q.start_window, q.spec)
            except KeyError as e:
                return str(e)
        return None

    @staticmethod
    def _error_result(q: WhatIfQuery, err: str) -> WhatIfResult:
        return WhatIfResult(name=q.spec.name, scheduler=q.spec.scheduler,
                            start_window=q.start_window,
                            n_windows=q.n_windows, row={}, error=err,
                            code=ErrorCode.INVALID)

    # --- executor (batcher thread) -------------------------------------------

    def _program_key(self) -> Tuple:
        """The warmed geometry this server launches (one)."""
        return (self.max_lanes, self.batch_windows, self.scheduler_names,
                True)

    def _on_breaker(self, event: str):
        self.metrics.on_breaker(event)
        if event == "open":
            # a program that failed k consecutive launches is treated as
            # poisoned: evict its warm entry
            self.engines.evict(self._program_key())

    def _execute(self, tickets: List[Ticket]):
        """Launch a micro-batch with retries and a circuit breaker.

        A failed attempt relaunches the *whole* batch from scratch — every
        input (template state, fork snapshots, cached window chunks) is
        read, never written, so pure relaunch is safe. Transient launch
        failures are absorbed by exponential backoff with seeded jitter;
        exhaustion feeds the per-program circuit breaker, which fails
        subsequent batches fast (typed BREAKER_OPEN) until a half-open
        probe succeeds. Checksum failures are never retried — re-reading
        corrupt bytes cannot fix them.

        The breaker hears of a success before any ticket of the batch is
        finished, so a caller that reads ``stats()`` as soon as its query
        returns sees the breaker's close counted (the reference finishes
        the tickets first).
        """
        key = self._program_key()
        breaker = self.engines.breaker(key, self.breaker_policy,
                                       on_transition=self._on_breaker)
        if not breaker.allow():
            raise ServingError(
                ErrorCode.BREAKER_OPEN,
                f"circuit breaker open for the serving program (retry in "
                f"{breaker.retry_after_s():.2f}s)")
        delays = self.retry.delays()
        attempt = 1
        while True:
            try:
                results = self._run_batch(tickets)
            except StackCorruptionError as e:
                self.metrics.on_checksum_failure()
                breaker.on_failure()
                raise ServingError(ErrorCode.CHECKSUM_FAILURE, str(e)) from e
            except ServingError:
                raise
            except Exception as e:             # noqa: BLE001 — retry scope
                self.metrics.on_launch_failure()
                delay = next(delays, None)
                if delay is None:
                    breaker.on_failure()
                    raise ServingError(
                        ErrorCode.EXECUTOR_ERROR,
                        f"launch failed on all {attempt} attempts "
                        f"({self.retry.max_retries} retries): "
                        f"{type(e).__name__}: {e}") from e
                self.metrics.on_retry()
                attempt += 1
                time.sleep(delay)
                continue
            breaker.on_success()
            for t, r in zip(tickets, results):
                t.finish(r)
            return

    def _device_scope(self):
        return (torch.cuda.device(self.device)
                if self.device.type == "cuda" else contextlib.nullcontext())

    def _start_state(self, queries: List[WhatIfQuery], S: int) -> SimState:
        """The batch's (max_lanes, ...) start state: fresh lanes from
        window 0, else the fork lanes the queries continue, padded with
        fresh lanes."""
        B, live = self.max_lanes, len(queries)
        if S == 0:
            return self.engines.fresh_lanes(B)
        lanes = [self.forks.lane_for(S, q.spec) for q in queries]
        state = self.forks.lane_state(S, lanes)
        if live < B:
            pad = self.engines.fresh_lanes(B - live)
            state = SimState(*[torch.cat([a, b], 0)
                               for a, b in zip(state, pad)])
        return state

    def _run_batch(self, tickets: List[Ticket]) -> List[WhatIfResult]:
        """Simulate one micro-batch; returns its tickets' results."""
        queries = [t.query for t in tickets]
        S, N, seed = queries[0].batch_key()
        live = len(queries)
        B = self.max_lanes
        lane_specs = [q.spec for q in queries]
        # pad to the lane count with inert identity lanes (results
        # discarded — lanes are independent)
        lane_specs += [ScenarioSpec(name=f"_pad{i}",
                                    scheduler=self.scheduler_names[0])
                       for i in range(B - live)]
        # the static lane assignment, from the host's specs (as the fleet
        # computes it), so the launch takes the fleet's dispatch and never
        # reads the knobs back
        lane_scheds = tuple(self.scheduler_names.index(s.scheduler)
                            for s in lane_specs)
        resync_every = (self.cfg.resync_windows
                        if self.cfg.incremental_accounting else 0)
        since = restored_resync_phase(S, self.batch_windows, resync_every)
        with self._device_scope():
            with span("agocs.service.start_state"):
                knobs = build_knobs_for_table(lane_specs,
                                              self.scheduler_names,
                                              self.device)
                state = self._start_state(queries, S)
            rows: List[Dict[str, torch.Tensor]] = []
            lo = S
            while lo < S + N:
                hi = min(S + N, lo + self.batch_windows)
                with span("agocs.service.chunk"):
                    windows = self.engines.window_chunk(self.replay_path, lo,
                                                        hi)
                maybe_fault("engine_launch")   # chaos: transient launch fail
                state, stats = batch_mod.run_scenarios(
                    state, windows, knobs, self.cfg, self.scheduler_names,
                    seed + lo, has_storm=True, table=self.dispatch_table,
                    lane_scheds=lane_scheds)
                rows.append(stats)
                if resync_every:
                    since += hi - lo
                    if since >= resync_every:
                        state = batch_mod.resync_fleet(state, self.cfg)
                        since = 0
                lo = hi
            with span("agocs.service.collect"):
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
                del state
                frame = {k: torch.cat([r[k] for r in rows]).cpu().numpy()
                         for k in rows[0]}

        self.metrics.on_batch(live, B - live, N)
        results = []
        with span("agocs.service.report"):
            for i, q in enumerate(queries):
                lane = {k: v[:, i:i + 1] for k, v in frame.items()}
                rep = scenario_report([q.spec.name], lane, [q.spec.scheduler])
                results.append(WhatIfResult(
                    name=q.spec.name, scheduler=q.spec.scheduler,
                    start_window=S, n_windows=N,
                    row=rep["scenarios"][0],
                    curves=rep["curves"] if q.include_curves else None,
                    frame={k: v[:, i].copy() for k, v in frame.items()},
                    batch_lanes=live, batch_size=B))
        return results

    # --- telemetry -----------------------------------------------------------

    def stats(self) -> Dict:
        out = self.metrics.snapshot()
        out["window_cache"] = self.engines.cache_stats()
        out["fork_windows"] = self.forks.windows
        out["compiled_programs"] = len(self.engines.warmed)
        return out
