"""Serving telemetry: counters + a latency reservoir, lock-guarded.

One :class:`ServiceMetrics` instance is shared by the server's submit path,
the batcher thread and the executor; ``snapshot()`` is the single read
point (CLI ``--metrics`` printout, benchmark JSON, tests). Percentiles come
from a bounded reservoir of recent query latencies, so a long-lived server
doesn't grow a per-query list without bound.

Failure and recovery events are first-class: every failed result is counted
*per ErrorCode* (``errors_by_code``), and the resilience machinery reports
retries, launch failures, breaker transitions, shed/cancelled/deadline-missed
tickets, checksum failures and batcher restarts — so a degraded server is
visible in one ``snapshot()``, not just in its logs.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional


class ServiceMetrics:

    def __init__(self, reservoir: int = 4096):
        self._lock = threading.Lock()
        self._reservoir = reservoir
        self._lat: List[float] = []        # recent total query latencies (s)
        self._t0 = time.time()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.batches = 0
        self.lanes = 0                     # live lanes launched
        self.padded_lanes = 0              # inert padding lanes launched
        self.lane_windows = 0              # live lanes x windows simulated
        self.queue_depth = 0               # gauge: tickets waiting or running
        self.waiting_at_launch = 0         # sum over launches of the tickets
        #                                    left waiting when each launched
        # --- resilience ------------------------------------------------------
        self.errors_by_code: Dict[str, int] = {}
        self.retries = 0                   # relaunch attempts after a failure
        self.launch_failures = 0           # launches that raised (pre-retry)
        self.shed = 0                      # bounded-queue load shedding
        self.cancelled = 0                 # waiter gave up before dispatch
        self.deadline_missed = 0           # expired before launch
        self.checksum_failures = 0         # corrupt chunk / snapshot caught
        self.batcher_restarts = 0          # supervised thread resurrections
        self.breaker_opens = 0
        self.breaker_probes = 0
        self.breaker_closes = 0

    def on_submit(self):
        with self._lock:
            self.submitted += 1
            self.queue_depth += 1

    def on_batch(self, live: int, padded: int, n_windows: int):
        with self._lock:
            self.batches += 1
            self.lanes += live
            self.padded_lanes += padded
            self.lane_windows += live * n_windows

    def on_launch(self, waiting: int):
        """A batch launched, leaving ``waiting`` tickets waiting."""
        with self._lock:
            self.waiting_at_launch += waiting

    def on_done(self, latency_s: float, ok: bool,
                code: Optional[str] = None):
        with self._lock:
            if ok:
                self.completed += 1
            else:
                self.failed += 1
                key = code or "UNKNOWN"
                self.errors_by_code[key] = self.errors_by_code.get(key, 0) + 1
            self.queue_depth = max(0, self.queue_depth - 1)
            self._lat.append(latency_s)
            if len(self._lat) > self._reservoir:
                del self._lat[:len(self._lat) - self._reservoir]

    # --- resilience events ---------------------------------------------------

    def on_retry(self):
        with self._lock:
            self.retries += 1

    def on_launch_failure(self):
        with self._lock:
            self.launch_failures += 1

    def on_shed(self):
        with self._lock:
            self.shed += 1

    def on_cancelled(self):
        with self._lock:
            self.cancelled += 1

    def on_deadline_missed(self):
        with self._lock:
            self.deadline_missed += 1

    def on_checksum_failure(self):
        with self._lock:
            self.checksum_failures += 1

    def on_batcher_restart(self):
        with self._lock:
            self.batcher_restarts += 1

    def on_breaker(self, event: str):
        """``event`` is a CircuitBreaker transition: open | probe | close."""
        with self._lock:
            if event == "open":
                self.breaker_opens += 1
            elif event == "probe":
                self.breaker_probes += 1
            elif event == "close":
                self.breaker_closes += 1

    @staticmethod
    def _pct(sorted_vals: List[float], q: float) -> float:
        if not sorted_vals:
            return 0.0
        i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
        return sorted_vals[i]

    def snapshot(self) -> Dict:
        """Consistent copy of every counter + derived rates/percentiles."""
        with self._lock:
            lat = sorted(self._lat)
            elapsed = max(1e-9, time.time() - self._t0)
            total_lanes = self.lanes + self.padded_lanes
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "batches": self.batches,
                "lanes": self.lanes,
                "padded_lanes": self.padded_lanes,
                "lane_windows": self.lane_windows,
                "queue_depth": self.queue_depth,
                "waiting_at_launch": self.waiting_at_launch,
                "uptime_s": elapsed,
                "lanes_per_s": self.lanes / elapsed,
                "lane_windows_per_s": self.lane_windows / elapsed,
                "mean_batch_occupancy": (self.lanes / total_lanes
                                         if total_lanes else 0.0),
                "latency_p50_s": self._pct(lat, 0.50),
                "latency_p90_s": self._pct(lat, 0.90),
                "latency_p99_s": self._pct(lat, 0.99),
                "latency_max_s": lat[-1] if lat else 0.0,
                "errors_by_code": dict(self.errors_by_code),
                "resilience": {
                    "retries": self.retries,
                    "launch_failures": self.launch_failures,
                    "shed": self.shed,
                    "cancelled": self.cancelled,
                    "deadline_missed": self.deadline_missed,
                    "checksum_failures": self.checksum_failures,
                    "batcher_restarts": self.batcher_restarts,
                    "breaker_opens": self.breaker_opens,
                    "breaker_probes": self.breaker_probes,
                    "breaker_closes": self.breaker_closes,
                },
            }
