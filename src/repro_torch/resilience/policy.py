"""Retry and circuit-breaker policies — the hardening the chaos harness
proves out.

:class:`RetryPolicy` is a frozen, eagerly-validated description of an
exponential-backoff-with-jitter schedule. The jitter is *seeded* (each
``delays()`` call replays the same sequence), so a retried serving run is as
reproducible as everything else in this repo — determinism is a feature, not
a bug, in a simulator's serving path.

:class:`CircuitBreaker` is the classic CLOSED → OPEN → HALF_OPEN machine:
``failure_threshold`` *consecutive* failures open it; while open, ``allow()``
fails fast (no load on a known-bad dependency) until ``reset_timeout_s`` has
passed, after which exactly one probe call is let through (HALF_OPEN). The
probe's success closes the breaker; its failure re-opens it and re-arms the
timer. Transitions are surfaced through ``on_transition(event)`` so the
owner can count them (ServiceMetrics) and evict poisoned cache entries
(EngineCache drops the compiled-program key on ``open`` — the "evict and
recompile" contract).

Thread-safe; the clock is injectable for tests.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with seeded jitter. ``max_retries=0`` disables
    retries while keeping the call path uniform."""
    max_retries: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter_frac: float = 0.5        # each delay scaled by 1 - U[0, jitter)
    seed: int = 0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries={self.max_retries} must be >= 0")
        if self.base_delay_s < 0:
            raise ValueError(f"base_delay_s={self.base_delay_s} must be >= 0")
        if self.max_delay_s < self.base_delay_s:
            raise ValueError(f"max_delay_s={self.max_delay_s} must be >= "
                             f"base_delay_s={self.base_delay_s}")
        if not 0.0 <= self.jitter_frac <= 1.0:
            raise ValueError(f"jitter_frac={self.jitter_frac} outside [0, 1]")

    def delays(self) -> Iterator[float]:
        """The backoff schedule: ``max_retries`` sleeps, deterministic for a
        given policy (fresh seeded RNG per call)."""
        rng = random.Random(self.seed)
        for k in range(self.max_retries):
            d = min(self.max_delay_s, self.base_delay_s * (2.0 ** k))
            yield d * (1.0 - self.jitter_frac * rng.random())


@dataclass(frozen=True)
class BreakerPolicy:
    """When to open and when to probe."""
    failure_threshold: int = 3      # consecutive failures that open it
    reset_timeout_s: float = 5.0    # open -> half-open probe delay

    def __post_init__(self):
        if self.failure_threshold < 1:
            raise ValueError(
                f"failure_threshold={self.failure_threshold} must be >= 1")
        if self.reset_timeout_s <= 0:
            raise ValueError(
                f"reset_timeout_s={self.reset_timeout_s} must be > 0")


class CircuitBreaker:

    def __init__(self, policy: BreakerPolicy = BreakerPolicy(),
                 on_transition: Optional[Callable[[str], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy
        self._on_transition = on_transition
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0              # consecutive
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, state: str, event: str):
        # called with the lock held; the callback runs outside it
        self._state = state
        cb = self._on_transition
        if cb is not None:
            self._lock.release()
            try:
                cb(event)
            finally:
                self._lock.acquire()

    def allow(self) -> bool:
        """May a call proceed right now? OPEN fails fast until the reset
        timeout, then exactly one HALF_OPEN probe goes through."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at < \
                        self.policy.reset_timeout_s:
                    return False
                self._transition(HALF_OPEN, "probe")
                self._probing = True
                return True
            # HALF_OPEN: the probe is in flight; hold everyone else
            if self._probing:
                return False
            self._probing = True
            return True

    def on_success(self):
        with self._lock:
            self._failures = 0
            self._probing = False
            if self._state != CLOSED:
                self._transition(CLOSED, "close")

    def on_failure(self):
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._state == OPEN:              # late failure: re-arm timer
                self._opened_at = self._clock()
            elif self._state == HALF_OPEN or \
                    self._failures >= self.policy.failure_threshold:
                self._opened_at = self._clock()
                self._transition(OPEN, "open")

    def retry_after_s(self) -> float:
        """Seconds until an OPEN breaker will admit a probe (0 otherwise)."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self.policy.reset_timeout_s
                       - (self._clock() - self._opened_at))
