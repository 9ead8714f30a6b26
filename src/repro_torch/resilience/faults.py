"""Seeded, deterministic fault injection — the chaos half of resilience.

Call sites *opt in* by naming themselves: ``maybe_fault("engine_launch")``
before a launch, ``data = maybe_corrupt("chunk_read", data)`` on a byte
payload. When no plan is armed both helpers are a single global ``None``
check — the production hot path pays one pointer compare, no locks, no
allocation. When a plan is armed, each hit increments a per-site invocation
counter under the plan's lock and fires whatever :class:`FaultSpec`\\ s cover
that invocation index:

``transient``   raise :class:`TransientFault` for ``times`` invocations
                (starting at ``after``), then let calls through — the shape
                a retry policy must absorb.
``persistent``  raise :class:`PersistentFault` from ``after`` on, forever —
                the shape that must trip a circuit breaker.
``latency``     ``time.sleep(delay_s)`` for ``times`` invocations — slow
                I/O without failure; results must stay correct.
``corrupt``     flip one seeded-random byte of the payload passed to
                :func:`maybe_corrupt` for ``times`` invocations — on-disk
                rot as seen by a reader; checksums must catch it.

Everything the plan fires is recorded in ``plan.fired`` as
``(site, kind, invocation_index)`` so tests assert exactly which faults
landed. The byte offsets corruption picks come from ``random.Random(seed)``
— the same plan replays the same chaos.

Arming is process-global (``arm`` / ``disarm`` / the ``armed`` context
manager) because the sites that matter run on background threads (the
batcher, prefetchers) that must see the plan without plumbing.
"""
from __future__ import annotations

import contextlib
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

KINDS = ("transient", "persistent", "latency", "corrupt")


class TransientFault(RuntimeError):
    """An injected failure that goes away if you try again."""


class PersistentFault(RuntimeError):
    """An injected failure that never goes away."""


@dataclass
class FaultSpec:
    """One fault at one site: fire ``times`` invocations starting at
    invocation ``after`` (0-based, per-site counter)."""
    site: str
    kind: str
    times: int = 1
    after: int = 0
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; have {KINDS}")
        if self.times < 1:
            raise ValueError(f"times={self.times} must be >= 1")
        if self.after < 0:
            raise ValueError(f"after={self.after} must be >= 0")
        if self.delay_s < 0:
            raise ValueError(f"delay_s={self.delay_s} must be >= 0")

    def covers(self, i: int) -> bool:
        if i < self.after:
            return False
        return self.kind == "persistent" or i < self.after + self.times


class FaultPlan:
    """A deterministic schedule of faults across named sites."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._specs: Dict[str, List[FaultSpec]] = {}
        self._counts: Dict[str, int] = {}
        self.fired: List[Tuple[str, str, int]] = []

    def on(self, site: str, kind: str, times: int = 1, after: int = 0,
           delay_s: float = 0.0) -> "FaultPlan":
        """Add a fault; chainable. Multiple specs may share a site."""
        spec = FaultSpec(site, kind, times=times, after=after,
                         delay_s=delay_s)
        with self._lock:
            self._specs.setdefault(site, []).append(spec)
        return self

    def fired_at(self, site: str) -> List[Tuple[str, int]]:
        """The (kind, invocation) pairs that landed at ``site``."""
        with self._lock:
            return [(k, i) for s, k, i in self.fired if s == site]

    def calls(self, site: str) -> int:
        """How many times ``site`` was hit (faulted or not)."""
        with self._lock:
            return self._counts.get(site, 0)

    # --- the two call-site entry points (via maybe_fault / maybe_corrupt) ----

    def hit(self, site: str):
        """Count one invocation of ``site``; sleep and/or raise per plan."""
        with self._lock:
            i = self._counts.get(site, 0)
            self._counts[site] = i + 1
            active = [s for s in self._specs.get(site, ())
                      if s.kind != "corrupt" and s.covers(i)]
            for s in active:
                self.fired.append((site, s.kind, i))
        delay = sum(s.delay_s for s in active if s.kind == "latency")
        if delay:
            time.sleep(delay)
        for s in active:
            if s.kind == "transient":
                raise TransientFault(
                    f"injected transient fault at {site!r} (invocation {i})")
            if s.kind == "persistent":
                raise PersistentFault(
                    f"injected persistent fault at {site!r} (invocation {i})")

    def corrupt(self, site: str, data: bytes) -> bytes:
        """Count one payload passing ``site``; flip one seeded byte when a
        corrupt spec covers this invocation."""
        with self._lock:
            i = self._counts.get(site, 0)
            self._counts[site] = i + 1
            active = [s for s in self._specs.get(site, ())
                      if s.kind == "corrupt" and s.covers(i)]
            if not active or not data:
                return data
            self.fired.append((site, "corrupt", i))
            pos = self._rng.randrange(len(data))
        out = bytearray(data)
        out[pos] ^= 0xFF
        return bytes(out)

    # --- CLI spec parsing -----------------------------------------------------

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """Build a plan from ``site:kind[:times[:delay_s]]`` specs, comma
        separated — the ``--chaos`` CLI syntax.

            engine_launch:transient:2,chunk_load:latency:3:0.02
        """
        plan = cls(seed=seed)
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            if len(bits) < 2 or len(bits) > 4:
                raise ValueError(
                    f"bad fault spec {part!r}: want site:kind[:times[:delay]]")
            site, kind = bits[0], bits[1]
            times = int(bits[2]) if len(bits) > 2 else 1
            delay = float(bits[3]) if len(bits) > 3 else 0.0
            plan.on(site, kind, times=times, delay_s=delay)
        return plan


# --- the process-global arming point -----------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def arm(plan: FaultPlan):
    """Arm ``plan`` process-wide (background threads included)."""
    global _ACTIVE
    _ACTIVE = plan


def disarm():
    global _ACTIVE
    _ACTIVE = None


@contextlib.contextmanager
def armed(plan: FaultPlan):
    arm(plan)
    try:
        yield plan
    finally:
        disarm()


def maybe_fault(site: str):
    """Zero-overhead chaos hook: no-op unless a plan is armed."""
    p = _ACTIVE
    if p is not None:
        p.hit(site)


def maybe_corrupt(site: str, data: bytes) -> bytes:
    """Pass ``data`` through the armed plan's corruption schedule (no-op,
    zero-copy when nothing is armed)."""
    p = _ACTIVE
    if p is None:
        return data
    return p.corrupt(site, data)
