"""Request/response protocol of the what-if service.

A request is a :class:`WhatIfQuery` — one ScenarioSpec plus where in the
trace to start (window 0, or a registered fork-point window) and how many
windows to simulate. A response is a :class:`WhatIfResult` — the per-lane
comparative report row (same numbers a direct ``whatif`` CLI run of the
same spec produces), optional stats curves, and serving telemetry (queue /
execution latency, which batch the query rode in).

Both sides have JSON codecs (``encode_* / decode_*``) so the same protocol
serves an in-process queue today and a socket transport later; the
in-process server passes the dataclasses through untouched. Spec decoding
is schema-drift tolerant the same way snapshot configs are: unknown spec
fields from a newer client are dropped rather than crashing the server.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from repro_torch.scenarios.spec import ScenarioSpec


def spec_to_dict(spec: ScenarioSpec) -> dict:
    return dataclasses.asdict(spec)


def spec_from_dict(d: dict) -> ScenarioSpec:
    """Rebuild a spec from wire/snapshot metadata, dropping unknown keys."""
    known = {f.name for f in dataclasses.fields(ScenarioSpec)}
    return ScenarioSpec(**{k: v for k, v in d.items() if k in known})


def spec_key(spec: ScenarioSpec):
    """Identity of a spec's *simulation behaviour* (the name is a label)."""
    d = spec_to_dict(spec)
    d.pop("name")
    return tuple(sorted(d.items()))


class ErrorCode:
    """Typed failure classes a :class:`WhatIfResult` can carry. Everything
    the server sheds, drops or fails is counted per-code in ServiceMetrics —
    a failed batch is never invisible in the metrics dump."""
    INVALID = "INVALID"                        # rejected at submit time
    DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"    # shed before launch
    CANCELLED = "CANCELLED"                    # waiter gave up (wait timeout)
    SHED = "SHED"                              # bounded queue full
    BREAKER_OPEN = "BREAKER_OPEN"              # failing fast, program poisoned
    EXECUTOR_ERROR = "EXECUTOR_ERROR"          # launch failed after retries
    CHECKSUM_FAILURE = "CHECKSUM_FAILURE"      # corrupt stack chunk detected
    NO_RESULT = "NO_RESULT"                    # executor returned nothing


class ServingError(RuntimeError):
    """An executor failure carrying a typed :class:`ErrorCode` — the batcher
    boundary turns it into per-ticket error results counted under that code
    (anything else is EXECUTOR_ERROR)."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


@dataclass(frozen=True)
class WhatIfQuery:
    """One scenario question: simulate ``spec`` over ``n_windows`` windows
    starting at ``start_window`` (0, or a fork-point window — the spec must
    then match one of the fork snapshot's lanes).

    ``deadline_s`` bounds the query's total latency budget: a ticket still
    undispatched when it expires is shed with a typed DEADLINE_EXCEEDED
    result instead of burning a fleet lane on an answer nobody wants.
    ``priority > 0`` rides the priority lane — never load-shed by the
    batcher's bounded queue, and its bucket launches ahead of aged
    best-effort buckets. Neither affects the simulation, so they don't
    enter ``batch_key()``."""
    spec: ScenarioSpec
    n_windows: int
    start_window: int = 0
    seed: int = 0
    include_curves: bool = False
    deadline_s: Optional[float] = None
    priority: int = 0

    def __post_init__(self):
        if self.n_windows < 1:
            raise ValueError(f"n_windows={self.n_windows} must be >= 1")
        if self.start_window < 0:
            raise ValueError(f"start_window={self.start_window} must be >= 0")
        if self.priority < 0:
            raise ValueError(f"priority={self.priority} must be >= 0")

    def batch_key(self):
        """Queries sharing this key may ride one lane-batched launch: lanes
        are independent but the window stream and key schedule are shared,
        so start/length/seed must agree."""
        return (self.start_window, self.n_windows, self.seed)


@dataclass
class WhatIfResult:
    """What each caller gets back. ``row`` is the scenario_report row;
    ``frame`` the per-lane (rows, ...) stats arrays (in-process callers
    only — JSON encoding keeps the compact ``curves`` instead)."""
    name: str
    scheduler: str
    start_window: int
    n_windows: int
    row: Dict
    curves: Optional[Dict] = None
    frame: Optional[Dict[str, np.ndarray]] = None
    queue_s: float = 0.0
    exec_s: float = 0.0
    total_s: float = 0.0
    batch_lanes: int = 0          # live lanes in the launch that served this
    batch_size: int = 0           # compiled lane count (incl. padding)
    error: Optional[str] = None
    code: Optional[str] = None    # ErrorCode.* when error is set

    def ok(self) -> bool:
        return self.error is None


# --- JSON wire codecs --------------------------------------------------------

def encode_query(q: WhatIfQuery) -> str:
    return json.dumps({"spec": spec_to_dict(q.spec),
                       "n_windows": q.n_windows,
                       "start_window": q.start_window,
                       "seed": q.seed,
                       "include_curves": q.include_curves,
                       "deadline_s": q.deadline_s,
                       "priority": q.priority})


def decode_query(s: str) -> WhatIfQuery:
    d = json.loads(s)
    deadline = d.get("deadline_s")
    return WhatIfQuery(spec=spec_from_dict(d["spec"]),
                       n_windows=int(d["n_windows"]),
                       start_window=int(d.get("start_window", 0)),
                       seed=int(d.get("seed", 0)),
                       include_curves=bool(d.get("include_curves", False)),
                       deadline_s=None if deadline is None else
                       float(deadline),
                       priority=int(d.get("priority", 0)))


def encode_result(r: WhatIfResult) -> str:
    d = dataclasses.asdict(r)
    d.pop("frame")                 # raw frames never cross the wire
    return json.dumps(d)


def decode_result(s: str) -> WhatIfResult:
    d = json.loads(s)
    d["frame"] = None
    d.setdefault("code", None)     # results from pre-ErrorCode servers
    return WhatIfResult(**d)
