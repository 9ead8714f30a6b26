"""Declarative scenario DSL — low-code what-if configuration; a spec
compiles to one lane of the device-batched fleet.

A :class:`ScenarioSpec` is a frozen, hashable description of one divergent
world. :func:`expand_grid` does cartesian sweep expansion; :func:`build_knobs`
stacks a list of specs into :class:`ScenarioKnobs` — per-scenario (B,)
tensors, the lane axis of the batched engine (see batch.py).

The dataclass, its validation and the sweep helpers are the reference's
(tests hold the fields and defaults equal); scheduler names are checked
against the port's registry.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, fields, replace
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.sched import SCHEDULERS


@dataclass(frozen=True)
class ScenarioSpec:
    """One what-if world. All knobs default to the identity perturbation, so
    ``ScenarioSpec()`` replays the trace unchanged (the baseline lane).

    node_outage_frac    deterministic fraction of node slots that never come
                        up (their ADD/UPDATE_NODE events are masked dead)
    capacity_scale      multiply every node's declared capacity
    arrival_rate        < 1: thin ADD_TASK arrivals to this fraction;
                        > 1: inject round((rate-1) x arrivals) synthesised
                        SUBMITs per window into the reserved slot pool
                        (requires SimConfig.inject_slots > 0 — the fleet
                        refuses amplification without a pool)
    priority_surge_frac fraction of arriving tasks boosted to surge_priority
    surge_priority      the priority surged tasks get (GCD: 0..11)
    usage_scale         inflate reported task usage samples
    evict_storm_frac    per-window fraction of running tasks force-evicted
    scheduler           which scheduler this scenario runs
    """
    name: str = "baseline"
    scheduler: str = "greedy"
    node_outage_frac: float = 0.0
    capacity_scale: float = 1.0
    arrival_rate: float = 1.0
    priority_surge_frac: float = 0.0
    surge_priority: int = 11
    usage_scale: float = 1.0
    evict_storm_frac: float = 0.0

    def __post_init__(self):
        if self.scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {self.scheduler!r}; "
                             f"have {list(SCHEDULERS)}")
        for f in ("node_outage_frac", "priority_surge_frac",
                  "evict_storm_frac"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f}={v} outside [0, 1]")
        for f in ("capacity_scale", "arrival_rate", "usage_scale"):
            if getattr(self, f) <= 0.0:
                raise ValueError(f"{f} must be > 0")
        if not 0 <= self.surge_priority <= 11:
            raise ValueError("surge_priority outside GCD range 0..11")

    def is_identity(self) -> bool:
        """True iff this spec perturbs nothing (scheduler choice aside)."""
        base = ScenarioSpec(name=self.name, scheduler=self.scheduler)
        return self == base

    def describe(self) -> str:
        parts = [f"sched={self.scheduler}"]
        for f, label in _KNOB_LABELS.items():
            v = getattr(self, f)
            if v != getattr(_IDENTITY, f):
                parts.append(f"{label}={v:g}")
        return " ".join(parts)


_IDENTITY = ScenarioSpec()
_KNOB_LABELS = {
    "node_outage_frac": "outage",
    "capacity_scale": "cap",
    "arrival_rate": "rate",
    "priority_surge_frac": "surge",
    "surge_priority": "surge_prio",
    "usage_scale": "usage",
    "evict_storm_frac": "storm",
}
_FIELD_BY_LABEL = {v: k for k, v in _KNOB_LABELS.items()}
_FIELD_BY_LABEL["sched"] = "scheduler"
_FIELD_BY_LABEL["scheduler"] = "scheduler"


def expand_grid(base: Optional[ScenarioSpec] = None,
                **axes: Sequence) -> List[ScenarioSpec]:
    """Cartesian sweep over spec fields (by field name or short label).

    >>> expand_grid(scheduler=["greedy", "first_fit"],
    ...             node_outage_frac=[0.0, 0.2])   # 4 scenarios

    Names are auto-derived from the varying axes ("greedy/outage=0.2"); the
    all-identity corner keeps the base name so it reads as the baseline.
    """
    base = base or ScenarioSpec()
    keys = []
    for k in axes:
        field = _FIELD_BY_LABEL.get(k, k)
        if field not in {f.name for f in fields(ScenarioSpec)}:
            raise ValueError(f"unknown sweep axis {k!r}")
        keys.append(field)
    out: List[ScenarioSpec] = []
    for combo in itertools.product(*axes.values()):
        over = dict(zip(keys, combo))
        spec = replace(base, **over)
        label_bits = []
        for f, v in over.items():
            if f == "scheduler":
                label_bits.append(str(v))
            elif v != getattr(_IDENTITY, f):
                label_bits.append(f"{_KNOB_LABELS[f]}={v:g}")
        name = "/".join(label_bits) or base.name
        out.append(replace(spec, name=name))
    _check_unique([s.name for s in out])
    return out


def one_factor_sweep(base: Optional[ScenarioSpec] = None,
                     **axes: Sequence) -> List[ScenarioSpec]:
    """Baseline + one-factor-at-a-time variants (capacity-planning style)."""
    base = base or ScenarioSpec()
    out = [base]
    for k, values in axes.items():
        field = _FIELD_BY_LABEL.get(k, k)
        for v in values:
            if v == getattr(base, field):
                continue
            label = str(v) if field == "scheduler" else \
                f"{_KNOB_LABELS[field]}={v:g}"
            out.append(replace(base, name=label, **{field: v}))
    _check_unique([s.name for s in out])
    return out


def _check_unique(names: List[str]):
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(f"duplicate scenario names: {sorted(dupes)}")


class ScenarioKnobs(NamedTuple):
    """Per-scenario scalars, stacked to (B,) tensors — the lane axis."""
    sched_idx: torch.Tensor       # (B,) i32 index into the scheduler tuple
    outage_frac: torch.Tensor     # (B,) f32
    capacity_scale: torch.Tensor  # (B,) f32
    arrival_rate: torch.Tensor    # (B,) f32
    surge_frac: torch.Tensor      # (B,) f32
    surge_prio: torch.Tensor      # (B,) i32
    usage_scale: torch.Tensor     # (B,) f32
    storm_frac: torch.Tensor      # (B,) f32


def build_knobs(specs: Sequence[ScenarioSpec], device="cpu"
                ) -> Tuple[ScenarioKnobs, Tuple[str, ...]]:
    """Stack specs into knobs on ``device`` + the (static) scheduler
    dispatch table, deduplicated and order-preserving."""
    if not specs:
        raise ValueError("need at least one scenario")
    sched_names: List[str] = []
    for s in specs:
        if s.scheduler not in sched_names:
            sched_names.append(s.scheduler)
    return (_stack_knobs(specs, tuple(sched_names), device),
            tuple(sched_names))


def build_knobs_for_table(specs: Sequence[ScenarioSpec],
                          scheduler_names: Tuple[str, ...],
                          device="cpu") -> ScenarioKnobs:
    """Knobs whose ``sched_idx`` indexes a FIXED dispatch table.

    A server that keeps one fleet program per declared scheduler table
    maps every micro-batch into *that* table instead of deriving a
    per-batch one.
    """
    if not specs:
        raise ValueError("need at least one scenario")
    missing = sorted({s.scheduler for s in specs} - set(scheduler_names))
    if missing:
        raise ValueError(f"schedulers {missing} not in the serving table "
                         f"{list(scheduler_names)}")
    return _stack_knobs(specs, tuple(scheduler_names), device)


def _stack_knobs(specs: Sequence[ScenarioSpec],
                 sched_names: Tuple[str, ...], device) -> ScenarioKnobs:
    def col(values, dtype):
        return torch.tensor(values, dtype=dtype, device=device)

    f32, i32 = torch.float32, torch.int32
    return ScenarioKnobs(
        sched_idx=col([sched_names.index(s.scheduler) for s in specs], i32),
        outage_frac=col([s.node_outage_frac for s in specs], f32),
        capacity_scale=col([s.capacity_scale for s in specs], f32),
        arrival_rate=col([s.arrival_rate for s in specs], f32),
        surge_frac=col([s.priority_surge_frac for s in specs], f32),
        surge_prio=col([s.surge_priority for s in specs], i32),
        usage_scale=col([s.usage_scale for s in specs], f32),
        storm_frac=col([s.evict_storm_frac for s in specs], f32),
    )
