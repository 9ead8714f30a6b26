"""Workload events — the paper's Fig. 1 event vocabulary as fixed-shape SoA
tensors.

Every state change in the simulation arrives as an immutable, timestamped
event (paper §III). On the host side events carry GCD ids; the pipeline
resolves ids to dense slots/indices before tensorisation, so the device only
ever sees int32 slots. A window = all events inside one 5-second collection
tick (the WorkloadGenerator cadence), padded to ``max_events_per_window``.

Timestamps: GCD uses int64 microseconds. We store (window:int32,
offset_us:int32) — lossless for a month-long trace (~520K windows, offsets
< 5e6 µs) and 32-bit-native on the device.
"""
from __future__ import annotations

import enum
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

import torch

from repro_torch.config import SimConfig


class EventKind(enum.IntEnum):
    """Paper §III event vocabulary (Fig. 1) + Table I task-action mapping."""
    PAD = 0
    ADD_TASK = 1                  # SUBMIT
    UPDATE_TASK_REQUIRED = 2      # UPDATE_PENDING / UPDATE_RUNNING
    UPDATE_TASK_USED = 3          # task_usage samples
    UPDATE_TASK_CONSTRAINTS = 4   # constraint changes (managed independently)
    REMOVE_TASK = 5               # EVICT / FAIL / FINISH / KILL / LOST
    ADD_NODE = 6
    UPDATE_NODE_RESOURCES = 7
    ADD_NODE_ATTR = 8
    REMOVE_NODE_ATTR = 9
    REMOVE_NODE = 10


# GCD task-event action codes (task_events table, column 5) -> EventKind
GCD_TASK_ACTION = {
    0: EventKind.ADD_TASK,          # SUBMIT
    1: None,                        # SCHEDULE (internal Google scheduler; ignored, Table I)
    2: EventKind.REMOVE_TASK,       # EVICT
    3: EventKind.REMOVE_TASK,       # FAIL
    4: EventKind.REMOVE_TASK,       # FINISH
    5: EventKind.REMOVE_TASK,       # KILL
    6: EventKind.REMOVE_TASK,       # LOST
    7: EventKind.UPDATE_TASK_REQUIRED,  # UPDATE_PENDING
    8: EventKind.UPDATE_TASK_REQUIRED,  # UPDATE_RUNNING
}

# GCD machine-event action codes
GCD_MACHINE_ADD, GCD_MACHINE_REMOVE, GCD_MACHINE_UPDATE = 0, 1, 2

# Constraint comparison ops (GCD task_constraints table)
OP_NONE, OP_EQ, OP_NE, OP_LT, OP_GT = 0, 1, 2, 3, 4

REMOVE_REASON_EVICT = 2   # kept in payload column 0 of `a` for REMOVE_TASK


class EventWindow(NamedTuple):
    """One collection window of events, padded to E rows (SoA)."""
    kind: np.ndarray          # (E,)   int8
    slot: np.ndarray          # (E,)   int32  task slot / node index
    a: np.ndarray             # (E,R)  float32 resource payload (req or total)
    u: np.ndarray             # (E,U)  float32 usage payload
    prio: np.ndarray          # (E,)   int32
    job: np.ndarray           # (E,)   int32
    constraints: np.ndarray   # (E,C,3) int32 (attr_idx, op, value)
    attr_idx: np.ndarray      # (E,)   int32
    attr_val: np.ndarray      # (E,)   int32
    t_off: np.ndarray         # (E,)   int32 µs offset inside the window
    n_valid: np.ndarray       # ()     int32


def empty_window(cfg: SimConfig) -> EventWindow:
    E, R, U, C = (cfg.max_events_per_window, cfg.n_resources,
                  cfg.n_usage_stats, cfg.max_constraints)
    return EventWindow(
        kind=np.zeros(E, np.int8),
        slot=np.zeros(E, np.int32),
        a=np.zeros((E, R), np.float32),
        u=np.zeros((E, U), np.float32),
        prio=np.zeros(E, np.int32),
        job=np.zeros(E, np.int32),
        constraints=np.zeros((E, C, 3), np.int32),
        attr_idx=np.zeros(E, np.int32),
        attr_val=np.zeros(E, np.int32),
        t_off=np.zeros(E, np.int32),
        n_valid=np.zeros((), np.int32),
    )


class HostEvent(NamedTuple):
    """Pre-tensorisation event (host side, after id->slot resolution)."""
    time_us: int
    kind: int
    slot: int
    a: Optional[Sequence[float]] = None
    u: Optional[Sequence[float]] = None
    prio: int = 0
    job: int = 0
    constraints: Optional[Sequence] = None   # [(attr_idx, op, value), ...]
    attr_idx: int = 0
    attr_val: int = 0


def dedup_events(events: List[HostEvent]) -> List[HostEvent]:
    """Linearise per-slot updates within one window (last-wins), so the
    device-side vectorised scatters are conflict-free and deterministic.

    This is the SoA equivalent of AGOCS's timestamp ordering through the
    TrieMap: within a 5-second collection window only the final value of each
    (slot, field-group) is observable anyway.

    Groups: task lifecycle+requirements (ADD/UPDATE_REQUIRED/REMOVE squash),
    task usage, task constraints, node lifecycle+resources, node attr per
    attr_idx. An ADD immediately followed by REMOVE inside one window cancels
    out (the task is never visible to the scheduler).
    """
    K = EventKind
    lifecycle = {K.ADD_TASK, K.UPDATE_TASK_REQUIRED, K.REMOVE_TASK}
    out: Dict[tuple, HostEvent] = {}
    task_added_here: Dict[int, bool] = {}
    for ev in sorted(events, key=lambda e: e.time_us):
        k = K(ev.kind)
        if k in lifecycle:
            key = ("task_life", ev.slot)
            if k == K.ADD_TASK:
                task_added_here[ev.slot] = True
                out[key] = ev
            elif k == K.UPDATE_TASK_REQUIRED:
                prev = out.get(key)
                if prev is not None and prev.kind == K.ADD_TASK:
                    # keep ADD identity, take the newest requirements
                    out[key] = prev._replace(a=ev.a, prio=ev.prio,
                                             time_us=prev.time_us)
                else:
                    out[key] = ev
            else:  # REMOVE
                if task_added_here.get(ev.slot):
                    out.pop(key, None)            # add+remove cancels
                    out.pop(("task_use", ev.slot), None)
                    out.pop(("task_cons", ev.slot), None)
                else:
                    out[key] = ev
        elif k == K.UPDATE_TASK_USED:
            out[("task_use", ev.slot)] = ev
        elif k == K.UPDATE_TASK_CONSTRAINTS:
            out[("task_cons", ev.slot)] = ev
        elif k in (K.ADD_NODE, K.UPDATE_NODE_RESOURCES, K.REMOVE_NODE):
            out[("node_life", ev.slot)] = ev
        elif k in (K.ADD_NODE_ATTR, K.REMOVE_NODE_ATTR):
            out[("node_attr", ev.slot, ev.attr_idx)] = ev
        else:
            out[("other", id(ev))] = ev
    return sorted(out.values(), key=lambda e: e.time_us)


def pack_window(cfg: SimConfig, events: List[HostEvent], window_idx: int
                ) -> EventWindow:
    """Tensorise one window worth of HostEvents (sorted by time).

    Overflow beyond the real-event budget raises — the pipeline splits
    windows instead (mirrors the paper's hard 1M-event buffer bound). When
    ``cfg.inject_slots > 0`` the last ``inject_slots`` rows are a reserved
    slot pool: they stay PAD here and are filled on-device by the scenario
    fleet's event synthesis (repro/scenarios/perturb.py), so every window
    ships with headroom for injected SUBMITs.
    """
    w = empty_window(cfg)
    E = cfg.events_per_window
    events = dedup_events(events)
    if len(events) > E:
        raise ValueError(f"window {window_idx}: {len(events)} events > {E} "
                         f"real-event rows ({cfg.inject_slots} reserved for "
                         "injection); increase max_events_per_window or "
                         "shrink window_us")
    base = window_idx * cfg.window_us
    events = sorted(events, key=lambda e: e.time_us)
    for i, ev in enumerate(events):
        w.kind[i] = ev.kind
        w.slot[i] = ev.slot
        if ev.a is not None:
            w.a[i, :len(ev.a)] = ev.a
        if ev.u is not None:
            w.u[i, :len(ev.u)] = ev.u
        w.prio[i] = ev.prio
        w.job[i] = ev.job
        if ev.constraints:
            for c, (ai, op, val) in enumerate(ev.constraints[:cfg.max_constraints]):
                w.constraints[i, c] = (ai, op, val)
        w.attr_idx[i] = ev.attr_idx
        w.attr_val[i] = ev.attr_val
        w.t_off[i] = ev.time_us - base
    w = w._replace(n_valid=np.asarray(len(events), np.int32))
    return w


def stack_windows(windows: Sequence[EventWindow]) -> EventWindow:
    """Stack windows into (W, ...) arrays for one device batch."""
    return EventWindow(*[np.stack([getattr(w, f) for w in windows])
                         for f in EventWindow._fields])


def window_to_torch(w: EventWindow, device) -> EventWindow:
    """A packed window (or a (W, ...) stack) as tensors on ``device``, every
    field keeping its numpy dtype (kind int8, the rest int32/float32)."""
    return EventWindow(*[torch.as_tensor(np.asarray(f)).to(device)
                         for f in w])
