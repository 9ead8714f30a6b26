"""The windowed simulation engine — AGOCS's WorkloadGenerator in PyTorch.

Every 5 sim-seconds (one *window*) the collected events are applied to the
shared state and the scheduler under test reacts. ``run_windows`` loops
over a stack of windows, issuing the window's kernels one after another on
the current stream without a host sync (the reference scans them on the
device); the host pipeline (core/pipeline.py) streams stacked windows in.

Accounting (``node_reserved`` / ``node_used``) has two modes:

* **incremental** (``cfg.incremental_accounting``, the default): every pass
  that moves a task on or off a node applies the matching per-node delta;
  the full segment-sum recompute is a periodic *resync*
  (``cfg.resync_windows``, driven by core/pipeline.py);
* **full recompute** (``incremental_accounting=False``): three segment-sum
  recomputes per window.

Event-application order inside a window (at most one update per (slot,
field-group) per window, as the host pipeline guarantees):
  1. node add / update / attr / remove,
  2. task removals (EVICT/FAIL/FINISH/KILL/LOST),
  3. task adds + requirement/constraint updates,
  4. usage samples,
  5. node-removal evictions (running tasks on dead nodes -> back to pending),
  6. accounting (delta-maintained, or recomputed in full mode),
  7. scheduling (any ``repro_torch.sched`` registry scheduler),
  8. stats.

The task and node tables are updated in place; counters and the two
accounting tallies are replaced by new tensors.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.config import SimConfig
from repro_torch.core import stats as stats_mod
from repro_torch.core.events import (REMOVE_REASON_EVICT, EventKind,
                                     EventWindow)
from repro_torch.core.scatter import add_rows, set_rows_
from repro_torch.core.state import (SimState, TASK_EMPTY, TASK_PENDING,
                                    TASK_RUNNING)
from repro_torch.kernels.segment_usage.ops import segment_usage

Stats = Dict[str, torch.Tensor]


@functools.lru_cache(maxsize=None)
def _usage_cols(device: torch.device) -> torch.Tensor:
    return torch.tensor(stats_mod.ACCOUNTED_USAGE_COLS, device=device)


def accounted_usage(task_usage: torch.Tensor) -> torch.Tensor:
    """The usage columns aligned with the (cpu, memory, disk) resources."""
    return task_usage.index_select(-1, _usage_cols(task_usage.device))


def apply_node_events(state: SimState, w: EventWindow, cfg: SimConfig
                      ) -> SimState:
    # node events never move accounting: a capacity change or removal leaves
    # placed tasks' contributions in the tallies until evict_invalid reacts
    N, K = cfg.max_nodes, cfg.n_attr_slots
    kind, slot = w.kind, w.slot

    add = kind == EventKind.ADD_NODE
    upd = kind == EventKind.UPDATE_NODE_RESOURCES
    rem = kind == EventKind.REMOVE_NODE
    set_rows_(state.node_active, slot, add, True)
    set_rows_(state.node_total, slot, add | upd, w.a)

    aat = kind == EventKind.ADD_NODE_ATTR
    rat = kind == EventKind.REMOVE_NODE_ATTR
    # the 2-D (node, attr) scatter as a 1-D one over the flattened table
    in_range = (slot >= 0) & (slot < N) & (w.attr_idx >= 0) & (w.attr_idx < K)
    flat = slot.long() * K + w.attr_idx.long()
    set_rows_(state.node_attrs.view(-1), flat, (aat | rat) & in_range,
              torch.where(aat, w.attr_val, 0))

    set_rows_(state.node_active, slot, rem, False)
    return state


def apply_task_events(state: SimState, w: EventWindow, cfg: SimConfig
                      ) -> SimState:
    T = cfg.max_tasks
    kind, slot = w.kind, w.slot

    rem = kind == EventKind.REMOVE_TASK
    add = kind == EventKind.ADD_TASK
    upd = kind == EventKind.UPDATE_TASK_REQUIRED
    ucon = kind == EventKind.UPDATE_TASK_CONSTRAINTS
    use = kind == EventKind.UPDATE_TASK_USED

    # pre-mutation gathers (removal counters + incremental deltas); gathers
    # clamp the index as the reference's do
    at = slot.long().clamp(0, T - 1)
    old_state_at = state.task_state[at]
    live = old_state_at != TASK_EMPTY

    node_reserved, node_used = state.node_reserved, state.node_used
    if cfg.incremental_accounting:
        was_running = old_state_at == TASK_RUNNING
        ev_node = state.task_node[at]                          # (E,)
        old_req = state.task_req[at]                           # (E, R)
        old_used = accounted_usage(state.task_usage[at])       # (E, R)
        # lifecycle rows that end a RUNNING placement give back req + usage
        gone = (rem | add) & was_running
        node_reserved = add_rows(node_reserved, ev_node, gone, -old_req)
        node_used = add_rows(node_used, ev_node, gone, -old_used)
        # requirement updates on running tasks move the reservation
        moved = upd & was_running
        node_reserved = add_rows(node_reserved, ev_node, moved,
                                 w.a - old_req)

    # --- removals first (a slot can be freed and re-used next window) ---
    evicted = rem & live & (w.a[:, 0] == float(REMOVE_REASON_EVICT))
    n_evict = evicted.sum(dtype=torch.int32)
    n_rem = (rem & live).sum(dtype=torch.int32) - n_evict
    set_rows_(state.task_state, slot, rem, TASK_EMPTY)
    set_rows_(state.task_node, slot, rem, -1)

    # --- adds / updates ---
    set_rows_(state.task_state, slot, add, TASK_PENDING)
    set_rows_(state.task_node, slot, add, -1)
    set_rows_(state.task_req, slot, add | upd, w.a)
    set_rows_(state.task_prio, slot, add | upd, w.prio)
    set_rows_(state.task_job, slot, add, w.job)
    set_rows_(state.task_constraints, slot, add | ucon, w.constraints)

    # --- usage samples ---
    if cfg.incremental_accounting:
        # a sample moves node_used only if the task still runs after the
        # lifecycle rows above (its own REMOVE in this window wins)
        samp = use & (state.task_state[at] == TASK_RUNNING)
        node_used = add_rows(node_used, ev_node, samp,
                             accounted_usage(w.u) - old_used)
    set_rows_(state.task_usage, slot, use, w.u)

    return state._replace(
        node_reserved=node_reserved, node_used=node_used,
        completions=state.completions + n_rem,
        evictions=state.evictions + n_evict)


def evict_invalid(state: SimState, cfg: SimConfig) -> SimState:
    """Evict running tasks whose placement became invalid: the node went
    inactive, or a capacity UPDATE shrank it below its reservation.

    Evicted tasks go back to pending. Requires node_reserved to be current
    (incremental mode maintains it; full mode recomputes first). Under
    incremental accounting every running task on a dead/overcommitted node
    is evicted, so those node rows drop to exactly zero.
    """
    node_idx = state.task_node.clamp_min(0).long()
    dead = ~state.node_active[node_idx]
    over_nodes = (state.node_reserved > state.node_total + 1e-6).any(dim=1)
    bad = (state.task_state == TASK_RUNNING) & (dead | over_nodes[node_idx])
    n_evict = bad.sum(dtype=torch.int32)
    state.task_state.masked_fill_(bad, TASK_PENDING)
    state.task_node.masked_fill_(bad, -1)
    state = state._replace(evictions=state.evictions + n_evict)
    if cfg.incremental_accounting:
        bad_node = (~state.node_active | over_nodes)[:, None]
        state = state._replace(
            node_reserved=torch.where(bad_node, 0.0, state.node_reserved),
            node_used=torch.where(bad_node, 0.0, state.node_used))
    return state


def recompute_accounting(state: SimState, cfg: SimConfig) -> SimState:
    """node_reserved / node_used from the task table (segment-usage kernel):
    the inner loop in full-recompute mode, the periodic resync under
    incremental accounting."""
    running = state.task_state == TASK_RUNNING
    reserved = segment_usage(state.task_node, state.task_req, running,
                             cfg.max_nodes)
    used = segment_usage(state.task_node, accounted_usage(state.task_usage),
                         running, cfg.max_nodes)
    return state._replace(node_reserved=reserved, node_used=used)


def make_window_advance(cfg: SimConfig, scheduler_fn: Callable
                        ) -> Callable[[SimState, EventWindow, object],
                                      SimState]:
    """The stats-free single-window transition (state in, state out)."""

    def advance(state: SimState, w: EventWindow, rng=None) -> SimState:
        state = apply_node_events(state, w, cfg)
        state = apply_task_events(state, w, cfg)
        if not cfg.incremental_accounting:
            state = recompute_accounting(state, cfg)
        state = evict_invalid(state, cfg)
        if not cfg.incremental_accounting:
            state = recompute_accounting(state, cfg)
        state = scheduler_fn(state, cfg, rng)
        if not cfg.incremental_accounting:
            state = recompute_accounting(state, cfg)
        return state._replace(window=state.window + 1)

    return advance


def make_window_step(cfg: SimConfig, scheduler_fn: Callable
                     ) -> Callable[[SimState, EventWindow, object],
                                   Tuple[SimState, Stats]]:
    """The single-window transition plus its stats row."""
    advance = make_window_advance(cfg, scheduler_fn)

    def sim_window_step(state: SimState, w: EventWindow, rng=None):
        state = advance(state, w, rng)
        return state, stats_mod.window_stats(state, cfg)

    return sim_window_step


def window_at(windows: EventWindow, j: int) -> EventWindow:
    """Window ``j`` of a (W, ...) stack (views, no copy)."""
    return EventWindow(*[f[j] for f in windows])


def strided_chunks(windows: EventWindow, W: int, stride: int
                   ) -> Tuple[Optional[EventWindow], Optional[EventWindow]]:
    """Split a (W, ...) stack into ((M, k, ...) head, (r, ...) tail | None)
    with M = W // k full chunks: the chunking of the strided-stats loop."""
    M, r = divmod(W, stride)
    head = None
    if M:
        head = EventWindow(*[x[:M * stride].reshape((M, stride) + x.shape[1:])
                             for x in windows])
    tail = EventWindow(*[x[M * stride:] for x in windows]) if r else None
    return head, tail


def _stack_rows(rows: List[Stats]) -> Stats:
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def scan_strided(chunk: Callable, state, windows: EventWindow, W: int,
                 stride: int):
    """Run ``chunk`` (state, (k, ...) stack -> (state, row)) over the W
    windows in stride-sized chunks, the non-divisible tail as ONE final
    partial chunk, stacking the emitted rows. Requires W > 0."""
    assert W > 0, "scan_strided needs at least one window"
    head, tail = strided_chunks(windows, W, stride)
    rows = []
    if head is not None:
        for m in range(head.kind.shape[0]):
            state, row = chunk(state, window_at(head, m))
            rows.append(row)
    if tail is not None:
        state, row = chunk(state, tail)
        rows.append(row)
    return state, _stack_rows(rows)


def run_windows(state: SimState, windows: EventWindow, cfg: SimConfig,
                scheduler_fn: Callable, seed: int = 0
                ) -> Tuple[SimState, Stats]:
    """Advance over stacked windows (W leading dim on every field).

    Takes ownership of ``state`` (its tables are updated in place). With
    ``cfg.stats_stride == k > 1`` one stats row is emitted per k windows —
    row j is computed on the state after window (j+1)*k — and a
    non-divisible tail emits one final partial row, so the last row always
    reflects the final state. ``seed`` is kept for the RNG schedulers of a
    later slice; the deterministic schedulers ignore it.
    """
    advance = make_window_advance(cfg, scheduler_fn)
    W = windows.kind.shape[0]
    stride = cfg.stats_stride
    if W == 0:
        return state, {k: v[None][:0] for k, v in
                       stats_mod.window_stats(state, cfg).items()}

    def chunk(s, ws):
        for j in range(ws.kind.shape[0]):
            s = advance(s, window_at(ws, j), None)
        return s, stats_mod.window_stats(s, cfg)

    return scan_strided(chunk, state, windows, W, stride)
