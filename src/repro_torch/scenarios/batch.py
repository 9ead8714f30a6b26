"""Batched what-if engine: B scenarios advanced together, lane-batched.

The fleet state is a ``SimState`` with a leading lane axis B on every field
(``init_batched_state``); the engine passes of ``core/engine.py`` already
take that form, so one window costs one set of launches for all lanes,
where the reference vmaps a single-scenario step. Per window:

* the shared window passes through :func:`perturb.perturb_window`, which
  returns each lane's window;
* events are applied, invalid placements evicted, then
  :func:`perturb.storm_evict` and :func:`perturb.expire_injected` run
  (:func:`make_scenario_prelude`);
* the scheduling pass dispatches every lane at once, by one of two paths
  that give bitwise the same lanes:

  - **switchless** (``cfg.sched_dispatch`` 'auto' or 'table', every lane's
    scheduler with a table form, a static lane assignment): one base pass
    and ONE fused commit (kernel D, ``sched.table.make_switchless_dispatch``);
  - **switch fallback** (an opaque plugin in the mix, or 'switch'): one base
    pass, each lane's proposal on its own views, then one commit launch with
    a per-lane dynamic flag (kernel B in mode 'both').

With identity knobs and the same scheduler, lane 0 computes bit-identically
to ``engine.run_windows``. The mesh-sharded fleet of the reference
(``run_scenarios_sharded``) is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import SimConfig
from repro_torch.core import engine as eng
from repro_torch.core import stats as stats_mod
from repro_torch.core.events import EventKind, EventWindow
from repro_torch.core.state import SimState, init_state
from repro_torch.kernels.placement_commit.ops import lane_const
from repro_torch.scenarios import perturb
from repro_torch.scenarios.spec import ScenarioKnobs
from repro_torch.sched import (DispatchTable, base_pass, finalize,
                               make_switchless_dispatch, propose_lanes,
                               snapshot_dispatch)


def init_batched_state(cfg: SimConfig, n_scenarios: int, device
                       ) -> SimState:
    """A lane-batched SimState: ``n_scenarios`` identical empty worlds,
    each with its own storage (the engine updates tables in place)."""
    return SimState(*[x.unsqueeze(0).repeat((n_scenarios,) + (1,) * x.dim())
                      for x in init_state(cfg, device)])


def make_scenario_prelude(cfg: SimConfig, has_storm: bool = True):
    """The pre-dispatch transition of every lane: window perturbation,
    event application, eviction, storm, injection expiry. Returns
    ``prelude(state_B, w, knobs) -> (state_B, injected (B,) i32)`` for one
    shared window ``w`` (E, ...)."""

    def prelude(state: SimState, w: EventWindow, knobs: ScenarioKnobs
                ) -> Tuple[SimState, torch.Tensor]:
        w = perturb.perturb_window(w, knobs, cfg, window=state.window)
        if cfg.inject_slots:
            injected = (w.kind[:, -cfg.inject_slots:] == EventKind.ADD_TASK
                        ).sum(-1, dtype=torch.int32)
        else:
            injected = torch.zeros_like(state.window)
        state = eng.apply_node_events(state, w, cfg)
        state = eng.apply_task_events(state, w, cfg)
        if not cfg.incremental_accounting:
            state = eng.recompute_accounting(state, cfg)
        state = eng.evict_invalid(state, cfg)
        if has_storm:
            state = perturb.storm_evict(state, knobs, cfg)
        if cfg.inject_slots:
            state = perturb.expire_injected(state, knobs, cfg)
        if not cfg.incremental_accounting:
            state = eng.recompute_accounting(state, cfg)
        return state, injected

    return prelude


def make_switch_dispatch(cfg: SimConfig, table: DispatchTable,
                         lane_scheds: Tuple[int, ...]):
    """The fallback scheduling pass: one base pass for all lanes, lane b's
    proposal ``table.proposers[lane_scheds[b]]`` on its own views, then one
    commit with a per-lane dynamic flag (the static flag when the table has
    one scheduler). Returns ``dispatch(state_B, rng=None) -> state_B``."""
    proposers = [table.proposers[s] for s in lane_scheds]
    flags = tuple(int(table.dynamic[s]) for s in lane_scheds)

    def dispatch(state: SimState, rng=None) -> SimState:
        idx, valid, base_ok, scores = base_pass(state, cfg)
        pref = propose_lanes(proposers, state, cfg, rng, idx, valid, base_ok,
                             scores)
        if len(table.names) == 1:
            dyn = bool(table.dynamic[0])
        else:
            dyn = lane_const(flags, state.window.device) != 0
        return finalize(state, cfg, idx, valid, base_ok, pref,
                        dynamic_bestfit=dyn)

    return dispatch


def _want_switchless(cfg: SimConfig, table: DispatchTable,
                     lane_scheds) -> bool:
    """Resolve ``cfg.sched_dispatch`` against what this call can do:
    switchless needs the static per-lane assignment and a table form for
    every scheduler; 'auto' falls back to the switch path without them,
    'table' raises."""
    able = lane_scheds is not None and table.switchless
    if cfg.sched_dispatch == "switch":
        return False
    if cfg.sched_dispatch == "table" and not able:
        opaque = [n for n, f in zip(table.names, table.forms) if f is None]
        if opaque:
            raise ValueError(
                f"cfg.sched_dispatch='table' but schedulers {opaque} have "
                "no table form — register_scheduler(..., table_form=...) "
                "them or drop to 'auto'/'switch'")
        raise ValueError(
            "cfg.sched_dispatch='table' but no static lane assignment was "
            "provided — pass lane_scheds, or use 'auto' or 'switch'")
    return able


def make_scenario_advance(cfg: SimConfig, scheduler_names: Tuple[str, ...],
                          has_storm: bool = True,
                          table: Optional[DispatchTable] = None,
                          lane_scheds: Tuple[int, ...] = (),
                          switchless: bool = False):
    """The stats-free transition of every lane:
    ``advance(state_B, w, knobs, rng) -> (state_B, injected (B,) i32)``,
    ``rng`` the window's scheduler key, shared by every lane; the
    per-window injected count rides along so strided stats rows can sum
    it. ``lane_scheds`` is the static per-lane scheduler index into
    ``scheduler_names``; ``switchless`` picks the fused dispatch."""
    if table is None:
        table = snapshot_dispatch(scheduler_names)
    prelude = make_scenario_prelude(cfg, has_storm)
    make = make_switchless_dispatch if switchless else make_switch_dispatch
    dispatch = make(cfg, table, tuple(lane_scheds))

    def advance(state: SimState, w: EventWindow, knobs: ScenarioKnobs,
                rng=None) -> Tuple[SimState, torch.Tensor]:
        state, injected = prelude(state, w, knobs)
        state = dispatch(state, rng)
        if not cfg.incremental_accounting:
            state = eng.recompute_accounting(state, cfg)
        return state._replace(window=state.window + 1), injected

    return advance


def run_scenarios(state: SimState, windows: EventWindow, knobs: ScenarioKnobs,
                  cfg: SimConfig, scheduler_names: Tuple[str, ...],
                  seed: int = 0, has_storm: bool = True,
                  table: Optional[DispatchTable] = None,
                  lane_scheds: Optional[Tuple[int, ...]] = None
                  ) -> Tuple[SimState, Dict[str, torch.Tensor]]:
    """Advance the fleet over stacked windows.

    state: lane-batched SimState (updated in place, like ``run_windows``);
    windows: (W, ...) stacked EventWindow shared by every lane; knobs: (B,)
    ScenarioKnobs. Returns the advanced state and a stats dict of (W, B,
    ...) tensors, ``injected_arrivals`` included. ``has_storm=False`` drops
    the eviction-storm pass (valid only when every lane's storm_frac is 0).

    Dispatch: with ``lane_scheds`` (the fleet's static per-lane scheduler
    indices, which must agree with ``knobs.sched_idx``) and a fully
    table-formed snapshot, the switchless path; otherwise the switch
    fallback (which reads ``knobs.sched_idx`` once when ``lane_scheds`` is
    not given). The window keys are ``engine.window_keys(seed, W)``, as in
    ``engine.run_windows``, and every lane of a window gets its row (common
    random numbers, the reference's rule for paired what-if comparisons).

    With ``cfg.stats_stride == k > 1`` one (B, ...) row is emitted per k
    windows, the tail as one final partial row, ``injected_arrivals``
    summed over each chunk — the cadence of ``engine.run_windows``.
    """
    if table is None:
        table = snapshot_dispatch(scheduler_names)
    switchless = _want_switchless(cfg, table, lane_scheds)
    if lane_scheds is None:
        lane_scheds = tuple(knobs.sched_idx.tolist())
    advance = make_scenario_advance(cfg, scheduler_names, has_storm, table,
                                    lane_scheds, switchless)

    def rows_for(s, injected):
        rows = stats_mod.window_stats(s, cfg)
        rows["injected_arrivals"] = injected
        return rows

    W = windows.kind.shape[0]
    if W == 0:
        return state, {k: v[None][:0] for k, v in
                       rows_for(state, torch.zeros_like(state.window)).items()}
    keys = iter(eng.window_keys(seed, W, state.window.device))

    def chunk(s, ws):
        acc = torch.zeros_like(s.window)
        for j in range(ws.kind.shape[0]):
            s, injected = advance(s, eng.window_at(ws, j), knobs, next(keys))
            acc = acc + injected
        return s, rows_for(s, acc)

    return eng.scan_strided(chunk, state, windows, W, cfg.stats_stride)


def resync_fleet(state: SimState, cfg: SimConfig) -> SimState:
    """Per-lane full recompute of both accounting tallies — the fleet
    driver's periodic drift resync under incremental accounting (kernel E,
    one launch per tally for all lanes, every ``resync_windows``
    windows)."""
    return eng.recompute_accounting(state, cfg)
